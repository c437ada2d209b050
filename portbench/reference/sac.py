"""SAC-PFPN's gradient step in plain PyTorch: twin critics, Polyak targets,
a learned temperature, three clipped Adam groups.

A frozen copy of what ``pfpn_torch/algos/sac.py`` (``SAC._critic_loss``,
``_actor_loss``, ``_update_step``, ``make_optimizer``, ``make_target``) does
for SAC with the tanh-squashed particle head, after Haarnoja et al.'s SAC
(arXiv:1812.05905) as the PFPN reference presets it
(https://github.com/xupei0610/PFPN, ``settings/deepmimic_sac_pfpn.py`` on
``deepmimic_sac_base.py``):

* the actor: the clipped state normalizer, a relu6 MLP (relu6 after every
  layer) and a particle head of N particles per action dimension, drawn by
  reparameterization (``particle.rsample_squashed_from``: a hard
  Gumbel-max pick with a straight-through relaxed one-hot, the picked
  particle's loc + scale eps, its tanh), the action on the env's bounds
  a_t (high - low) / 2 + (high + low) / 2; its log-density is the mixture's
  at the pre-tanh value less the tanh Jacobian;
* the critics: two relu6 MLPs [obs + act, *critic_shape, 1] on
  [normalized, clipped state ‖ action on the env's bounds];
* the critic loss mean((y - Q1)^2 + (y - Q2)^2), y = r + gamma
  not_terminal (min(Q1', Q2')(s', a') - alpha log pi(a'|s')) with a' drawn
  at s' and Q' the target critics, under no gradient;
* the actor loss mean(alpha log pi(a|s) - min(Q1, Q2)(s, a)) with a drawn
  at s, alpha = exp(log_alpha) held fixed and the critics' weights held
  fixed (the gradient reaches the actor through Q's input only), plus the
  temperature loss -mean(log_alpha (log pi + target_entropy)) with the
  log-probs held fixed; target_entropy = -action_dim;
* one backward of their sum; each of three groups (the actor and
  normalizer's trunk and head, the critics ``q1`` and ``q2``, and
  ``log_alpha``) scaled to the global norm ``norm_clip`` when at or over
  it; Adam (b1 0.9, b2 0.999, eps 1e-8) with each group's learning rate,
  on the card with its step counts and bias corrections there (``capturable``);
* after Adam: each target critic t <- (1 - tau) t + tau q, then the
  observation normalizer's moving average over the batch's observations
  at the new step count.

Departures from the published description, as the port has them and so
this copy: the losses of the critics, the actor and the temperature are
summed and take one backward (the published code makes three optimizer
calls; the gradients are the same because each loss reaches only its own
group); the temperature loss uses log_alpha rather than alpha; every
gradient is clipped by its group's global norm; the observation
normalizer's moving average (decay min(0.9999, (1 + s) / (10 + s))) is
updated after every gradient step from the batch; a parameter no loss
reaches still takes an Adam step with a zero gradient. PFPN's particle
resampling (every ``resample_interval`` gradient steps) is not part of
this copy: the harness refuses to follow a step after the port resampled.

Besides the step itself (:meth:`SACReference.step`), a state can be loaded
(:meth:`SACReference.load`: the network's parameters and normalizer, the
targets, Adam's moments and step count) and recorded in one form for both
sides (:func:`snapshot`). Faults for the benchmark's own checks can be
planted in a step (``FAULTS``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from . import particle as pfp
from .policy import MLP, Normalizer, ParticleHead

GROUPS = ("actor", "critic", "alpha")
# faults the benchmark plants in a step, each a departure the check must see
FAULTS = ("targets_frozen", "temperature_frozen", "target_q1_only", "one_clip")


@dataclasses.dataclass(frozen=True)
class SACSettings:
    gamma: float = 0.95
    tau: float = 0.005
    lr_actor: float = 1e-4
    lr_critic: float = 1e-4
    lr_alpha: float = 1e-4
    norm_clip: Optional[float] = 1.0


def group_of(name: str) -> str:
    """The Adam group of a parameter, by its top-level name."""
    top = name.split(".")[0]
    return "critic" if top in ("q1", "q2") else "alpha" if top == "log_alpha" else "actor"


def _q_fixed(q: MLP, x: torch.Tensor) -> torch.Tensor:
    """``q`` on ``x`` with its weights held out of the gradient."""
    for i, layer in enumerate(q.layers):
        x = F.linear(x, layer.weight.detach(), layer.bias.detach())
        if i + 1 < len(q.layers):
            x = F.relu6(x)
    return x


class SACNet(nn.Module):
    """normalizer -> actor MLP -> squashed particle head on the env's
    bounds; twin critics ``q1``, ``q2``; the temperature ``log_alpha``.
    Parameter names are the port's ``SACNet``'s."""

    def __init__(self, obs_dim: int, action_dim: int, particles: int,
                 actor_shape: Sequence[int], critic_shape: Sequence[int],
                 action_low: np.ndarray, action_high: np.ndarray, clip_state: float = 5.0):
        super().__init__()
        self.clip_state, self.action_dim = clip_state, action_dim
        self.norm = Normalizer(obs_dim)
        self.actor_trunk = MLP([obs_dim, *actor_shape], last_relu6=True)
        self.head = ParticleHead(actor_shape[-1], action_dim, particles)
        sizes = [obs_dim + action_dim, *critic_shape, 1]
        self.q1, self.q2 = MLP(sizes), MLP(sizes)
        self.log_alpha = nn.Parameter(torch.zeros(()))
        low, high = np.asarray(action_low, np.float32), np.asarray(action_high, np.float32)
        self.register_buffer("_scale", torch.from_numpy(np.float32(0.5) * (high - low)),
                             persistent=False)
        self.register_buffer("_offset", torch.from_numpy(np.float32(0.5) * (high + low)),
                             persistent=False)

    def normalized(self, obs: torch.Tensor) -> torch.Tensor:
        return self.norm(obs, self.clip_state)

    def on_bounds(self, a_t: torch.Tensor) -> torch.Tensor:
        """An action in (-1, 1) on the env's bounds."""
        return a_t * self._scale + self._offset

    def q(self, which: MLP, obs: torch.Tensor, action: torch.Tensor,
          fixed: bool = False) -> torch.Tensor:
        x = torch.cat([self.normalized(obs), action], -1)
        return (_q_fixed(which, x) if fixed else which(x))[..., 0]

    def sample(self, obs: torch.Tensor, gumbel: torch.Tensor, eps: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(action on the bounds, its log-density, its pre-tanh value) of
        the reparameterized draw with noise ``gumbel`` and ``eps``."""
        logits, loc, scale = self.head.dist(self.actor_trunk(self.normalized(obs)))
        a_t, pre = pfp.rsample_squashed_from(logits, loc, scale, gumbel, eps)
        lp = pfp.log_prob(logits, loc, scale, a_t, squash=True, pre_tanh=pre)
        return self.on_bounds(a_t), lp, pre

    def log_prob(self, obs: torch.Tensor, pre_tanh: torch.Tensor) -> torch.Tensor:
        """The squashed head's log-density of the action whose pre-tanh
        value is ``pre_tanh``."""
        logits, loc, scale = self.head.dist(self.actor_trunk(self.normalized(obs)))
        return pfp.log_prob(logits, loc, scale, torch.tanh(pre_tanh), squash=True,
                            pre_tanh=pre_tanh)

    def value(self, obs: torch.Tensor) -> torch.Tensor:
        """min(Q1, Q2) at the middle of the env's bounds: a number of the
        observation alone, of the critics alone (an action of the actor would
        carry its round-off through the critics' slope into the number)."""
        a = self.on_bounds(torch.zeros(obs.shape[:-1] + (self.action_dim,), device=obs.device))
        return torch.minimum(self.q(self.q1, obs, a), self.q(self.q2, obs, a))


def snapshot(net: SACNet, target: nn.Module, adam: Optional[torch.optim.Adam],
             device="cpu") -> Dict:
    """Copies, on ``device``, of ``net``'s state dict (parameters and
    normalizer), the targets' and Adam's moments by parameter name (absent
    before a parameter's first step)."""
    out = {"state": {k: v.detach().to(device, copy=True) for k, v in net.state_dict().items()},
           "target": {k: v.detach().to(device, copy=True)
                      for k, v in target.state_dict().items()}}
    if adam is not None:
        names = {p: n for n, p in net.named_parameters()}
        out["adam"] = {names[p]: (s["exp_avg"].detach().to(device, copy=True),
                                  s["exp_avg_sq"].detach().to(device, copy=True))
                       for p, s in adam.state.items() if "exp_avg" in s}
    return out


class SACReference:
    """One network, its targets (the critics' copies), its Adam state in
    three groups and the gradient-step count."""

    def __init__(self, net: SACNet, cfg: SACSettings = SACSettings()):
        self.net, self.cfg = net, cfg
        self.target = nn.ModuleDict({"q1": copy.deepcopy(net.q1), "q2": copy.deepcopy(net.q2)})
        self.target.requires_grad_(False)
        self.groups: Dict[str, list] = {g: [] for g in GROUPS}
        for n, p in net.named_parameters():
            self.groups[group_of(n)].append(p)
        lrs = {"actor": cfg.lr_actor, "critic": cfg.lr_critic, "alpha": cfg.lr_alpha}
        # on the card Adam keeps its step counts there and computes its bias
        # corrections there, in float32, as the port's does
        self.capturable = net.log_alpha.is_cuda
        self.adam = torch.optim.Adam([{"params": self.groups[g], "lr": lrs[g]} for g in GROUPS],
                                     betas=(0.9, 0.999), eps=1e-8, capturable=self.capturable)
        self.global_step = 0

    def load(self, snap: Dict, global_step: int) -> None:
        """Start from ``snap`` (a :func:`snapshot`) after ``global_step``
        gradient steps."""
        device = self.net.log_alpha.device
        self.net.load_state_dict({k: v.to(device) for k, v in snap["state"].items()})
        self.target.load_state_dict({k: v.to(device) for k, v in snap["target"].items()})
        self.adam.state.clear()
        for n, p in self.net.named_parameters():
            m, v = snap.get("adam", {}).get(n, (torch.zeros_like(p), torch.zeros_like(p)))
            self.adam.state[p] = {"step": torch.tensor(float(global_step),
                                                       device=device if self.capturable else None),
                                  "exp_avg": m.to(device, copy=True),
                                  "exp_avg_sq": v.to(device, copy=True)}
        self.global_step = global_step

    def losses(self, batch: Dict[str, torch.Tensor], draws: Dict,
               q1_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """(critic loss, actor + temperature loss) on ``batch`` with the
        draws of the next action (``draws["critic"]``) and of the action
        (``draws["actor"]``); ``q1_only`` takes the target from Q1' alone (a
        planted fault)."""
        net, cfg, tgt = self.net, self.cfg, self.target
        nxt = batch["next_obs"]
        with torch.no_grad():
            a2, lp2, _ = net.sample(nxt, draws["critic"]["gumbel"], draws["critic"]["eps"])
            q_next = net.q(tgt["q1"], nxt, a2)
            if not q1_only:
                q_next = torch.minimum(q_next, net.q(tgt["q2"], nxt, a2))
            v_next = q_next - torch.exp(net.log_alpha) * lp2
            y = batch["reward"] + cfg.gamma * batch["not_terminal"] * v_next
        q1 = net.q(net.q1, batch["obs"], batch["action"])
        q2 = net.q(net.q2, batch["obs"], batch["action"])
        closs = torch.mean((y - q1) ** 2 + (y - q2) ** 2)

        obs = batch["obs"]
        a, lp, _ = net.sample(obs, draws["actor"]["gumbel"], draws["actor"]["eps"])
        q = torch.minimum(net.q(net.q1, obs, a, fixed=True), net.q(net.q2, obs, a, fixed=True))
        alpha = torch.exp(net.log_alpha).detach()
        target_entropy = -float(net.action_dim)
        aloss = (torch.mean(alpha * lp - q)
                 - torch.mean(net.log_alpha * (lp + target_entropy).detach()))
        return closs, aloss

    def _clip(self, groups) -> None:
        if not self.cfg.norm_clip:
            return
        with torch.no_grad():
            for params in groups:
                grads = [p.grad for p in params]
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                if not bool(norm < self.cfg.norm_clip):
                    for g in grads:
                        g.copy_(g / norm * self.cfg.norm_clip)

    def step(self, batch: Dict[str, torch.Tensor], draws: Dict,
             fault: Optional[str] = None) -> Dict:
        """One gradient step. Returns the critic, actor and total losses
        (``critic_loss``, ``actor_loss``, ``loss``) and the clipped
        gradients as Adam takes them, by parameter name (``grad``).
        ``fault`` plants one of ``FAULTS``."""
        net = self.net
        self.adam.zero_grad(set_to_none=True)
        closs, aloss = self.losses(batch, draws, q1_only=fault == "target_q1_only")
        loss = closs + aloss
        loss.backward()
        for params in self.groups.values():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        if fault == "temperature_frozen":
            net.log_alpha.grad.zero_()
        self._clip([sum(self.groups.values(), [])] if fault == "one_clip"
                   else list(self.groups.values()))
        grads = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
        alpha_before = net.log_alpha.detach().clone()
        self.adam.step()
        self.global_step += 1
        with torch.no_grad():
            if fault == "temperature_frozen":
                net.log_alpha.copy_(alpha_before)
            if fault != "targets_frozen":
                for k in ("q1", "q2"):
                    for t, p in zip(self.target[k].parameters(), getattr(net, k).parameters()):
                        t.mul_(1.0 - self.cfg.tau).add_(p, alpha=self.cfg.tau)
        net.norm.update_moving_average(batch["obs"], self.global_step)
        return {"critic_loss": float(closs.detach()), "actor_loss": float(aloss.detach()),
                "loss": float(loss.detach()), "grad": grads}
