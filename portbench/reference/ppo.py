"""DPPO's update in plain PyTorch: GAE, shuffled minibatches of the clipped
surrogate, the clip and Adam.

A frozen copy of what ``pfpn_torch/algos/ppo.py`` (``PPO.update``,
``_loss``, ``_objective``, ``_surrogate``, ``clip_by_global_norm_``) does
for DPPO-PFPN, feed-forward and without value normalization: GAE with 0
bootstrapped on true terminals and V(next pre-reset observation)
elsewhere (``a2c.gae``); then for each epoch a permutation of the round's
samples, and for each minibatch of it the advantage normalized over the
minibatch (mean, population std + 1e-8) when configured, the loss
-mean(min(r A, clip(r, 1 - eps, 1 + eps) A)) - beta mean(entropy) + c
mean((V - (V_old + A_raw))^2) with r = exp(log_prob - log_prob_old), the
gradients scaled to the global norm ``norm_clip`` when at or over it, Adam
(b1 0.9, b2 0.999, eps 1e-8) over one group, and in the first epoch the
observation normalizer's moving average over the minibatch's observations
at the new optimizer step. The old log-probs and values are this network's
at the round's start, as the rollout's are the port's.

The permutations are inputs: the port draws them from its run's generator,
and the harness hands the same to both sides. PFPN resampling is not part
of this copy: the harness refuses to follow a round in which the port
resampled.

Besides following a run from its first weights (:meth:`PPOReference.update`),
one step can start from a given state (:meth:`PPOReference.load`): the
network's parameters and normalizer, Adam's moments and step count. A trail
(:func:`snapshot` before each step and after each round) records either
side's states in one form.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from .a2c import gae
from .policy import ActorCritic


@dataclasses.dataclass(frozen=True)
class PPOSettings:
    gamma: float = 0.95
    lambd: float = 0.95
    value_loss_coef: float = 0.5
    entropy_beta: Optional[float] = None
    epsilon: float = 0.2
    lr: float = 1e-4
    norm_clip: Optional[float] = 1.0
    minibatch_size: int = 256
    normalize_advantage: bool = True


def snapshot(net: torch.nn.Module, adam: torch.optim.Adam) -> Dict:
    """Host copies of ``net``'s state dict (parameters and buffers) and of
    Adam's moments by parameter name (absent before a parameter's first
    step)."""
    names = {p: n for n, p in net.named_parameters()}
    moments = {names[p]: (s["exp_avg"].detach().to("cpu", copy=True),
                          s["exp_avg_sq"].detach().to("cpu", copy=True))
               for p, s in adam.state.items() if "exp_avg" in s}
    return {"state": {k: v.detach().to("cpu", copy=True) for k, v in net.state_dict().items()},
            "adam": moments}


class PPOReference:
    """One network, its Adam state and the optimizer-step count; with
    ``keep_after``, a copy of the parameters after that step (``kept``);
    ``trail`` lists, per round, a :func:`snapshot` before each step (with
    its loss, sample count and clipped gradient) and one after the
    round."""

    def __init__(self, net: ActorCritic, cfg: PPOSettings = PPOSettings(),
                 keep_after: Optional[int] = None):
        self.net, self.cfg = net, cfg
        self.params: List[torch.nn.Parameter] = list(net.parameters())
        self.adam = torch.optim.Adam(self.params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        self.global_step = 0
        self.keep_after = keep_after
        self.kept: Optional[Dict[str, torch.Tensor]] = None
        self.trail: List[Dict] = []

    def load(self, snap: Dict, global_step: int) -> None:
        """Start from ``snap`` (a :func:`snapshot`) after ``global_step``
        optimizer steps."""
        device = self.params[0].device
        self.net.load_state_dict({k: v.to(device) for k, v in snap["state"].items()})
        self.adam.state.clear()
        for n, p in self.net.named_parameters():
            m, v = snap["adam"].get(n, (torch.zeros_like(p), torch.zeros_like(p)))
            self.adam.state[p] = {"step": torch.tensor(float(global_step)),
                                  "exp_avg": m.to(device, copy=True),
                                  "exp_avg_sq": v.to(device, copy=True)}
        self.global_step = global_step

    def loss(self, obs, action, log_prob_old, v_old, adv_raw) -> torch.Tensor:
        cfg, net = self.cfg, self.net
        lp = net.log_prob(obs, action)
        v = net.value(obs)
        adv = adv_raw
        if cfg.normalize_advantage:
            adv = (adv - torch.mean(adv)) / (torch.std(adv, correction=0) + 1e-8)
        ratio = torch.exp(lp - log_prob_old)
        clipped = torch.clamp(ratio, 1.0 - cfg.epsilon, 1.0 + cfg.epsilon) * adv
        policy_loss = -torch.mean(torch.minimum(ratio * adv, clipped))
        if cfg.entropy_beta:
            policy_loss = policy_loss - cfg.entropy_beta * torch.mean(net.entropy(obs))
        value_loss = torch.mean((v - (v_old + adv_raw)) ** 2)
        return policy_loss + cfg.value_loss_coef * value_loss

    def _clip(self) -> None:
        with torch.no_grad():
            grads = [p.grad for p in self.params]
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            if self.cfg.norm_clip and not bool(norm < self.cfg.norm_clip):
                for g in grads:
                    g.copy_(g / norm * self.cfg.norm_clip)

    def prepare(self, traj: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A round's samples, flat, with the old log-probs and values and
        GAE's advantages by the network as it stands."""
        net, cfg = self.net, self.cfg
        flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
        obs, action = flat(traj["obs"]), flat(traj["action"])
        with torch.no_grad():
            v = net.value(traj["obs"])
            v_next = net.value(traj["next_obs"])
            lp_old = net.log_prob(obs, action)
        adv = flat(gae(traj["reward"], v, v_next, traj["terminated"], traj["done"],
                       cfg.gamma, cfg.lambd))
        return {"obs": obs, "action": action, "log_prob": lp_old, "value": flat(v),
                "advantage": adv}

    def step(self, data: Dict[str, torch.Tensor], idx: torch.Tensor, first_epoch: bool,
             rows: Optional[int] = None):
        """One minibatch ``idx`` of ``data``: the loss, its gradient, the
        clip, Adam, and in the first epoch the normalizer. Returns (the loss,
        the clipped gradients by parameter name). ``rows`` keeps the
        minibatch's first rows only in its loss (a planted fault)."""
        idx = idx.to(data["obs"].device)
        part = idx if rows is None else idx[:rows]
        self.adam.zero_grad(set_to_none=True)
        loss = self.loss(data["obs"][part], data["action"][part], data["log_prob"][part],
                         data["value"][part], data["advantage"][part])
        loss.backward()
        self._clip()
        grads = {n: p.grad.clone() for n, p in self.net.named_parameters()}
        self.adam.step()
        self.global_step += 1
        if self.global_step == self.keep_after:
            self.kept = {n: p.detach().clone() for n, p in self.net.named_parameters()}
        if first_epoch:
            self.net.norm.update_moving_average(data["obs"][idx], self.global_step)
        return float(loss.detach()), grads

    def update(self, traj: Dict[str, torch.Tensor], perms: Sequence[torch.Tensor],
               rows: Optional[int] = None, minibatches: Optional[int] = None):
        """One round: an epoch per permutation in ``perms``, each of its
        whole minibatches (or of the first ``minibatches``: a planted fault).
        Returns (each minibatch's loss, the first minibatch's clipped
        gradients as Adam takes them, by parameter name), and adds the
        round to ``trail``."""
        data = self.prepare(traj)
        mb = self.cfg.minibatch_size
        losses, first = [], None
        steps = []
        for epoch, perm in enumerate(perms):
            count = perm.shape[0] // mb if minibatches is None else minibatches
            for i in range(count):
                snap = snapshot(self.net, self.adam)
                loss, grads = self.step(data, perm[i * mb:(i + 1) * mb], epoch == 0, rows)
                steps.append(dict(snap, loss=loss, samples=mb if rows is None else rows,
                                  grad={n: g.to("cpu", copy=True) for n, g in grads.items()}))
                if first is None:
                    first = grads
                losses.append(loss)
        self.trail.append({"steps": steps, "end": snapshot(self.net, self.adam)})
        return losses, first
