"""Clip-PPO (DPPO): rollout, update, training round and evaluation.

Counterpart of ``pfpn_tpu/algos/ppo.py`` (``:47-332``). The JAX package
fuses a round into one jitted program; here it runs eagerly: a Python loop
of ``unroll_length`` env steps on the batch of ``num_envs`` envs (the
physics is the CUDA megastep on the card), then GAE and the minibatch
updates. Parameters and the observation normalizer live in the
:class:`~pfpn_torch.networks.actor_critic.ActorCritic` module and are
updated in place; one ``torch.Generator`` carried in :class:`PPOState`
takes the place of ``PPOState.key``.

Semantics, as in the JAX package:

* rollout stores the *unclipped* sampled action and its log-prob; the env
  receives the action clipped to its bounds, or as it is when the env has
  none (the discrete wrapper: the categorical head's integer actions keep
  their type through the trajectory and the loss);
* GAE bootstraps 0 on true terminals and V(next pre-reset state) on
  truncation and unroll boundaries;
* advantages are normalized per minibatch when configured; the value
  target is old value + raw advantage;
* clip by the global norm, then Adam (b1 0.9, b2 0.999, eps 1e-8 outside
  the square root); one group over all parameters when the actor and
  critic learning rates agree, a group each otherwise (``ppo.py:88-100``);
* observation-normalizer updates use the first epoch's minibatches only,
  with the (1 + s) / (10 + s) decay at the new optimizer step;
* with ``normalize_value``, the critic regresses its scale-and-offset
  output against the normalized target, and the value normalizer
  (``networks/value_norm.py``, carried in ``PPOState.vnorm``) moves after
  every minibatch of every epoch; the rollout's values and bootstraps are
  denormalized through it;
* with the particle head, its activation accumulators update on every
  sampling forward pass and resampling runs on the optimizer-step counter;
  the Gaussian and categorical heads carry no statistics.

Counters (``global_step``, ``total_samples``) are Python ints.

Data parallel (:meth:`PPO.shard`, ``distributed/mesh.py``): each rank steps
its slice of the envs and the policy acts on the all-gathered batch, so the
trajectory is global on every rank; each minibatch is split by rank, each
rank's loss is its rows' share of the global mean (the advantage still
normalized over the whole minibatch), and the optimizer sums the gradients
over the ranks before the clip.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..distributed import mesh as mesh_mod
from ..networks import value_norm as vnorm_mod
from ..networks.actor_critic import ActorCritic
from ..networks.heads import update_activation_stats
from ..networks.resample import maybe_resample
from ..sim.dynamics import const
from .gae import gae

TRAJ_KEYS = ("obs", "action", "log_prob", "value", "reward", "next_value",
             "terminated", "done")


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 8                  # reference: 8 DPPO workers
    unroll_length: int = 512
    minibatch_size: int = 256          # = reference batch 32 x 8 workers
    opt_epochs: int = 1
    epsilon: float = 0.2
    lr_actor: float = 1e-4
    lr_critic: float = 1e-4
    norm_clip: Optional[float] = 1.0


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: every gradient becomes
    g / |g| * max_norm when the global norm |g| is at least max_norm (on
    the device: no host sync)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class ClippedAdam:
    """Per clip group: the global-norm clip, then Adam."""

    def __init__(self, groups: Sequence[Sequence[torch.nn.Parameter]],
                 lrs: Sequence[float], max_norm: Optional[float], capturable: bool = False):
        self.groups = [list(g) for g in groups]
        self.max_norm = max_norm
        self.capturable = capturable    # Adam's step counts on the device (CUDA graphs)
        # set on a rank of a data-parallel run: the gradients are summed over
        # the ranks before the clip where each rank's loss is its share of a
        # split minibatch, averaged where every rank computes the whole step
        self.mesh: Optional[mesh_mod.DataMesh] = None
        self.average = False
        self.adam = torch.optim.Adam(
            [{"params": g, "lr": lr} for g, lr in zip(self.groups, lrs)],
            betas=(0.9, 0.999), eps=1e-8, capturable=capturable)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        if self.mesh is not None:
            self.mesh.all_reduce_([p.grad for g in self.groups for p in g
                                   if p.grad is not None], average=self.average)
        if self.max_norm:
            for group in self.groups:
                clip_by_global_norm_([p.grad for p in group if p.grad is not None],
                                     self.max_norm)
        self.adam.step()

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        """Adam's state from ``sd``, copied into the tensors it already holds
        where their shapes and devices agree, so that a CUDA graph captured
        on them steps from the restored values."""
        held = {p: dict(s) for p, s in self.adam.state.items()}
        self.adam.load_state_dict(sd)
        for p, s in self.adam.state.items():
            for k, old in held.get(p, {}).items():
                new = s.get(k)
                if (torch.is_tensor(old) and torch.is_tensor(new) and old.shape == new.shape
                        and old.device == new.device and old.dtype == new.dtype):
                    old.copy_(new)
                    s[k] = old

    def set_capturable(self, on: bool) -> None:
        """Adam's step counts on the device (``on``) or on the host."""
        self.capturable = on
        for g in self.adam.param_groups:
            g["capturable"] = on
        for s in self.adam.state.values():
            if "step" in s:
                s["step"] = s["step"].to(s["exp_avg"].device if on else "cpu")


def make_optimizer(cfg: PPOConfig, net: ActorCritic) -> ClippedAdam:
    """``ppo.py:88``: the critic's parameters are one group and everything
    else the actor's; one clip and one Adam over both when the learning
    rates agree, as in the preset."""
    actor, critic = [], []
    for name, p in net.named_parameters():
        (critic if name.split(".")[0] == "critic" else actor).append(p)
    if cfg.lr_actor == cfg.lr_critic:
        return ClippedAdam([actor + critic], [cfg.lr_actor], cfg.norm_clip)
    return ClippedAdam([actor, critic], [cfg.lr_actor, cfg.lr_critic], cfg.norm_clip)


@dataclasses.dataclass
class PPOState:
    """Everything a training run carries from round to round. ``net`` and
    ``opt`` are the algorithm's own module and optimizer, updated in place."""

    net: ActorCritic                   # parameters and observation normalizer
    opt: ClippedAdam                   # Adam moments and step counts
    head_stats: Dict                   # PFPN activation accumulators
    env_state: Any
    obs: torch.Tensor
    generator: torch.Generator         # every random draw of the run
    global_step: int = 0               # optimizer steps
    total_samples: int = 0
    ep_return: Optional[torch.Tensor] = None       # (B,) running return
    last_ep_return: Optional[torch.Tensor] = None  # (B,) last finished episode
    # the value-target normalizer (the identity unless net.cfg.normalize_value)
    vnorm: Optional[vnorm_mod.ValueNormState] = None
    # the LSTM's (c, h) per env, RecurrentPPO's only (algos/recurrent.py)
    carry: Any = None

    def replace(self, **kw) -> "PPOState":
        return dataclasses.replace(self, **kw)


class PPO:
    """Binds (env, ActorCritic, PPOConfig) and the optimizer."""

    # whether a sharded run splits each minibatch's gradient over the ranks
    # (else every rank computes the whole update)
    SPLIT_UPDATE = True

    def __init__(self, env, net: ActorCritic, cfg: PPOConfig = PPOConfig()):
        self.env = env
        self.net = net
        self.cfg = cfg
        self.opt = make_optimizer(cfg, net)
        self.mesh: Optional[mesh_mod.DataMesh] = None    # set by shard()
        self.split: Optional[mesh_mod.DataMesh] = None   # the split update's

    def shard(self, mesh: mesh_mod.DataMesh) -> None:
        """Make this algorithm one rank of a data-parallel run: its env
        steps the rank's slice of the batch; with :attr:`SPLIT_UPDATE` the
        minibatches are split too (the gradients summed over the ranks),
        else every rank computes the whole update (the gradients averaged)."""
        mesh_mod.check_divisible(self.cfg.num_envs, mesh.world)
        self.env = mesh_mod.ShardedEnv(self.env, mesh)
        self.mesh = self.opt.mesh = mesh
        if self.SPLIT_UPDATE:
            if self.cfg.minibatch_size % mesh.world:
                raise ValueError(
                    f"minibatch_size={self.cfg.minibatch_size} is not divisible "
                    f"by the world size {mesh.world}")
            self.split = mesh
        else:
            self.opt.average = True

    # -- init ------------------------------------------------------------
    def init_state(self, generator: torch.Generator) -> PPOState:
        """Initialize the parameters and reset ``num_envs`` envs, all from
        ``generator`` (ppo.py:112)."""
        self.net.init_parameters(generator)
        env_state, obs = self.env.reset_batch(self.cfg.num_envs, generator)
        zeros = torch.zeros(self.cfg.num_envs, device=obs.device)
        return PPOState(net=self.net, opt=self.opt, head_stats=self.net.init_stats(),
                        env_state=env_state, obs=obs, generator=generator,
                        ep_return=zeros, last_ep_return=zeros.clone(),
                        vnorm=vnorm_mod.init(obs.device))

    # -- rollout ---------------------------------------------------------
    def _clip_action(self, a: torch.Tensor) -> torch.Tensor:
        """The action clipped to the env's bounds; unchanged when the env
        has none (ppo.py:135-140)."""
        if getattr(self.env, "action_low", None) is None:
            return a
        return torch.clamp(a, const(self.env.action_low, a),
                           const(self.env.action_high, a))

    @torch.no_grad()
    def rollout(self, state: PPOState) -> Tuple[PPOState, Dict[str, torch.Tensor]]:
        """``unroll_length`` sampled steps of every env (ppo.py:142):
        returns the state after them and the time-major trajectory."""
        net, env, cfg = self.net, self.env, self.cfg
        env_state, stats = state.env_state, state.head_stats
        obs, ep_ret, last_ret = mesh_mod.to_global(
            self.mesh, state.obs, state.ep_return, state.last_ep_return)
        steps: Dict[str, List[torch.Tensor]] = {k: [] for k in TRAJ_KEYS}
        for _ in range(cfg.unroll_length):
            a, lp, v, aux = net.act(obs, state.generator, state.vnorm)
            if net.is_pfpn:
                stats = update_activation_stats(stats, aux["probs"])
            env_state, next_obs, res = env.step_autoreset(
                env_state, self._clip_action(a), state.generator)
            v_next = net.value(res.obs, state.vnorm)   # the pre-reset observation
            ep_ret = ep_ret + res.reward
            last_ret = torch.where(res.done, ep_ret, last_ret)
            ep_ret = torch.where(res.done, torch.zeros_like(ep_ret), ep_ret)
            for k, x in zip(TRAJ_KEYS, (obs, a, lp, v, res.reward, v_next,
                                        res.terminated, res.done)):
                steps[k].append(x)
            obs = next_obs
        traj = {k: torch.stack(v) for k, v in steps.items()}
        obs, ep_ret, last_ret = mesh_mod.to_local(self.mesh, obs, ep_ret, last_ret)
        state = state.replace(
            env_state=env_state, obs=obs, head_stats=stats, ep_return=ep_ret,
            last_ep_return=last_ret,
            total_samples=state.total_samples + cfg.unroll_length * cfg.num_envs)
        return state, traj

    # -- losses ----------------------------------------------------------
    def _loss(self, batch: Dict[str, torch.Tensor],
              vnorm: Optional[vnorm_mod.ValueNormState] = None):
        """(loss, metrics) of a minibatch (ppo.py:180); in a split update,
        this rank's share of them."""
        net, ncfg = self.net, self.net.cfg
        part = batch if self.split is None else {
            k: self.split.local(v) for k, v in batch.items()}
        lp = net.log_prob(part["obs"], part["action"])
        v_target = part["value"] + part["advantage"]     # ppo.py:195
        if ncfg.normalize_value:
            v = net.normalized_value(part["obs"], vnorm)
            v_target = vnorm_mod.normalize_target(vnorm, v_target, clip=ncfg.clip_value)
        else:
            v = net.value(part["obs"])
        ent = net.entropy(part["obs"]) if ncfg.entropy_beta else None
        return self._objective(batch, lp, v, v_target, ent, part)

    def _mean(self, x: torch.Tensor) -> torch.Tensor:
        """The minibatch mean; in a split update, this rank's rows' share
        of it."""
        if self.split is None:
            return torch.mean(x)
        return torch.sum(x) / (x.numel() * self.split.world)

    def _objective(self, batch: Dict[str, torch.Tensor], lp: torch.Tensor,
                   v: torch.Tensor, v_target: torch.Tensor, ent: Optional[torch.Tensor],
                   part: Optional[Dict[str, torch.Tensor]] = None):
        """(loss, metrics) from the log-probs, values, value targets and,
        with an entropy bonus, entropies of ``part``, the rows of
        ``batch`` this rank computes (all of them by default): the
        advantage normalized over the whole minibatch and clipped as
        configured, the policy loss (:meth:`_surrogate`), the squared value
        error, the bonus."""
        ncfg = self.net.cfg
        adv = batch["advantage"]
        if ncfg.normalize_advantage:
            adv = (adv - torch.mean(adv)) / (torch.std(adv, correction=0) + 1e-8)
        if ncfg.clip_advantage:
            adv = torch.clamp(adv, -ncfg.clip_advantage, ncfg.clip_advantage)
        if part is None:
            part = batch
        elif self.split is not None:
            adv = self.split.local(adv)
        policy_loss = self._surrogate(lp, part, adv.detach())
        value_loss = self._mean((v - v_target.detach()) ** 2)
        entropy = torch.zeros((), device=lp.device)
        if ncfg.entropy_beta:
            entropy = self._mean(ent)
            policy_loss = policy_loss - ncfg.entropy_beta * entropy
        loss = policy_loss + ncfg.value_loss_coef * value_loss
        metrics = {"policy_loss": policy_loss.detach(),
                   "value_loss": value_loss.detach(), "entropy": entropy.detach()}
        return loss, metrics

    def _surrogate(self, lp: torch.Tensor, batch: Dict[str, torch.Tensor],
                   adv: torch.Tensor) -> torch.Tensor:
        """The clipped surrogate's policy loss (ppo.py:184-193)."""
        eps = self.cfg.epsilon
        ratio = torch.exp(lp - batch["log_prob"])
        clipped = torch.clamp(ratio, 1.0 - eps, 1.0 + eps) * adv
        return -self._mean(torch.minimum(ratio * adv, clipped))

    # -- update ----------------------------------------------------------
    def update(self, state: PPOState, traj: Dict[str, torch.Tensor]):
        """GAE, then ``opt_epochs`` passes of shuffled minibatches
        (ppo.py:232). Returns (state, metrics averaged over the
        minibatches, as device scalars)."""
        net, cfg, ncfg = self.net, self.cfg, self.net.cfg
        adv = gae(traj["reward"], traj["value"], traj["next_value"],
                  traj["terminated"], traj["done"], ncfg.gamma, ncfg.lambd)
        flat = {k: traj[k].reshape((-1,) + traj[k].shape[2:])
                for k in ("obs", "action", "log_prob", "value")}
        flat["advantage"] = adv.reshape(-1)
        n = flat["advantage"].shape[0]
        mb = cfg.minibatch_size
        gstep, stats, vnorm = state.global_step, state.head_stats, state.vnorm
        per_mb = []
        for epoch in range(cfg.opt_epochs):
            perm = torch.randperm(n, generator=state.generator, device=adv.device)
            for i in range(n // mb):
                idx = perm[i * mb:(i + 1) * mb]
                batch = {k: v[idx] for k, v in flat.items()}
                self.opt.zero_grad()
                loss, metrics = self._loss(batch, vnorm)
                loss.backward()
                self.opt.step()
                gstep += 1
                if ncfg.normalize_value:
                    # every minibatch of every epoch (ppo.py:258-265)
                    vnorm = vnorm_mod.update(vnorm, batch["value"] + batch["advantage"], gstep)
                if ncfg.normalize_state and epoch == 0:
                    # first epoch only (sync_model.py:103-149)
                    net.norm.update_moving_average(batch["obs"], gstep)
                if net.is_pfpn and ncfg.head.resample:
                    stats = maybe_resample(ncfg.head, net.head, stats, state.generator)
                metrics["loss"] = loss.detach()
                per_mb.append(metrics)
        metrics = {k: torch.stack([m[k] for m in per_mb]) for k in per_mb[0]}
        if self.split is not None:
            self.split.all_reduce_(list(metrics.values()))   # the ranks' shares
        metrics = {k: v.mean() for k, v in metrics.items()}
        return state.replace(head_stats=stats, vnorm=vnorm, global_step=gstep), metrics

    # -- one full round ----------------------------------------------------
    def train_round(self, state: PPOState):
        """rollout + update (ppo.py:300). Metrics are Python numbers; the
        counters stay ints."""
        state, traj = self.rollout(state)
        state, metrics = self.update(state, traj)
        metrics["episode_reward"] = torch.mean(
            mesh_mod.to_global(self.mesh, state.last_ep_return)[0])
        out: Dict[str, Any] = {k: float(v) for k, v in metrics.items()}
        out["total_samples"] = state.total_samples
        out["global_step"] = state.global_step
        return state, out

    # -- deterministic evaluation --------------------------------------------
    @torch.no_grad()
    def evaluate(self, num_episodes: int = 10, max_steps: int = 600,
                 generator: Optional[torch.Generator] = None,
                 init_time: Optional[torch.Tensor] = None) -> dict:
        """Deterministic episodes (ppo.py:312), started at phases drawn from
        ``generator`` or, when given, at the times ``init_time``
        (``num_episodes``,); stops early once every episode is done (later
        steps would add nothing). Returns per-episode ``reward``, ``frames``
        and ``finished``."""
        env = self.env
        if init_time is None:
            state, obs = env.reset_batch(num_episodes, generator)
        else:
            state, obs = env.reset_at(init_time)
        ret = torch.zeros(num_episodes, device=obs.device)
        frames = torch.zeros(num_episodes, dtype=torch.int32, device=obs.device)
        done = torch.zeros(num_episodes, dtype=torch.bool, device=obs.device)
        carry = self._eval_carry(num_episodes)
        for _ in range(max_steps):
            a, carry = self._eval_act(obs, carry)
            res = env.step_batch(state, self._clip_action(a))
            ret = ret + torch.where(done, torch.zeros_like(res.reward), res.reward)
            frames = frames + (~done).int()
            done = done | res.done
            state, obs = res.state, res.obs
            if bool(done.all()):
                break
        return {"reward": ret, "frames": frames, "finished": done}

    def _eval_carry(self, num_episodes: int):
        """The policy's state at an episode's start: none here."""
        return None

    def _eval_act(self, obs: torch.Tensor, carry):
        """(deterministic action, the policy's next state)."""
        return self.net.act_deterministic(obs), carry
