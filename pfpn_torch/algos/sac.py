"""SAC and DDPG/TD3 with a replay ring on the env's device.

Counterpart of ``pfpn_tpu/algos/sac.py``: twin Q critics on [normalized,
clipped state ‖ action], Polyak-averaged targets (tau 0.005), tanh-squashed
policies on the env's bounds. SAC learns the temperature alpha with the
target entropy -|A| folded into the policy loss; DDPG/TD3 acts with its
deterministic actor plus Gaussian (or Ornstein-Uhlenbeck) noise, bootstraps
from a target actor with smoothing noise, and updates its policy on every
``policy_delay``-th step.

A round is ``steps_per_round`` env steps of the ``num_envs`` envs; after
each step's insert, ``updates_per_step`` gradient steps at batch
``batch_size`` on the ring, once it holds ``batch_size + warmup``
transitions (``sac.py:315-396``). The JAX package runs the round as one
jitted scan; here it runs eagerly, the gate a comparison of Python ints,
the round's metrics fetched from the device once.

Semantics kept from the JAX package:

* the ring stores the clipped env action, the pre-reset next observation
  and ``not_terminal``, 0 only on a true termination;
* one backward of critic + actor loss; Q's parameters are held fixed in
  the actor loss (``torch.func.functional_call`` on detached copies), so
  the actor's gradient passes through Q's input only;
* clip by the global norm and Adam in three groups, each clipped by its
  own norm: the actor, the critics (``q1``, ``q2``) and ``log_alpha``
  (``sac.py:104-126``). Every parameter takes an Adam step on every update,
  with a zero gradient where the loss does not reach it, as optax does:
  DDPG's actor on an ungated step moves by its momentum alone;
* after the step: Polyak of the target critics, of DDPG's target actor on
  gated steps only, the normalizer's moving average at the new step, and
  ``maybe_resample`` on the step counter. DDPG's behaviour action carries
  no particle weights (``sac.py:210``), so DDPG-PFPN's activation
  statistics stay 0 and every particle counts as dead at the interval;
* ``global_step`` counts the gradient steps that ran; a round's metrics
  are the means over all its inner steps, 0 where no update ran (alpha
  its value then).

Random draws come from the run's ``torch.Generator``; :meth:`SAC.update_draws`
makes an update's noise apart from :meth:`SAC._update_step`, so that a test
can feed the JAX package's draws.

On one card SAC's gradient steps after the first replay a CUDA graph of the
step after its draws (:class:`_UpdateGraph`); the draws, the ring's gather
and PFPN resampling stay eager.

Tracing: each env step's part of a round (the behaviour action, the clip,
``step_autoreset``, the ring insert and the episode bookkeeping) is the
named region ``sac.env_step``, each gradient step (the draw from the ring,
``update_draws`` and ``_update_step``) the region ``sac.update_step``
(``utils/profiling.annotate``); ``SAC.env_steps`` and ``SAC.grad_steps``
count them as Python ints, with no host sync.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.func import functional_call

from ..distributed import mesh as mesh_mod
from ..networks.actor_critic import ACConfig, ActorCritic
from ..networks.heads import update_activation_stats
from ..networks.mlp import MLP
from ..networks.resample import maybe_resample
from ..utils.profiling import annotate
from .ppo import PPO, ClippedAdam
from .replay import ReplayBuffer

ACTOR_PARTS = ("common", "actor_trunk", "head")


@dataclasses.dataclass(frozen=True)
class SACConfig:
    algo: str = "sac"                 # "sac" | "ddpg"
    num_envs: int = 1
    batch_size: int = 256
    buffer_capacity: int = 1_000_000
    warmup: int = 0                   # extra transitions before the first update
    steps_per_round: int = 64         # env steps per round
    updates_per_step: int = 1         # gradient steps per env step (num_envs keeps
                                      # one gradient step per sample)
    gamma: float = 0.95
    tau: float = 0.005
    lr_actor: float = 1e-4
    lr_critic: float = 1e-4
    lr_alpha: float = 1e-4
    norm_clip: Optional[float] = 1.0
    # DDPG/TD3 options
    twin_q: bool = True
    policy_delay: int = 2
    act_noise: float = 0.1
    target_noise: float = 0.2
    # Ornstein-Uhlenbeck exploration, per env:
    # n <- (1 - theta dt) n + sigma sqrt(dt) N(0, 1)
    ou_noise: bool = False
    ou_sigma: float = 0.3
    ou_theta: float = 0.15
    ou_dt: float = 0.01


class SACNet(ActorCritic):
    """SAC's and DDPG's parameters (``sac.py:132-142``): the actor of
    :class:`ActorCritic` without its value MLP, the twin critics ``q1`` and
    ``q2`` as MLPs [obs + act, *critic_shape, 1], and for SAC the 0-d
    temperature ``log_alpha``. The state dict's names map one to one onto
    the JAX package's ``params/...`` and ``norm/...`` arrays
    (``load_jax_params``)."""

    def __init__(self, cfg: ACConfig, algo: str = "sac"):
        super().__init__(cfg, with_critic=False)
        sizes = [cfg.obs_dim + cfg.head.action_dim, *cfg.critic_shape, 1]
        self.q1 = MLP(sizes)
        self.q2 = MLP(sizes)
        self.log_alpha = nn.Parameter(torch.zeros(())) if algo == "sac" else None

    def init_parameters(self, generator: Optional[torch.Generator]) -> None:
        super().init_parameters(generator)
        self.q1.init_parameters(generator)
        self.q2.init_parameters(generator)
        if self.log_alpha is not None:
            with torch.no_grad():
                self.log_alpha.zero_()


def make_target(net: SACNet, algo: str) -> nn.ModuleDict:
    """Detached copies of the critics and, for DDPG, of the whole actor
    (``sac.py:144-156``)."""
    names = ["q1", "q2"]
    if algo == "ddpg":
        names += [k for k in ACTOR_PARTS if getattr(net, k) is not None]
    target = nn.ModuleDict({k: copy.deepcopy(getattr(net, k)) for k in names})
    return target.requires_grad_(False)


def make_optimizer(cfg: SACConfig, net: SACNet) -> ClippedAdam:
    """Clip + Adam in three groups, each clipped by its own global norm:
    actor, critics, temperature (``sac.py:104-126``)."""
    groups: Dict[str, List[nn.Parameter]] = {"actor": [], "critic": [], "alpha": []}
    for name, p in net.named_parameters():
        top = name.split(".")[0]
        groups["critic" if top in ("q1", "q2") else "alpha" if top == "log_alpha"
               else "actor"].append(p)
    lrs = {"actor": cfg.lr_actor, "critic": cfg.lr_critic, "alpha": cfg.lr_alpha}
    kept = [k for k in groups if groups[k]]
    # Adam's step counts on the card where SAC's step can run as a CUDA graph
    # (:class:`_UpdateGraph`): SAC on one card, outside a process group
    capturable = (cfg.algo == "sac" and next(net.parameters()).is_cuda
                  and mesh_mod.current_mesh() is None)
    return ClippedAdam([groups[k] for k in kept], [lrs[k] for k in kept], cfg.norm_clip,
                       capturable=capturable)


@dataclasses.dataclass
class SACState:
    """Everything a run carries from round to round (``sac.py:77-92``).
    ``net``, ``target`` and ``opt`` are the algorithm's own, updated in
    place; ``buffer`` is not checkpointed."""

    net: SACNet                        # parameters and observation normalizer
    target: nn.ModuleDict              # target critics (and DDPG's target actor)
    opt: ClippedAdam
    head_stats: Dict                   # PFPN activation accumulators
    buffer: ReplayBuffer
    env_state: Any
    obs: torch.Tensor
    generator: torch.Generator
    global_step: int = 0               # gradient steps that ran
    total_samples: int = 0
    ep_return: Optional[torch.Tensor] = None
    last_ep_return: Optional[torch.Tensor] = None
    ou_state: Optional[torch.Tensor] = None    # (B, A) OU noise, 0 unless ou_noise

    def replace(self, **kw) -> "SACState":
        return dataclasses.replace(self, **kw)


class SAC:
    """Binds (env, SACNet, SACConfig), the targets and the optimizer."""

    _clip_action = PPO._clip_action
    evaluate = PPO.evaluate
    _eval_carry, _eval_act = PPO._eval_carry, PPO._eval_act

    def __init__(self, env, net: SACNet, cfg: SACConfig = SACConfig()):
        self.env = env
        self.net = net
        self.cfg = cfg
        self.target = make_target(net, cfg.algo)
        self.opt = make_optimizer(cfg, net)
        self.params = [p for g in self.opt.groups for p in g]
        self.mesh: Optional[mesh_mod.DataMesh] = None    # set by shard()
        self.env_steps = 0      # env steps run by train_round, each of num_envs samples
        self.grad_steps = 0     # gradient steps run by train_round
        self._graph: Optional[_UpdateGraph] = None

    def shard(self, mesh: mesh_mod.DataMesh) -> None:
        """Make this algorithm one rank of a data-parallel run: its env
        steps the rank's slice of the batch, every step's transitions go
        into every rank's ring, and every rank runs the same gradient
        steps, their gradients averaged over the ranks."""
        mesh_mod.check_divisible(self.cfg.num_envs, mesh.world)
        self.env = mesh_mod.ShardedEnv(self.env, mesh)
        self.mesh = self.opt.mesh = mesh
        self.opt.average = True
        self.opt.set_capturable(False)      # a rank's step runs eagerly

    # -- init ------------------------------------------------------------
    @torch.no_grad()
    def sync_target(self) -> None:
        """The targets set to the online parameters."""
        for name, module in self.target.items():
            module.load_state_dict(getattr(self.net, name).state_dict())

    def init_state(self, generator: torch.Generator) -> SACState:
        """Parameters, targets equal to them, ``num_envs`` envs reset and an
        empty ring of ``buffer_capacity`` on the env's device."""
        cfg = self.cfg
        self.net.init_parameters(generator)
        self.sync_target()
        env_state, obs = self.env.reset_batch(cfg.num_envs, generator)
        dev, act_dim = obs.device, self.net.cfg.head.action_dim
        zeros = torch.zeros(cfg.num_envs, device=dev)
        example = {"obs": obs, "action": torch.zeros(cfg.num_envs, act_dim, device=dev),
                   "reward": zeros, "not_terminal": zeros + 1.0, "next_obs": obs}
        return SACState(
            net=self.net, target=self.target, opt=self.opt,
            head_stats=self.net.init_stats(),
            buffer=ReplayBuffer(cfg.buffer_capacity, example),
            env_state=env_state, obs=obs, generator=generator, ep_return=zeros,
            last_ep_return=zeros.clone(),
            ou_state=torch.zeros(cfg.num_envs, act_dim, device=dev))

    # -- forward helpers ---------------------------------------------------
    def _q_value(self, q: MLP, obs: torch.Tensor, action: torch.Tensor,
                 fixed: bool = False) -> torch.Tensor:
        """Q on [normalized state ‖ action] (``sac.py:179-184``); ``fixed``
        holds Q's parameters out of the gradient, not its input."""
        inp = torch.cat([self.net.normalized(obs), action], -1)
        if fixed:
            params = {k: p.detach() for k, p in q.named_parameters()}
            return functional_call(q, params, (inp,))[..., 0]
        return q(inp)[..., 0]

    def _target_mode(self, obs: torch.Tensor) -> torch.Tensor:
        """DDPG's target actor's deterministic action, on the online
        normalizer (``sac.py:229-230``)."""
        x = self.net.normalized(obs)
        for k in ("common", "actor_trunk"):
            if k in self.target:
                x = self.target[k](x)
        return self.target["head"].deterministic_action(x)

    def _sample(self, obs: torch.Tensor, draws: Dict):
        return self.net.head.sample_with_log_prob(self.net.actor_features(obs), None, draws)

    @torch.no_grad()
    def _explore_action(self, obs: torch.Tensor, ou: torch.Tensor,
                        generator: Optional[torch.Generator]):
        """Behaviour action (``sac.py:194-210``). Returns (action, aux, ou)."""
        cfg, head = self.cfg, self.net.head
        if cfg.algo == "sac":
            a, _, aux = self._sample(obs, head.draw(obs.shape[:-1], generator))
            return a, aux, ou
        a = self.net.act_deterministic(obs)
        noise = torch.randn(a.shape, generator=generator, device=a.device)
        if cfg.ou_noise:
            ou = ((1.0 - cfg.ou_theta * cfg.ou_dt) * ou
                  + cfg.ou_sigma * math.sqrt(cfg.ou_dt) * noise)
            return a + ou, {}, ou
        return a + cfg.act_noise * noise, {}, ou

    # -- losses ------------------------------------------------------------
    def update_draws(self, batch_size: int, generator: Optional[torch.Generator]) -> Dict:
        """The noise of one update: SAC's draws of the next action (critic)
        and of the action (actor); DDPG's target smoothing noise."""
        cfg, head = self.cfg, self.net.head
        if cfg.algo == "sac":
            return {"critic": head.draw((batch_size,), generator),
                    "actor": head.draw((batch_size,), generator)}
        dev = self.net.q1.layers[0].weight.device
        noise = (torch.randn(batch_size, head.cfg.action_dim, generator=generator, device=dev)
                 if cfg.target_noise else None)
        return {"critic": noise}

    def _critic_loss(self, batch: Dict[str, torch.Tensor], draws: Dict) -> torch.Tensor:
        """``sac.py:220-244``."""
        cfg, net = self.cfg, self.net
        nxt = batch["next_obs"]
        with torch.no_grad():
            if cfg.algo == "sac":
                a2, lp2, _ = self._sample(nxt, draws["critic"])
                v_next = (torch.minimum(self._q_value(self.target["q1"], nxt, a2),
                                        self._q_value(self.target["q2"], nxt, a2))
                          - torch.exp(net.log_alpha) * lp2)
            else:
                a2 = self._target_mode(nxt)
                if cfg.target_noise:
                    a2 = self._clip_action(a2 + cfg.target_noise * draws["critic"])
                v_next = self._q_value(self.target["q1"], nxt, a2)
                if cfg.twin_q:
                    v_next = torch.minimum(v_next, self._q_value(self.target["q2"], nxt, a2))
            q_target = batch["reward"] + cfg.gamma * batch["not_terminal"] * v_next
        q1 = self._q_value(net.q1, batch["obs"], batch["action"])
        q2 = self._q_value(net.q2, batch["obs"], batch["action"])
        return torch.mean((q_target - q1) ** 2 + (q_target - q2) ** 2)

    def _actor_loss(self, batch: Dict[str, torch.Tensor], draws: Dict,
                    gstep: int) -> torch.Tensor:
        """``sac.py:246-267``."""
        cfg, net, obs = self.cfg, self.net, batch["obs"]
        if cfg.algo == "sac":
            a, lp, _ = self._sample(obs, draws["actor"])
            q = torch.minimum(self._q_value(net.q1, obs, a, fixed=True),
                              self._q_value(net.q2, obs, a, fixed=True))
            alpha = torch.exp(net.log_alpha).detach()
            target_entropy = -float(net.cfg.head.action_dim)
            return (torch.mean(alpha * lp - q)
                    - torch.mean(net.log_alpha * (lp + target_entropy).detach()))
        loss = -torch.mean(self._q_value(net.q1, obs, net.act_deterministic(obs), fixed=True))
        if cfg.policy_delay > 1:
            loss = loss * float(gstep % cfg.policy_delay == 0)
        return loss

    # -- one gradient step ---------------------------------------------------
    def _apply(self, batch: Dict[str, torch.Tensor], draws: Dict, gstep: int,
               new_step) -> Dict[str, torch.Tensor]:
        """The step after its draws: the losses, one backward, the clip and
        Adam, the targets' Polyak step and the normalizer's moving average at
        ``new_step`` (an int, or a device tensor inside a CUDA graph).
        Returns the metrics as device scalars."""
        cfg, net = self.cfg, self.net
        closs = self._critic_loss(batch, draws)
        aloss = self._actor_loss(batch, draws, gstep)
        loss = closs + aloss
        # backward on this thread, not autograd's device thread: the eager
        # step is host-paced, and the graph is captured on this thread
        with torch.autograd.set_multithreading_enabled(False):
            loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.opt.step()

        with torch.no_grad():
            names = ["q1", "q2"]
            if cfg.algo == "ddpg" and (cfg.policy_delay <= 1
                                       or (gstep + 1) % cfg.policy_delay == 0):
                names += [k for k in ACTOR_PARTS if k in self.target]
            tgt = [t for k in names for t in self.target[k].parameters()]
            src = [p for k in names for p in getattr(net, k).parameters()]
            torch._foreach_mul_(tgt, 1.0 - cfg.tau)
            torch._foreach_add_(tgt, src, alpha=cfg.tau)
        if net.cfg.normalize_state:
            net.norm.update_moving_average(batch["obs"], new_step)
        metrics = {"loss": loss.detach(), "critic_loss": closs.detach(),
                   "actor_loss": aloss.detach()}
        if cfg.algo == "sac":
            metrics["alpha"] = torch.exp(net.log_alpha.detach())
        return metrics

    def _update_step(self, batch: Dict[str, torch.Tensor], draws: Dict, gstep: int,
                     stats: Dict, generator: Optional[torch.Generator]):
        """One gradient step (``sac.py:269-313``). Returns (global_step,
        head_stats, metrics as device scalars). SAC's steps on one card,
        after the first, replay a CUDA graph of :meth:`_apply`
        (:class:`_UpdateGraph`); DDPG's, a data-parallel rank's and the CPU's
        run eagerly."""
        graph = self._graph
        if graph is not None and graph.fits(batch):
            metrics = graph(batch, draws, gstep)
        else:
            self.opt.zero_grad()
            metrics = self._apply(batch, draws, gstep, gstep + 1)
            if (self.cfg.algo == "sac" and self.mesh is None
                    and batch["obs"].is_cuda and self.opt.capturable):
                self._graph = _UpdateGraph(self, batch, draws)
        gstep += 1
        net = self.net
        if net.is_pfpn and net.cfg.head.resample:
            stats = maybe_resample(net.cfg.head, net.head, stats, generator)
        return gstep, stats, metrics

    # -- one round -------------------------------------------------------------
    def train_round(self, state: SACState):
        """``steps_per_round`` env steps, each followed by its gradient
        steps (``sac.py:315-396``). Metrics are Python numbers, fetched from
        the device once; the counters stay ints."""
        cfg, net, gen = self.cfg, self.net, state.generator
        buf, stats, gstep = state.buffer, state.head_stats, state.global_step
        env_state = state.env_state
        obs, ou, ep_ret, last_ret = mesh_mod.to_global(
            self.mesh, state.obs, state.ou_state, state.ep_return, state.last_ep_return)
        ran: List[Dict[str, torch.Tensor]] = []
        idle_alpha: List[torch.Tensor] = []
        for _ in range(cfg.steps_per_round):
            with annotate("sac.env_step"):
                a, aux, ou = self._explore_action(obs, ou, gen)
                if net.is_pfpn and "probs" in aux:
                    stats = update_activation_stats(stats, aux["probs"])
                a_env = self._clip_action(a)
                env_state, next_obs, res = self.env.step_autoreset(env_state, a_env, gen)
                buf.add_batch({"obs": obs, "action": a_env, "reward": res.reward,
                               "not_terminal": 1.0 - res.terminated.float(),
                               "next_obs": res.obs})
                ep_ret = ep_ret + res.reward
                last_ret = torch.where(res.done, ep_ret, last_ret)
                ep_ret = torch.where(res.done, torch.zeros_like(ep_ret), ep_ret)
            self.env_steps += 1
            if buf.size >= cfg.batch_size + cfg.warmup:
                for _ in range(cfg.updates_per_step):
                    with annotate("sac.update_step"):
                        batch = buf.sample(cfg.batch_size, gen)
                        gstep, stats, m = self._update_step(
                            batch, self.update_draws(cfg.batch_size, gen), gstep, stats, gen)
                    self.grad_steps += 1
                    ran.append(m)
            elif cfg.algo == "sac":
                idle_alpha.append(torch.exp(net.log_alpha.detach()))
            obs = next_obs

        n = cfg.steps_per_round * cfg.updates_per_step
        keys = ["loss", "critic_loss", "actor_loss"] + (["alpha"] if cfg.algo == "sac" else [])
        zero = torch.zeros((), device=obs.device)
        sums = [torch.stack([m[k] for m in ran]).sum() if ran else zero for k in keys]
        if cfg.algo == "sac" and idle_alpha:
            sums[-1] = sums[-1] + torch.stack(idle_alpha).sum() * cfg.updates_per_step
        vals = torch.stack([s / n for s in sums] + [torch.mean(last_ret)]).tolist()
        out: Dict[str, Any] = dict(zip(keys + ["episode_reward"], vals))
        total = state.total_samples + cfg.steps_per_round * cfg.num_envs
        out["total_samples"] = total
        out["global_step"] = gstep
        obs, ou, ep_ret, last_ret = mesh_mod.to_local(self.mesh, obs, ou, ep_ret, last_ret)
        state = state.replace(head_stats=stats, env_state=env_state, obs=obs,
                              global_step=gstep, total_samples=total, ep_return=ep_ret,
                              last_ep_return=last_ret, ou_state=ou)
        return state, out


class _UpdateGraph:
    """:meth:`SAC._apply` for one batch size as a CUDA graph.

    SAC's gradient step on one card is small gemms at batch 256 behind
    ~540 launches, so the host's launches pace it. A call copies the
    step's batch and draws (drawn eagerly from the run's generator, as the
    eager step draws them) and its new step count into static buffers and
    replays the graph: the losses, one backward into the gradients the
    graph owns, the per-group clip and Adam (``capturable``, its step
    counts on the card), the targets' Polyak step and the normalizer's
    moving average, the eager step's operations in its order on the same
    operands; then it clones the metrics. The graph is captured at the
    second step, after an eager step has set up Adam's state and the
    libraries' lazy state, and holds the storage of the parameters, their
    gradients, the targets, Adam's state and the normalizer: these are
    updated in place (``maybe_resample`` and ``sync_target`` too)."""

    def __init__(self, algo: SAC, batch: Dict[str, torch.Tensor], draws: Dict):
        self.algo = algo
        self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        self.draws = {k: {kk: torch.empty_like(vv) for kk, vv in d.items()}
                      for k, d in draws.items()}
        self.new_step = torch.zeros((), device=batch["obs"].device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.metrics: Dict[str, torch.Tensor] = {}

    def fits(self, batch: Dict[str, torch.Tensor]) -> bool:
        return all(batch[k].shape == v.shape for k, v in self.batch.items())

    def capture(self) -> None:
        """Record :meth:`SAC._apply` on the static buffers (nothing runs
        while capturing). The gradients are set to None first, so that the
        backward allocates them from the graph's memory."""
        algo = self.algo
        algo.opt.zero_grad()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.new_step.device), \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.metrics = algo._apply(self.batch, self.draws, 0, self.new_step)
        self.graph = graph

    def __call__(self, batch: Dict[str, torch.Tensor], draws: Dict,
                 gstep: int) -> Dict[str, torch.Tensor]:
        for k, v in batch.items():
            self.batch[k].copy_(v)
        for k, d in draws.items():
            for kk, vv in d.items():
                self.draws[k][kk].copy_(vv)
        self.new_step.fill_(gstep + 1)
        if self.graph is None:
            self.capture()
        self.graph.replay()
        return {k: v.clone() for k, v in self.metrics.items()}
