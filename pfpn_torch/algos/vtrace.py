"""IMPALA / V-trace on PPO's rollout.

Counterpart of ``pfpn_tpu/algos/vtrace.py``. The reference decouples 32
actors from one learner through a queue of padded episodes; the JAX
package, and so the port, keeps the actors as the env batch and turns the
learner's "dequeue batches of 4" into sequential gradient steps over
groups of ``queue_batch`` env streams per round: 32 envs x 64 steps in
groups of 4 are 8 gradient steps. Group ``i`` is envs
``[i * g, (i + 1) * g)``, so the grouping draws nothing. GAE is skipped.

V-trace, per group, time-major ``[T, g]`` (vtrace.py:62-118):

    rho_t = exp(target_lp - behaviour_lp),  v_rho = min(rho_clip, rho),
    c_t = min(1, rho)
    delta_t = v_rho (r_t + gamma nt_t V'_t - V_t)
    (vs - V)_t = delta_t + gamma nt_t nd_t c_t (vs - V)_{t+1}
    pg_adv_t = min(pg_rho_clip, rho) (r_t + gamma nt_t vs'_t - V_t)

with ``nt`` not a true terminal, ``nd`` not done, ``V'`` the pre-reset
bootstrap value stored by the rollout, and ``vs'`` the next step's ``vs``
within an episode, ``V'`` at an episode's end and at the unroll's end.
``vs`` and ``pg_adv`` carry no gradient. After each step the observation
normalizer moves and the particle head may resample.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..networks.resample import maybe_resample
from .ppo import PPO, PPOConfig, PPOState

GROUP_KEYS = ("obs", "action", "log_prob", "reward", "next_value", "terminated", "done")


@dataclasses.dataclass(frozen=True)
class VTraceConfig:
    num_envs: int = 32                # reference: 32 IMPALA actors
    unroll_length: int = 64
    queue_batch: int = 4              # learner dequeue size
    rho_clip: float = 1.0
    pg_rho_clip: float = 1.0
    lr_actor: float = 1e-4
    lr_critic: float = 1e-4
    norm_clip: Optional[float] = 0.5


class VTrace(PPO):
    # a sharded run computes every group's step on every rank
    SPLIT_UPDATE = False

    def __init__(self, env, net, cfg: VTraceConfig = VTraceConfig()):
        super().__init__(env, net, PPOConfig(
            num_envs=cfg.num_envs, unroll_length=cfg.unroll_length,
            minibatch_size=cfg.queue_batch * cfg.unroll_length, opt_epochs=1,
            lr_actor=cfg.lr_actor, lr_critic=cfg.lr_critic, norm_clip=cfg.norm_clip))
        self.vcfg = cfg

    def _vtrace_loss(self, batch: Dict[str, torch.Tensor]):
        """(loss, metrics) of one group of env streams, ``[T, g, ...]``
        (vtrace.py:62)."""
        net, ncfg, vcfg = self.net, self.net.cfg, self.vcfg
        t, g = batch["reward"].shape
        obs = batch["obs"].reshape((t * g,) + batch["obs"].shape[2:])
        act = batch["action"].reshape((t * g,) + batch["action"].shape[2:])
        target_lp = net.log_prob(obs, act).reshape(t, g)
        values = net.value(obs).reshape(t, g)

        rho = torch.exp(target_lp - batch["log_prob"])
        nt = 1.0 - batch["terminated"].to(values.dtype)
        nd = 1.0 - batch["done"].to(values.dtype)
        gamma, v_next = ncfg.gamma, batch["next_value"]
        with torch.no_grad():
            delta = torch.clamp(rho, max=vcfg.rho_clip) * (
                batch["reward"] + gamma * nt * v_next - values)
            coef = gamma * nt * nd * torch.clamp(rho, max=1.0)
            vs = torch.empty_like(delta)
            carry = torch.zeros_like(delta[0])
            for i in range(t - 1, -1, -1):
                carry = delta[i] + coef[i] * carry
                vs[i] = carry
            vs += values
            # vs_{t+1} within an episode, the bootstrap at its end
            vs_next = torch.cat([vs[1:], v_next[-1:]], 0)
            vs_next = torch.where(batch["done"], v_next, vs_next)
            pg_adv = torch.clamp(rho, max=vcfg.pg_rho_clip) * (
                batch["reward"] + gamma * nt * vs_next - values)

        policy_loss = -torch.mean(target_lp * pg_adv)
        value_loss = torch.mean((values - vs) ** 2)
        entropy = torch.zeros((), device=values.device)
        if ncfg.entropy_beta:
            entropy = torch.mean(net.entropy(obs))
            policy_loss = policy_loss - ncfg.entropy_beta * entropy
        loss = policy_loss + ncfg.value_loss_coef * value_loss
        return loss, {"policy_loss": policy_loss.detach(),
                      "value_loss": value_loss.detach(), "entropy": entropy.detach()}

    def update(self, state: PPOState, traj: Dict[str, torch.Tensor]):
        """One gradient step per group of ``queue_batch`` env streams, in
        the envs' order (vtrace.py:120). Returns (state, metrics averaged
        over the groups, as device scalars)."""
        net, ncfg = self.net, self.net.cfg
        g = self.vcfg.queue_batch
        n_groups = self.cfg.num_envs // g
        gstep, stats = state.global_step, state.head_stats
        per_step = []
        for i in range(n_groups):
            batch = {k: traj[k][:, i * g:(i + 1) * g] for k in GROUP_KEYS}
            self.opt.zero_grad()
            loss, metrics = self._vtrace_loss(batch)
            loss.backward()
            self.opt.step()
            gstep += 1
            if ncfg.normalize_state:
                obs = batch["obs"]
                net.norm.update_moving_average(obs.reshape((-1,) + obs.shape[2:]), gstep)
            if net.is_pfpn and ncfg.head.resample:
                stats = maybe_resample(ncfg.head, net.head, stats, state.generator)
            metrics["loss"] = loss.detach()
            per_step.append(metrics)
        metrics = {k: torch.stack([m[k] for m in per_step]).mean() for k in per_step[0]}
        return state.replace(head_stats=stats, global_step=gstep), metrics
