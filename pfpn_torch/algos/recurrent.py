"""Recurrent PPO: clip-PPO over the LSTM actor-critic with a carried state.

Counterpart of ``pfpn_tpu/algos/recurrent.py``, the reference's episodic
training with an LSTM:

* the carry is part of the training state (``PPOState.carry``), threaded
  through the rollout and zeroed where an episode ends; the bootstrap value
  of the pre-reset observation is taken with the step's new carry, before
  that zeroing; the rollout stores the unroll's first carry as
  ``traj["carry0"]``;
* the update runs GAE, then recomputes the log-probs and values over whole
  unrolls from the stored first carry, zeroing it after each recorded
  episode end (``reset_before = [0, done[:-1]]``);
* a minibatch is a group of ``seq_batch = max(1, minibatch_size //
  unroll_length)`` env streams, drawn by a permutation per epoch; the
  observation normalizer moves in the first epoch only;
* evaluation carries the carry through the episode.

Value normalization is refused, as the JAX package refuses it here.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..distributed import mesh as mesh_mod
from ..networks.heads import update_activation_stats
from ..networks.recurrent import LSTMState
from ..networks.recurrent_ac import RecurrentActorCritic
from ..networks.resample import maybe_resample
from .gae import gae
from .ppo import PPO, PPOConfig, PPOState, TRAJ_KEYS


class RecurrentPPO(PPO):
    """A minibatch is ``seq_batch = max(1, minibatch_size // unroll_length)``
    whole env streams; set ``minibatch_size`` for another grouping. A
    sharded run computes the whole update on every rank."""

    SPLIT_UPDATE = False

    def __init__(self, env, net: RecurrentActorCritic, cfg: PPOConfig = PPOConfig()):
        if not isinstance(net, RecurrentActorCritic):
            raise TypeError("RecurrentPPO needs a RecurrentActorCritic")
        if net.cfg.normalize_value:
            raise ValueError("normalize_value not supported on the recurrent path")
        super().__init__(env, net, cfg)
        self.seq_batch = max(1, cfg.minibatch_size // cfg.unroll_length)

    def init_state(self, generator: torch.Generator) -> PPOState:
        state = super().init_state(generator)
        return state.replace(carry=self.net.zero_carry(self.cfg.num_envs))

    @torch.no_grad()
    def rollout(self, state: PPOState):
        """PPO's rollout with the carry threaded through (recurrent.py:55)."""
        net, env, cfg = self.net, self.env, self.cfg
        env_state, stats = state.env_state, state.head_stats
        obs, ep_ret, last_ret, carry0 = mesh_mod.to_global(
            self.mesh, state.obs, state.ep_return, state.last_ep_return, state.carry)
        carry = carry0
        steps: Dict[str, List[torch.Tensor]] = {k: [] for k in TRAJ_KEYS}
        for _ in range(cfg.unroll_length):
            a, lp, v, aux, carry = net.act(obs, state.generator, carry)
            if net.is_pfpn:
                stats = update_activation_stats(stats, aux["probs"])
            env_state, next_obs, res = env.step_autoreset(
                env_state, self._clip_action(a), state.generator)
            # the pre-reset observation's value, with the carry that would read it
            v_next, _ = net.value_step(res.obs, carry)
            keep = (~res.done).to(carry.h.dtype)[:, None]
            carry = LSTMState(c=carry.c * keep, h=carry.h * keep)
            ep_ret = ep_ret + res.reward
            last_ret = torch.where(res.done, ep_ret, last_ret)
            ep_ret = torch.where(res.done, torch.zeros_like(ep_ret), ep_ret)
            for k, x in zip(TRAJ_KEYS, (obs, a, lp, v, res.reward, v_next,
                                        res.terminated, res.done)):
                steps[k].append(x)
            obs = next_obs
        traj: Dict[str, Any] = {k: torch.stack(v) for k, v in steps.items()}
        traj["carry0"] = carry0
        obs, ep_ret, last_ret, carry = mesh_mod.to_local(
            self.mesh, obs, ep_ret, last_ret, carry)
        state = state.replace(
            env_state=env_state, obs=obs, head_stats=stats, ep_return=ep_ret,
            last_ep_return=last_ret, carry=carry,
            total_samples=state.total_samples + cfg.unroll_length * cfg.num_envs)
        return state, traj

    def _loss_seq(self, batch: Dict[str, torch.Tensor], carry0: LSTMState):
        """(loss, metrics) of a group of env streams, ``[T, g, ...]``
        (recurrent.py:101): PPO's objective on the recomputed sequence."""
        lp, v, ent = self.net.sequence_outputs(batch["obs"], batch["action"], carry0,
                                               batch["reset_before"],
                                               want_entropy=bool(self.net.cfg.entropy_beta))
        return self._objective(batch, lp, v, batch["value"] + batch["advantage"], ent)

    def update(self, state: PPOState, traj: Dict[str, Any]):
        """GAE, then ``opt_epochs`` passes over permuted groups of env
        streams, each recomputed from its stored first carry
        (recurrent.py:134). Returns (state, metrics averaged over the
        minibatches, as device scalars)."""
        net, cfg, ncfg = self.net, self.cfg, self.net.cfg
        carry0 = traj["carry0"]
        adv = gae(traj["reward"], traj["value"], traj["next_value"],
                  traj["terminated"], traj["done"], ncfg.gamma, ncfg.lambd)
        done = traj["done"]
        seq = {k: traj[k] for k in ("obs", "action", "log_prob", "value")}
        seq["advantage"] = adv
        seq["reset_before"] = torch.cat([torch.zeros_like(done[:1]), done[:-1]], 0)
        b = done.shape[1]
        n_mb = max(1, b // self.seq_batch)
        g = b // n_mb
        gstep, stats = state.global_step, state.head_stats
        per_mb = []
        for epoch in range(cfg.opt_epochs):
            perm = torch.randperm(b, generator=state.generator, device=adv.device)
            for i in range(n_mb):
                idx = perm[i * g:(i + 1) * g]
                batch = {k: v[:, idx] for k, v in seq.items()}
                self.opt.zero_grad()
                loss, metrics = self._loss_seq(batch, LSTMState(c=carry0.c[idx],
                                                                h=carry0.h[idx]))
                loss.backward()
                self.opt.step()
                gstep += 1
                if ncfg.normalize_state and epoch == 0:
                    obs = batch["obs"]
                    net.norm.update_moving_average(obs.reshape((-1,) + obs.shape[2:]), gstep)
                if net.is_pfpn and ncfg.head.resample:
                    stats = maybe_resample(ncfg.head, net.head, stats, state.generator)
                metrics["loss"] = loss.detach()
                per_mb.append(metrics)
        metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}
        return state.replace(head_stats=stats, global_step=gstep), metrics

    # evaluation carries the carry through the episode (recurrent.py:211)
    def _eval_carry(self, num_episodes: int) -> LSTMState:
        return self.net.zero_carry(num_episodes)

    def _eval_act(self, obs: torch.Tensor, carry: LSTMState):
        return self.net.act_deterministic(obs, carry)
