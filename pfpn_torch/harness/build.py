"""Construct env, network and algorithm from a RunConfig.

Counterpart of ``pfpn_tpu/harness/build.py``: PPO, A2C (the A3C presets)
and V-trace (the IMPALA presets) on the feed-forward actor-critic with any
of the three heads; with ``NetworkSettings.lstm``, the recurrent
actor-critic (``networks/recurrent_ac.py``), which ``algo="ppo"`` trains
with :class:`~pfpn_torch.algos.recurrent.RecurrentPPO`; and SAC and DDPG
with the tanh-squashed particle or Gaussian head on the env's bounds. The
discrete presets' env is wrapped in
:class:`~pfpn_torch.envs.wrappers.DiscreteActionWrapper`. Value
normalization is accepted only where it is carried (the feed-forward PPO
and A2C paths), as the JAX package decides (``build.py:95-106``).
"""

from __future__ import annotations

from typing import Union

import numpy as np

from .. import resolve_device
from ..algos.a2c import A2C
from ..algos.ppo import PPO, PPOConfig
from ..algos.recurrent import RecurrentPPO
from ..algos.sac import SAC, SACConfig, SACNet
from ..algos.vtrace import VTrace, VTraceConfig
from ..envs.deepmimic import make
from ..envs.wrappers import DiscreteActionWrapper
from ..networks.actor_critic import ACConfig, ActorCritic
from ..networks.heads import CategoricalHead, GaussianHead, HeadConfig, ParticleHead
from ..networks.recurrent_ac import RecurrentACConfig, RecurrentActorCritic
from .config import RunConfig


def build_env(cfg: RunConfig, device=None):
    env = make(cfg.env, device=resolve_device(device))
    if cfg.head.kind == "discrete":
        env = DiscreteActionWrapper(env, cfg.head.particles)
    return env


def build_head(cfg: RunConfig, env) -> HeadConfig:
    """The preset's head (build.py:25-52), tanh-squashed onto the env's
    bounds for SAC and DDPG."""
    h = cfg.head
    squash = cfg.algo in ("sac", "ddpg")
    bounds = {}
    if squash:
        bounds = dict(action_low=np.asarray(env.action_low),
                      action_high=np.asarray(env.action_high))
    if h.kind == "particle":
        return ParticleHead(
            action_dim=env.action_size, particles=h.particles, init_sigma=h.init_sigma,
            fixed_sigma=h.fixed_sigma, squash=squash, resample=h.resample,
            resample_interval=h.resample_interval,
            resample_threshold=h.resample_threshold, **bounds)
    if h.kind == "gaussian":
        return GaussianHead(action_dim=env.action_size, init_sigma=h.init_sigma,
                            fixed_sigma=h.fixed_sigma, squash=squash, **bounds)
    if h.kind == "discrete":
        return CategoricalHead(action_dim=env.action_size, bins=h.particles)
    raise ValueError(h.kind)


def build_net(cfg: RunConfig, env) -> ActorCritic:
    """The preset's network (build.py:55): the recurrent one with
    ``lstm`` (which takes no common trunk and no value normalization, as in
    the JAX package), SAC's and DDPG's with twin critics in place of the
    value MLP."""
    n = cfg.network
    shared = dict(
        obs_dim=env.observation_size, head=build_head(cfg, env),
        actor_shape=n.actor_shape, critic_shape=n.critic_shape,
        normalize_state=n.normalize_state, clip_state=n.clip_state,
        value_loss_coef=n.value_loss_coef, entropy_beta=n.entropy_beta,
        normalize_advantage=n.normalize_advantage, clip_advantage=n.clip_advantage,
        gamma=n.gamma, lambd=n.lambd)
    if n.lstm:
        return RecurrentActorCritic(RecurrentACConfig(lstm_hidden=n.lstm, **shared))
    ac = ACConfig(common_shape=n.common_shape, normalize_value=n.normalize_value,
                  clip_value=n.clip_value, **shared)
    if cfg.algo in ("sac", "ddpg"):
        return SACNet(ac, cfg.algo)
    return ActorCritic(ac)


def build_algo(cfg: RunConfig, device=None) -> Union[PPO, SAC]:
    """The preset's env, network (on the env's device) and algorithm, with
    its optimizer (build.py:93)."""
    if cfg.algo not in ("ppo", "a2c", "vtrace", "sac", "ddpg"):
        raise ValueError(cfg.algo)
    env = build_env(cfg, device)
    net = build_net(cfg, env).to(env.device)
    # build.py:95-106: value normalization is carried only by the
    # feed-forward PPO and A2C paths; elsewhere it would be ignored while
    # clip_value still applied
    if cfg.network.normalize_value and (
            cfg.algo not in ("ppo", "a2c") or cfg.network.lstm):
        raise ValueError(
            "normalize_value=True is only supported for the feed-forward "
            f"ppo/a2c paths, not algo={cfg.algo!r}"
            f"{' with lstm' if cfg.network.lstm else ''}")
    w = cfg.worker
    if cfg.algo in ("sac", "ddpg"):
        # batch_size stays the preset's 256 under --env_multiplier; the
        # multiplier scales updates_per_step, keeping one gradient step per
        # sample (build.py:151-166)
        return SAC(env, net, SACConfig(
            algo=cfg.algo, num_envs=cfg.num_envs, batch_size=w.batch_size,
            updates_per_step=cfg.num_envs, buffer_capacity=w.buffer_capacity,
            warmup=w.observations, lr_actor=w.lr_actor,
            lr_critic=w.lr_critic, norm_clip=w.norm_clip))
    if cfg.algo == "vtrace":
        return VTrace(env, net, VTraceConfig(
            num_envs=cfg.num_envs, unroll_length=w.unroll_length, queue_batch=w.batch_size,
            lr_actor=w.lr_actor, lr_critic=w.lr_critic, norm_clip=w.norm_clip))
    ppo_cfg = PPOConfig(
        num_envs=cfg.num_envs, unroll_length=w.unroll_length,
        minibatch_size=cfg.minibatch_size, opt_epochs=w.opt_epochs or 1,
        lr_actor=w.lr_actor, lr_critic=w.lr_critic, norm_clip=w.norm_clip)
    if cfg.algo == "a2c":
        return A2C(env, net, ppo_cfg)
    if cfg.network.lstm:
        return RecurrentPPO(env, net, ppo_cfg)
    return PPO(env, net, ppo_cfg)
