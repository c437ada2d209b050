"""Construct env, network and algorithm from a RunConfig.

Counterpart of ``pfpn_tpu/harness/build.py`` for what the port has: PPO on
a feed-forward network without value normalization, with any of the three
heads (the DPPO presets), and SAC and DDPG with the tanh-squashed particle
or Gaussian head on the env's bounds; the discrete preset's env is wrapped
in :class:`~pfpn_torch.envs.wrappers.DiscreteActionWrapper`. Other
algorithms, the LSTM trunk and value normalization raise.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from .. import resolve_device
from ..algos.ppo import PPO, PPOConfig
from ..algos.sac import SAC, SACConfig, SACNet
from ..envs.deepmimic import make
from ..envs.wrappers import DiscreteActionWrapper
from ..networks.actor_critic import ACConfig, ActorCritic
from ..networks.heads import CategoricalHead, GaussianHead, HeadConfig, ParticleHead
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
    """The preset's network; SAC's and DDPG's with twin critics in place of
    the value MLP."""
    n = cfg.network
    if n.lstm or n.normalize_value or n.clip_value:
        raise NotImplementedError("the LSTM trunk and value normalization are "
                                  "not ported yet")
    ac = ACConfig(
        obs_dim=env.observation_size, head=build_head(cfg, env),
        common_shape=n.common_shape, actor_shape=n.actor_shape,
        critic_shape=n.critic_shape, normalize_state=n.normalize_state,
        clip_state=n.clip_state, value_loss_coef=n.value_loss_coef,
        entropy_beta=n.entropy_beta, normalize_advantage=n.normalize_advantage,
        clip_advantage=n.clip_advantage, gamma=n.gamma, lambd=n.lambd)
    if cfg.algo in ("sac", "ddpg"):
        return SACNet(ac, cfg.algo)
    return ActorCritic(ac)


def build_algo(cfg: RunConfig, device=None) -> Union[PPO, SAC]:
    """The preset's env, network (on the env's device) and algorithm, with
    its optimizer."""
    if cfg.algo not in ("ppo", "sac", "ddpg"):
        raise NotImplementedError(f"algo {cfg.algo!r} is not ported yet")
    if cfg.network.normalize_value and cfg.algo != "ppo":
        # build.py:101-107: only the feed-forward PPO/A2C paths carry it
        raise ValueError("normalize_value=True is only supported for the feed-forward "
                         f"ppo/a2c paths, not algo={cfg.algo!r}")
    env = build_env(cfg, device)
    net = build_net(cfg, env).to(env.device)
    if cfg.algo in ("sac", "ddpg"):
        # batch_size stays the preset's 256 under --env_multiplier; the
        # multiplier scales updates_per_step, keeping one gradient step per
        # sample (build.py:151-166)
        return SAC(env, net, SACConfig(
            algo=cfg.algo, num_envs=cfg.num_envs, batch_size=cfg.worker.batch_size,
            updates_per_step=cfg.num_envs, buffer_capacity=cfg.worker.buffer_capacity,
            warmup=cfg.worker.observations, lr_actor=cfg.worker.lr_actor,
            lr_critic=cfg.worker.lr_critic, norm_clip=cfg.worker.norm_clip))
    return PPO(env, net, PPOConfig(
        num_envs=cfg.num_envs, unroll_length=cfg.worker.unroll_length,
        minibatch_size=cfg.minibatch_size, opt_epochs=cfg.worker.opt_epochs or 1,
        lr_actor=cfg.worker.lr_actor, lr_critic=cfg.worker.lr_critic,
        norm_clip=cfg.worker.norm_clip))
