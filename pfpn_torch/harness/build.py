"""Construct env, network and algorithm from a RunConfig.

Counterpart of ``pfpn_tpu/harness/build.py`` for what the port has: PPO on
a feed-forward network without value normalization, with any of the three
heads (the DPPO presets); the discrete preset's env is wrapped in
:class:`~pfpn_torch.envs.wrappers.DiscreteActionWrapper`. Other
algorithms, the LSTM trunk and value normalization raise.
"""

from __future__ import annotations

from .. import resolve_device
from ..algos.ppo import PPO, PPOConfig
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
    """The preset's head, unsquashed as PPO uses it (build.py:25-52)."""
    h = cfg.head
    if h.kind == "particle":
        return ParticleHead(
            action_dim=env.action_size, particles=h.particles, init_sigma=h.init_sigma,
            fixed_sigma=h.fixed_sigma, resample=h.resample,
            resample_interval=h.resample_interval,
            resample_threshold=h.resample_threshold)
    if h.kind == "gaussian":
        return GaussianHead(action_dim=env.action_size, init_sigma=h.init_sigma,
                            fixed_sigma=h.fixed_sigma)
    if h.kind == "discrete":
        return CategoricalHead(action_dim=env.action_size, bins=h.particles)
    raise ValueError(h.kind)


def build_net(cfg: RunConfig, env) -> ActorCritic:
    n = cfg.network
    if n.lstm or n.normalize_value or n.clip_value:
        raise NotImplementedError("the LSTM trunk and value normalization are "
                                  "not ported yet")
    return ActorCritic(ACConfig(
        obs_dim=env.observation_size, head=build_head(cfg, env),
        common_shape=n.common_shape, actor_shape=n.actor_shape,
        critic_shape=n.critic_shape, normalize_state=n.normalize_state,
        clip_state=n.clip_state, value_loss_coef=n.value_loss_coef,
        entropy_beta=n.entropy_beta, normalize_advantage=n.normalize_advantage,
        clip_advantage=n.clip_advantage, gamma=n.gamma, lambd=n.lambd))


def build_algo(cfg: RunConfig, device=None) -> PPO:
    """The preset's env, network (on the env's device) and PPO, with its
    optimizer."""
    if cfg.algo != "ppo":
        raise NotImplementedError(f"algo {cfg.algo!r} is not ported yet")
    env = build_env(cfg, device)
    net = build_net(cfg, env).to(env.device)
    return PPO(env, net, PPOConfig(
        num_envs=cfg.num_envs, unroll_length=cfg.worker.unroll_length,
        minibatch_size=cfg.minibatch_size, opt_epochs=cfg.worker.opt_epochs or 1,
        lr_actor=cfg.worker.lr_actor, lr_critic=cfg.worker.lr_critic,
        norm_clip=cfg.worker.norm_clip))
