"""Policy heads: Gaussian, factored-categorical and particle-filtering.

Counterpart of ``pfpn_tpu/networks/heads.py`` for the DPPO (unsquashed)
heads. Each head is a frozen config dataclass and an ``nn.Module`` holding
its parameters, with the JAX package's ``init_head``, ``head_dist``,
``sample_with_log_prob``, ``log_prob_of``, ``entropy_of`` and
``deterministic_action`` as methods:

* :class:`GaussianHead` (``heads.py:36``): ``fc_mu`` and a state-dependent
  log-sigma layer (zero weights and a bias of log ``init_sigma`` when that
  is set), or a trainable ``log_sigma`` row (``variabilize_sigma``), or a
  fixed sigma; ``max_sigma`` bounds sigma through a tanh;
* :class:`CategoricalHead` (``heads.py:48``): one logit layer reshaped to
  [..., D, bins];
* :class:`ParticleHead` (``heads.py:56``): a logit layer reshaped to
  [..., D, N] over free particle means and log-stds [D, N], with the
  non-squashed grid (``heads.py:95-141``: endpoints ``linspace(-1, 1, N)``,
  std 2 / (N - 1) or ``init_sigma``), and the resampling statistics
  (:func:`init_activation_stats`, :func:`update_activation_stats`,
  ``heads.py:144``, ``:305``).

The tanh-squashed heads (SAC, DDPG) come with their algorithms.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..distributions import categorical as cat
from ..distributions import gaussian as gauss
from ..distributions import particle as pfp
from .mlp import init_linear_


@dataclasses.dataclass(frozen=True)
class GaussianHead:
    action_dim: int
    init_sigma: Optional[float] = None
    fixed_sigma: bool = False
    variabilize_sigma: bool = False
    max_sigma: Optional[float] = None
    sigma_eps: float = 2e-9


@dataclasses.dataclass(frozen=True)
class CategoricalHead:
    action_dim: int   # number of action dimensions
    bins: int         # values per dimension (DiscreteActionWrapper's n)


@dataclasses.dataclass(frozen=True)
class ParticleHead:
    action_dim: int
    particles: int = 35
    init_sigma: Optional[float] = None
    fixed_sigma: bool = False
    resample: int = -1
    resample_interval: int = 2000
    resample_threshold: Optional[float] = None


def particle_init_tables(cfg: ParticleHead):
    """(loc, log_std) [D, N] float32 of the non-squashed grid
    (heads.py:111-141), computed in float64 as the JAX package does."""
    d, n = cfg.action_dim, cfg.particles
    u, l = 1.0, -1.0
    loc = np.broadcast_to(l + (u - l) / (n - 1) * np.arange(n), (d, n))
    if cfg.init_sigma:
        std = np.full((d, n), float(cfg.init_sigma))
    else:
        std = np.full((d, n), (u - l) / (n - 1))
    return loc.astype(np.float32), np.log(std).astype(np.float32)


class ParticleHeadModule(nn.Module):
    """Parameters of a :class:`ParticleHead` on features of width ``feat_dim``."""

    def __init__(self, cfg: ParticleHead, feat_dim: int):
        super().__init__()
        self.cfg = cfg
        d, n = cfg.action_dim, cfg.particles
        self.fc_policy = nn.Linear(feat_dim, d * n)
        self.particles = nn.Parameter(torch.zeros(d, n))
        log_std = torch.zeros(d, n)
        if cfg.fixed_sigma:
            self.register_buffer("particles_log_std_fixed", log_std)
        else:
            self.particles_log_std = nn.Parameter(log_std)

    @torch.no_grad()
    def init_parameters(self, generator: Optional[torch.Generator]) -> None:
        """init_head's particle branch (heads.py:95): truncated-normal logit
        weights, zero biases, the particle grid."""
        init_linear_(self.fc_policy, generator)
        loc, log_std = particle_init_tables(self.cfg)
        self.particles.copy_(torch.from_numpy(loc))
        self.log_std_tensor().copy_(torch.from_numpy(log_std))

    def log_std_tensor(self) -> torch.Tensor:
        """The stored log-stds: a parameter, or a buffer when fixed."""
        return (self.particles_log_std_fixed if self.cfg.fixed_sigma
                else self.particles_log_std)

    def loc_scale(self):
        """(loc, scale) [D, N] (heads.py:159)."""
        if self.cfg.fixed_sigma:
            return self.particles, torch.exp(self.particles_log_std_fixed)
        return self.particles, torch.exp(torch.clamp(self.particles_log_std, -20.0, 2.0))

    def dist(self, feat: torch.Tensor):
        """(logits [..., D, N], loc, scale)."""
        logits = self.fc_policy(feat)
        logits = logits.reshape(feat.shape[:-1] + (self.cfg.action_dim, self.cfg.particles))
        loc, scale = self.loc_scale()
        return logits, loc, scale

    def sample_with_log_prob(self, feat: torch.Tensor,
                             generator: Optional[torch.Generator]):
        """(action, log_prob, aux) of a draw (heads.py:224); aux carries the
        particle weights for the activation statistics."""
        logits, loc, scale = self.dist(feat)
        a, _ = pfp.sample(logits, loc, scale, generator)
        return a, pfp.log_prob(logits, loc, scale, a), {"probs": pfp.probs(logits)}

    def log_prob_of(self, feat: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        logits, loc, scale = self.dist(feat)
        return pfp.log_prob(logits, loc, scale, action)

    def entropy_of(self, feat: torch.Tensor) -> torch.Tensor:
        return torch.sum(pfp.entropy(self.dist(feat)[0]), dim=-1)

    def deterministic_action(self, feat: torch.Tensor) -> torch.Tensor:
        """heads.py:289: the particle mode."""
        logits, loc, _ = self.dist(feat)
        return pfp.mode(logits, loc)


class GaussianHeadModule(nn.Module):
    """Parameters of a :class:`GaussianHead` on features of width ``feat_dim``."""

    def __init__(self, cfg: GaussianHead, feat_dim: int):
        super().__init__()
        self.cfg = cfg
        self.fc_mu = nn.Linear(feat_dim, cfg.action_dim)
        if not cfg.fixed_sigma:
            if cfg.variabilize_sigma:
                self.log_sigma = nn.Parameter(torch.zeros(1, cfg.action_dim))
            else:
                self.fc_log_sigma = nn.Linear(feat_dim, cfg.action_dim)

    @torch.no_grad()
    def init_parameters(self, generator: Optional[torch.Generator]) -> None:
        """init_head's Gaussian branch (heads.py:74-94)."""
        cfg = self.cfg
        init_linear_(self.fc_mu, generator)
        if cfg.fixed_sigma:
            return
        if cfg.variabilize_sigma:
            self.log_sigma.fill_(float(np.log(cfg.init_sigma)) if cfg.init_sigma else 0.0)
        elif cfg.init_sigma:
            # sigma starts at init_sigma for every state (heads.py:82-88)
            self.fc_log_sigma.weight.zero_()
            self.fc_log_sigma.bias.fill_(float(np.log(cfg.init_sigma)))
        else:
            init_linear_(self.fc_log_sigma, generator)

    def dist(self, feat: torch.Tensor):
        """(mu, sigma) [..., D] (heads.py:170-185)."""
        cfg = self.cfg
        mu = self.fc_mu(feat)
        if cfg.fixed_sigma:
            return mu, torch.full_like(mu, cfg.init_sigma)
        if cfg.variabilize_sigma:
            return mu, torch.exp(self.log_sigma.expand_as(mu)) + cfg.sigma_eps
        log_sigma = self.fc_log_sigma(feat)
        if cfg.max_sigma:
            offset = 0.5 * (np.log(cfg.max_sigma) + np.log(cfg.sigma_eps))
            scale = 0.5 * (np.log(cfg.max_sigma) - np.log(cfg.sigma_eps))
            return mu, torch.exp(torch.tanh(log_sigma) * float(scale) + float(offset))
        return mu, torch.exp(log_sigma) + cfg.sigma_eps

    def sample_with_log_prob(self, feat: torch.Tensor,
                             generator: Optional[torch.Generator]):
        mu, sigma = self.dist(feat)
        x = gauss.sample(mu, sigma, generator)
        return x, gauss.log_prob(mu, sigma, x), {}

    def log_prob_of(self, feat: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        mu, sigma = self.dist(feat)
        return gauss.log_prob(mu, sigma, action)

    def entropy_of(self, feat: torch.Tensor) -> torch.Tensor:
        return gauss.entropy(self.dist(feat)[1])

    def deterministic_action(self, feat: torch.Tensor) -> torch.Tensor:
        return self.dist(feat)[0]


class CategoricalHeadModule(nn.Module):
    """Parameters of a :class:`CategoricalHead`; actions are integer bins."""

    def __init__(self, cfg: CategoricalHead, feat_dim: int):
        super().__init__()
        self.cfg = cfg
        self.fc_policy = nn.Linear(feat_dim, cfg.action_dim * cfg.bins)

    def init_parameters(self, generator: Optional[torch.Generator]) -> None:
        init_linear_(self.fc_policy, generator)

    def dist(self, feat: torch.Tensor):
        """(logits [..., D, bins],)"""
        logits = self.fc_policy(feat)
        return (logits.reshape(feat.shape[:-1] + (self.cfg.action_dim, self.cfg.bins)),)

    def sample_with_log_prob(self, feat: torch.Tensor,
                             generator: Optional[torch.Generator]):
        (logits,) = self.dist(feat)
        a = cat.sample(logits, generator)
        return a, cat.log_prob(logits, a), {}

    def log_prob_of(self, feat: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return cat.log_prob(self.dist(feat)[0], action)

    def entropy_of(self, feat: torch.Tensor) -> torch.Tensor:
        return torch.sum(cat.entropy(self.dist(feat)[0]), dim=-1)

    def deterministic_action(self, feat: torch.Tensor) -> torch.Tensor:
        return cat.mode(self.dist(feat)[0])


HeadConfig = Union[GaussianHead, CategoricalHead, ParticleHead]
_MODULES = {GaussianHead: GaussianHeadModule, CategoricalHead: CategoricalHeadModule,
            ParticleHead: ParticleHeadModule}


def head_module(cfg: HeadConfig, feat_dim: int) -> nn.Module:
    """The module of a head config."""
    return _MODULES[type(cfg)](cfg, feat_dim)


def init_activation_stats(cfg: ParticleHead, device=None) -> Dict:
    """PFPN resampling accumulators (heads.py:144): per-particle max and sum
    of the weights over forward passes, and the optimizer-step counter
    (a Python int here; a float array in JAX)."""
    d, n = cfg.action_dim, cfg.particles
    return {"max_active": torch.zeros(d, n, device=device),
            "sum_active": torch.zeros(d, n, device=device),
            "train_flag": 0}


def update_activation_stats(stats: Dict, probs: torch.Tensor) -> Dict:
    """Fold a forward pass's particle weights [..., D, N] into the
    accumulators, reduced over all batch axes (heads.py:305)."""
    flat = probs.reshape(-1, *probs.shape[-2:])
    return {**stats,
            "max_active": torch.maximum(stats["max_active"], torch.amax(flat, 0)),
            "sum_active": stats["sum_active"] + torch.sum(flat, 0)}
