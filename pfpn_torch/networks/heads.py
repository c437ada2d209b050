"""Policy heads: Gaussian, factored-categorical and particle-filtering.

Counterpart of ``pfpn_tpu/networks/heads.py``. Each head is a frozen config dataclass and an ``nn.Module`` holding
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

The Gaussian and particle heads tanh-squash when ``squash`` is set (SAC
and DDPG): actions are drawn or picked in (-1, 1) and mapped onto the
env's bounds ``action_low`` .. ``action_high`` (:func:`denormalize_action`,
``heads.py:204-220``); the squashed particle grid is the midpoints
-1 + (2 / N)(i + 1/2) in atanh space (``heads.py:97-128``). A squashed draw
takes its noise from :meth:`draw` (a dict of tensors), so that a test can
feed the JAX package's draws to ``sample_with_log_prob``.
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
from ..sim.dynamics import const
from .mlp import init_linear_


@dataclasses.dataclass(frozen=True)
class GaussianHead:
    action_dim: int
    init_sigma: Optional[float] = None
    fixed_sigma: bool = False
    variabilize_sigma: bool = False
    max_sigma: Optional[float] = None
    sigma_eps: float = 2e-9
    squash: bool = False
    # the env's bounds, for the squashed head's (de)normalization
    action_low: Optional[np.ndarray] = None
    action_high: Optional[np.ndarray] = None


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
    squash: bool = False            # tanh-squash after the mixture (SAC, DDPG)
    resample: int = -1
    resample_interval: int = 2000
    resample_threshold: Optional[float] = None
    action_low: Optional[np.ndarray] = None
    action_high: Optional[np.ndarray] = None


def particle_init_tables(cfg: ParticleHead):
    """(loc, log_std) [D, N] float32 of the particle grid (heads.py:95-141),
    computed in float64 as the JAX package does. Unsquashed: endpoints
    linspace(-1, 1, N), std 2 / (N - 1) or ``init_sigma``. Squashed: the
    midpoints -1 + (2 / N)(i + 1/2) taken to atanh space, std the distance
    to the farther neighbour there, or with ``init_sigma`` the atanh of the
    interval loc +- init_sigma (clipped to +-(1 - 1e-6)), its larger side."""
    d, n = cfg.action_dim, cfg.particles
    u, l = 1.0, -1.0
    if not cfg.squash:
        loc = np.broadcast_to(l + (u - l) / (n - 1) * np.arange(n), (d, n))
        std = np.full((d, n), float(cfg.init_sigma) if cfg.init_sigma else (u - l) / (n - 1))
        return loc.astype(np.float32), np.log(std).astype(np.float32)
    loc_t = np.broadcast_to(l + (u - l) / n * (np.arange(n) + 0.5), (d, n))
    loc = np.arctanh(loc_t)
    if cfg.init_sigma:
        sigma = float(cfg.init_sigma)
        std = np.maximum(loc - np.arctanh(np.maximum(1e-6 - 1, loc_t - sigma)),
                         np.arctanh(np.minimum(1 - 1e-6, loc_t + sigma)) - loc)
    else:
        assert n > 3
        gaps = np.diff(loc, axis=1)
        std = np.maximum(np.concatenate([gaps[:, :1], gaps], 1),
                         np.concatenate([gaps, gaps[:, -1:]], 1))
    return loc.astype(np.float32), np.log(std).astype(np.float32)


def _bounds(cfg, a: torch.Tensor):
    """(scale, offset) of the env's bounds, as fp32 tensors on ``a``'s
    device (cached: no copy per call), or None when the head does not squash
    or has no bounds (heads.py:204-220)."""
    if not getattr(cfg, "squash", False) or cfg.action_low is None:
        return None
    high, low = np.asarray(cfg.action_high), np.asarray(cfg.action_low)
    return const(0.5 * (high - low), a), const(0.5 * (high + low), a)


def denormalize_action(cfg, a: torch.Tensor) -> torch.Tensor:
    """A squashed action in (-1, 1) on the env's bounds."""
    b = _bounds(cfg, a)
    return a if b is None else a * b[0] + b[1]


def normalize_action(cfg, a: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`denormalize_action`."""
    b = _bounds(cfg, a)
    return a if b is None else (a - b[1]) / b[0]


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

    def draw(self, batch_shape, generator: Optional[torch.Generator]) -> Dict:
        """The noise of a squashed draw for features of ``batch_shape``."""
        shape = tuple(batch_shape) + (self.cfg.action_dim, self.cfg.particles)
        gumbel, eps = pfp.rsample_squashed_draws(shape, generator, self.particles.device)
        return {"gumbel": gumbel, "eps": eps}

    def sample_with_log_prob(self, feat: torch.Tensor,
                             generator: Optional[torch.Generator],
                             draws: Optional[Dict] = None):
        """(action, log_prob, aux) of a draw (heads.py:224); aux carries the
        particle weights for the activation statistics, and for the squashed
        head the pre-tanh value. The squashed draw is reparameterized, its
        noise ``draws`` or :meth:`draw`'s; the action is on the env's bounds
        and its log-prob that of the action in (-1, 1)."""
        logits, loc, scale = self.dist(feat)
        aux = {"probs": pfp.probs(logits)}
        if self.cfg.squash:
            draws = draws if draws is not None else self.draw(feat.shape[:-1], generator)
            a_t, pre = pfp.rsample_squashed_from(logits, loc, scale, draws["gumbel"],
                                                 draws["eps"])
            lp = pfp.log_prob(logits, loc, scale, a_t, squash=True, pre_tanh=pre)
            return denormalize_action(self.cfg, a_t), lp, {"pre_tanh": pre, **aux}
        a, _ = pfp.sample(logits, loc, scale, generator)
        return a, pfp.log_prob(logits, loc, scale, a), aux

    def log_prob_of(self, feat: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        logits, loc, scale = self.dist(feat)
        if self.cfg.squash:
            return pfp.log_prob(logits, loc, scale, normalize_action(self.cfg, action),
                                squash=True)
        return pfp.log_prob(logits, loc, scale, action)

    def entropy_of(self, feat: torch.Tensor) -> torch.Tensor:
        return torch.sum(pfp.entropy(self.dist(feat)[0]), dim=-1)

    def deterministic_action(self, feat: torch.Tensor) -> torch.Tensor:
        """heads.py:283: the particle mode; squashed, on the env's bounds."""
        logits, loc, _ = self.dist(feat)
        if self.cfg.squash:
            return denormalize_action(self.cfg, pfp.mode(logits, loc, squash=True))
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

    def draw(self, batch_shape, generator: Optional[torch.Generator]) -> Dict:
        """The noise of a draw for features of ``batch_shape``."""
        shape = tuple(batch_shape) + (self.cfg.action_dim,)
        return {"eps": torch.randn(shape, generator=generator,
                                   device=self.fc_mu.weight.device)}

    def sample_with_log_prob(self, feat: torch.Tensor,
                             generator: Optional[torch.Generator],
                             draws: Optional[Dict] = None):
        """(action, log_prob, {}) of a reparameterized draw mu + sigma eps,
        its noise ``draws`` or :meth:`draw`'s; squashed, the action is
        tanh of it on the env's bounds (heads.py:224-231)."""
        mu, sigma = self.dist(feat)
        draws = draws if draws is not None else self.draw(feat.shape[:-1], generator)
        x = mu + sigma * draws["eps"]
        if self.cfg.squash:
            return (denormalize_action(self.cfg, torch.tanh(x)),
                    gauss.log_prob_squashed(mu, sigma, x), {})
        return x, gauss.log_prob(mu, sigma, x), {}

    def log_prob_of(self, feat: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        mu, sigma = self.dist(feat)
        if self.cfg.squash:
            pre = gauss.atanh_safe(normalize_action(self.cfg, action))
            return gauss.log_prob_squashed(mu, sigma, pre)
        return gauss.log_prob(mu, sigma, action)

    def entropy_of(self, feat: torch.Tensor) -> torch.Tensor:
        return gauss.entropy(self.dist(feat)[1])

    def deterministic_action(self, feat: torch.Tensor) -> torch.Tensor:
        mu = self.dist(feat)[0]
        return denormalize_action(self.cfg, torch.tanh(mu)) if self.cfg.squash else mu


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
