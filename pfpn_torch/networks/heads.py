"""The particle-filtering policy head.

Counterpart of the particle branches of ``pfpn_tpu/networks/heads.py``:
the :class:`ParticleHead` config (``heads.py:56``); its parameters, a logit
layer reshaped to [..., D, N] over free particle means and log-stds [D, N],
with the non-squashed initialization of ``init_head`` (``heads.py:95-141``:
endpoints ``linspace(-1, 1, N)``, std 2 / (N - 1) or ``init_sigma``);
``_particle_loc_scale``, ``head_dist``, ``sample_with_log_prob``,
``log_prob_of``, ``entropy_of`` and ``deterministic_action``; and the
resampling statistics (:func:`init_activation_stats`,
:func:`update_activation_stats`, ``heads.py:144``, ``:305``). The Gaussian
and categorical heads and the tanh-squashed (SAC) particle head come with
later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..distributions import particle as pfp
from .mlp import init_linear_


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
