"""The particle-filtering policy head, acting side.

Counterpart of ``ParticleHead``, ``_particle_loc_scale`` and
``deterministic_action`` in ``pfpn_tpu/networks/heads.py`` (:56, :159,
:289): a logit layer reshaped to [..., D, N] over free particle means and
log-stds [D, N]. The Gaussian and categorical heads, sampling, scoring and
the resampling statistics come with later slices.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..distributions import particle as pfp


@dataclasses.dataclass(frozen=True)
class ParticleHead:
    """The fields acting needs; initialization, resampling and the
    tanh-squashed (SAC) variant come with later slices."""

    action_dim: int
    particles: int = 35
    fixed_sigma: bool = False


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

    def deterministic_action(self, feat: torch.Tensor) -> torch.Tensor:
        """heads.py:289: the particle mode."""
        logits, loc, _ = self.dist(feat)
        return pfp.mode(logits, loc)
