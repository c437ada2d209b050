"""Diagonal Gaussian policy distribution, optionally tanh-squashed.

A frozen copy of the port's counterpart of ``pfpn_tpu/distributions/gaussian.py``: the log-density
summed over the action axis, the tanh Jacobian correction in the stable
form 2 (log 2 - x - softplus(-2x)), the squashed log-density, the draw,
the entropy and a clipped atanh. Shapes: mu, sigma, values [..., D].
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.nn import functional as F

_LOG_2PI = math.log(2.0 * math.pi)
LOG2 = math.log(2.0)


def log_prob(mu: torch.Tensor, sigma: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Element-wise Normal log-density, summed over the last axis."""
    z = (value - mu) / sigma
    return torch.sum(-0.5 * (z * z + _LOG_2PI) - torch.log(sigma), dim=-1)


def tanh_correction(pre_tanh: torch.Tensor) -> torch.Tensor:
    """log |d tanh(x) / dx| summed over the action axis."""
    return torch.sum(2.0 * (LOG2 - pre_tanh - F.softplus(-2.0 * pre_tanh)), dim=-1)


def log_prob_squashed(mu: torch.Tensor, sigma: torch.Tensor,
                      pre_tanh: torch.Tensor) -> torch.Tensor:
    return log_prob(mu, sigma, pre_tanh) - tanh_correction(pre_tanh)


def sample(mu: torch.Tensor, sigma: torch.Tensor,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    return mu + sigma * torch.randn(mu.shape, generator=generator, device=mu.device)


def entropy(sigma: torch.Tensor) -> torch.Tensor:
    """Per-dimension entropy, summed over the action axis."""
    return torch.sum(0.5 * (1.0 + _LOG_2PI) + torch.log(sigma), dim=-1)


def atanh_safe(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.atanh(torch.clamp(x, -1.0 + eps, 1.0 - eps))
