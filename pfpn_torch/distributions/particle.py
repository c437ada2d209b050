"""Particle-filtering policy distribution (the PFPN head).

Counterpart of ``pfpn_tpu/distributions/particle.py``: per action dimension
a categorical over N particles (weights from the logit layer) mixed with
per-particle Gaussians whose means/stds are free variables. Ported here:
:func:`component_log_pdf`, :func:`log_prob` (in log space, with the
non-finite-cotangent scrub of ``particle.py:41-78`` as a
``torch.autograd.Function``), :func:`entropy` (``:81-88``), the
non-reparameterized PPO draw :func:`sample` (``:94-108``; split into
:func:`sample_indices`, the random draws, and :func:`sample_from`, the
deterministic rest, so a test can feed the draws), :func:`mode` and
:func:`probs`. The tanh-squashed (SAC) paths come with the SAC slice.

Shapes: logits [..., D, N]; loc/scale [D, N]; actions [..., D].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import categorical

_LOG_2PI = math.log(2.0 * math.pi)


class _SanitizeGrad(torch.autograd.Function):
    """Identity forward; backward zeroes non-finite cotangents. Particle
    movement can push the target's density to 0 (log-prob -> -inf); the
    reference zeroes these gradients (particle.py:41-58)."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def component_log_pdf(loc: torch.Tensor, scale: torch.Tensor,
                      value: torch.Tensor) -> torch.Tensor:
    """[..., D] value against [D, N] particles -> [..., D, N]."""
    z = (value[..., None] - loc) / scale
    return -0.5 * (z * z + _LOG_2PI) - torch.log(scale)


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim as ``jax.nn.logsumexp`` forms it, so its
    gradient is exp(x - max) / sum. ``torch.logsumexp``'s backward forms
    exp(x - result) instead, and with components near -300 (an action many
    stds from every particle) the rounding of the result costs 3e-5 of
    every mixture weight's gradient."""
    m = torch.amax(x, dim=-1, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return (torch.log(torch.sum(torch.exp(x - m), dim=-1, keepdim=True)) + m)[..., 0]


def log_prob(logits: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor,
             value: torch.Tensor) -> torch.Tensor:
    """Summed mixture log-prob [...] of actions [..., D] (particle.py:67)."""
    lw = torch.log_softmax(logits, dim=-1)
    lp = _logsumexp(lw + component_log_pdf(loc, scale, value))
    return torch.sum(_SanitizeGrad.apply(lp), dim=-1)


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """Per-dimension particle-weight entropy [..., D] (particle.py:81)."""
    return categorical.entropy(logits)


def sample_indices(logits: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """Particle choice per dimension, [..., D] int64, drawn from the
    categorical of ``logits`` by the Gumbel-max trick."""
    return categorical.sample(logits, generator)


def sample_from(loc: torch.Tensor, scale: torch.Tensor, idx: torch.Tensor,
                eps: torch.Tensor) -> torch.Tensor:
    """Action [..., D] = loc + scale * eps of the chosen particles."""
    full = idx.shape + loc.shape[-1:]
    mu = torch.gather(loc.expand(full), -1, idx[..., None])[..., 0]
    sd = torch.gather(scale.expand(full), -1, idx[..., None])[..., 0]
    return mu + sd * eps


def sample(logits: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor,
           generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-reparameterized draw (PPO path, particle.py:94). Returns
    (action [..., D], particle index [..., D])."""
    idx = sample_indices(logits, generator)
    eps = torch.randn(idx.shape, generator=generator, device=logits.device)
    return sample_from(loc, scale, idx, eps), idx


def mode(logits: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """Deterministic action: the mean of each dimension's heaviest particle
    (particle.py:179; forward only)."""
    idx = torch.argmax(logits, dim=-1, keepdim=True)
    return torch.gather(loc.expand(logits.shape), -1, idx)[..., 0]


def probs(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits, dim=-1)
