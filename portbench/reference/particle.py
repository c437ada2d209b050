"""Particle-filtering policy distribution (the PFPN head).

A frozen copy of the port's counterpart of ``pfpn_tpu/distributions/particle.py``: per action dimension
a categorical over N particles (weights from the logit layer) mixed with
per-particle Gaussians whose means/stds are free variables. Ported here:
:func:`component_log_pdf`, :func:`log_prob` (in log space, with the
non-finite-cotangent scrub of ``particle.py:41-78`` as a
``torch.autograd.Function``), :func:`entropy` (``:81-88``), the
non-reparameterized PPO draw :func:`sample` (``:94-108``; split into
:func:`sample_indices`, the random draws, and :func:`sample_from`, the
deterministic rest, so a test can feed the draws), :func:`mode` and
:func:`probs`; and the tanh-squashed paths of SAC and DDPG: the squashed
:func:`log_prob` (``:66-78``), the straight-through picks ``_st_pick`` and
``_st_pick_pre`` (``:112-154``) as ``torch.autograd.Function`` classes with
the JAX package's custom gradients, the reparameterized draw
``rsample_squashed`` (``:157-176``) as its random draws,
:func:`rsample_squashed_draws`, and its deterministic rest,
:func:`rsample_squashed_from`, and the squashed :func:`mode`
(``:179-190``).

Shapes: logits [..., D, N]; loc/scale [D, N]; actions [..., D].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.nn import functional as F

from . import categorical
from .gaussian import LOG2, atanh_safe

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
             value: torch.Tensor, squash: bool = False,
             pre_tanh: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Summed mixture log-prob [...] of actions [..., D] (particle.py:66).
    A squashed head passes the action in (-1, 1), taken back through a
    clipped atanh, or its pre-tanh value ``pre_tanh``; the tanh Jacobian
    2 (log 2 - x - softplus(-2x)) is taken off each dimension."""
    pre = value
    if squash:
        pre = atanh_safe(value) if pre_tanh is None else pre_tanh
    lw = torch.log_softmax(logits, dim=-1)
    lp = _SanitizeGrad.apply(_logsumexp(lw + component_log_pdf(loc, scale, pre)))
    if squash:
        lp = lp - 2.0 * (LOG2 - pre - F.softplus(-2.0 * pre))
    return torch.sum(lp, dim=-1)


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


class _StPick(torch.autograd.Function):
    """Forward: sum_n m p, the picked particle's value. Backward
    (particle.py:112-130): the cotangent g reaches the relaxed weights w as
    (p - picked) g, the particle values as m g, the hard mask not at all."""

    @staticmethod
    def forward(ctx, w, p, m):
        y = torch.sum(m * p, dim=-1)
        ctx.save_for_backward(p, m, y)
        return y

    @staticmethod
    def backward(ctx, g):
        p, m, y = ctx.saved_tensors
        ge = g[..., None]
        return (p - y[..., None]) * ge, m * ge, None


class _StPickPre(torch.autograd.Function):
    """Forward: sum_n m p, the picked pre-tanh value. Backward
    (particle.py:133-154): w's cotangent is the squashed gap
    (tanh_p - tanh_picked) / max(1e-6, 1 - tanh_picked^2) g, p's is m g,
    the mask and tanh_p get none."""

    @staticmethod
    def forward(ctx, w, p, m, tanh_p):
        tanh_t = torch.sum(m * tanh_p, dim=-1)
        ctx.save_for_backward(m, tanh_p, tanh_t)
        return torch.sum(m * p, dim=-1)

    @staticmethod
    def backward(ctx, g):
        m, tanh_p, tanh_t = ctx.saved_tensors
        t = tanh_t[..., None]
        gap = (tanh_p - t) / torch.clamp(1.0 - t * t, min=1e-6)
        ge = g[..., None]
        return gap * ge, m * ge, None, None


def _one_hot(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """One-hot [..., N] of indices [..., 1], like ``like`` (a scatter: no
    range check that would wait on the device)."""
    return torch.zeros_like(like).scatter_(-1, idx, 1.0)


def rsample_squashed_draws(shape, generator: Optional[torch.Generator],
                           device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random draws of the reparameterized squashed draw (SAC path,
    particle.py:157-176) for logits of ``shape`` [..., D, N]: standard
    Gumbel noise and one standard normal per particle."""
    u = torch.rand(shape, generator=generator, device=device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return gumbel, torch.randn(shape, generator=generator, device=device)


def rsample_squashed_from(logits: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor,
                          gumbel: torch.Tensor, eps: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deterministic rest of the squashed draw, given its draws: the
    particle of each dimension chosen by the Gumbel-softmax of the logits
    (temperature 1), its value loc + scale eps, in (-1, 1) and before the
    tanh. Gradients reach the logits through the relaxed one-hot (straight
    through the hard one) and every particle's mean and std through the
    picks."""
    w = torch.softmax(logits + gumbel, dim=-1)
    m = _one_hot(torch.argmax(w, dim=-1, keepdim=True), w)
    m_st = m + (w - w.detach())
    p = loc + scale * eps
    tanh_p = torch.tanh(p)
    pre = _StPickPre.apply(m_st, p, m, tanh_p)
    return _StPick.apply(m_st, tanh_p, m), pre


def mode(logits: torch.Tensor, loc: torch.Tensor, squash: bool = False) -> torch.Tensor:
    """Deterministic action (particle.py:179): the mean of each dimension's
    heaviest particle; squashed, its tanh, picked straight through so that
    DDPG's actor gradient reaches the logits and the particle means."""
    if not squash:
        idx = torch.argmax(logits, dim=-1, keepdim=True)
        return torch.gather(loc.expand(logits.shape), -1, idx)[..., 0]
    w = torch.softmax(logits, dim=-1)
    m = _one_hot(torch.argmax(w, dim=-1, keepdim=True), w)
    return _StPick.apply(w, torch.tanh(loc).expand(logits.shape), m)


def probs(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits, dim=-1)
