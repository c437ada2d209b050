"""Factored categorical distribution over per-dimension logits [..., D, N].

A frozen copy of the port's counterpart of ``pfpn_tpu/distributions/categorical.py``: one categorical
per action dimension; actions are integer [..., D].
"""

from __future__ import annotations

from typing import Optional

import torch


def log_prob(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Summed log-prob [...] of integer actions [..., D]."""
    lp = torch.log_softmax(logits, dim=-1)
    return torch.sum(torch.gather(lp, -1, actions.long()[..., None])[..., 0], dim=-1)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """A draw per dimension, [..., D] int64, by the Gumbel-max trick (as
    ``jax.random.categorical``)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def mode(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """Per-dimension entropy [..., D] in the numerically stable form
    (categorical.py:29)."""
    v = logits - torch.amax(logits, dim=-1, keepdim=True)
    s0 = torch.exp(v)
    s1 = torch.sum(s0, dim=-1, keepdim=True)
    p = s0 / s1
    return torch.sum(p * (torch.log(s1) - v), dim=-1)
