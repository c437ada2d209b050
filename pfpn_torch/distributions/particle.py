"""Particle-filtering policy distribution (the PFPN head), acting side.

Counterpart of ``pfpn_tpu/distributions/particle.py``: per action dimension
a categorical over N particles (weights from the logit layer) mixed with
per-particle Gaussians whose means/stds are free variables. This slice ports
what acting needs: :func:`mode`, the deterministic action (the argmax-weight
particle's mean, ``particle.py:179``), and :func:`probs`. The log-prob,
entropy, sampling and their custom gradients come with the training slice.

Shapes: logits [..., D, N]; loc/scale [D, N]; actions [..., D].
"""

from __future__ import annotations

import torch


def mode(logits: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """Deterministic action: the mean of each dimension's heaviest particle
    (forward only; the tanh-squashed variant comes with the SAC path)."""
    idx = torch.argmax(logits, dim=-1, keepdim=True)
    return torch.gather(loc.expand(logits.shape), -1, idx)[..., 0]


def probs(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits, dim=-1)
