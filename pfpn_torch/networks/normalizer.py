"""Observation normalizer state, acting side.

Counterpart of ``pfpn_tpu/networks/normalizer.py``: the state (mean, std,
count) as module buffers and the clipped normalization. The moving-average
and Welford updates come with the training slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


class Normalizer(nn.Module):
    def __init__(self, shape: Sequence[int]):
        super().__init__()
        self.register_buffer("mean", torch.zeros(tuple(shape)))
        self.register_buffer("std", torch.ones(tuple(shape)))
        self.register_buffer("count", torch.tensor(1e-4))

    def forward(self, x: torch.Tensor, clip: Optional[float] = 5.0) -> torch.Tensor:
        y = (x - self.mean) / self.std
        if clip:
            y = torch.clamp(y, -clip, clip)
        return y
