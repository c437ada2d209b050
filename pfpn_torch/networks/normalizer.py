"""Online observation normalizer.

Counterpart of ``pfpn_tpu/networks/normalizer.py``: the state (mean, std,
count) as module buffers, the clipped normalization, and both updates: the
moving average the presets use (``normalizer.py:44-53``; decay
min(0.9999, (1 + s) / (10 + s)) with s the optimizer step) and the
parallel Welford merge (``:56-67``). Updates write the buffers in place and
happen at train time, outside autograd. :func:`moving_average` is the
moving-average arithmetic on tensors, which ``networks/value_norm.py``
shares.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def moving_average(mean: torch.Tensor, std: torch.Tensor, batch: torch.Tensor,
                   global_step: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) after reference utils.py:60-68 over ``batch``'s first
    axis, as normalizer.py:44 computes it in fp32 (the decay on the host,
    in numpy's fp32: no copy to the device)."""
    s = np.float32(global_step)
    decay = np.minimum(np.float32(0.9999), (np.float32(1.0) + s) / (np.float32(10.0) + s))
    decay, rest = float(decay), float(np.float32(1.0) - decay)
    m = torch.mean(batch, 0)
    v = torch.var(batch, 0, correction=0)
    return (decay * mean + rest * m,
            torch.clamp(decay * std + rest * torch.sqrt(v), min=1e-6))


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

    @torch.no_grad()
    def update_moving_average(self, batch: torch.Tensor, global_step: int) -> None:
        """:func:`moving_average` into the buffers."""
        mean, std = moving_average(self.mean, self.std, batch, global_step)
        self.mean.copy_(mean)
        self.std.copy_(std)

    @torch.no_grad()
    def update_welford(self, batch: torch.Tensor) -> None:
        """Reference utils.py:69-80 (parallel Welford merge)."""
        batch_mean = torch.mean(batch, 0)
        batch_var = torch.var(batch, 0, correction=0)
        batch_count = torch.tensor(float(batch.shape[0]), device=batch.device)
        delta = batch_mean - self.mean
        new_count = self.count + batch_count
        m_a = torch.square(self.std) * self.count
        m_b = batch_var * batch_count
        m2 = m_a + m_b + torch.square(delta) * self.count * batch_count / new_count
        self.std.copy_(torch.clamp(torch.sqrt(m2 / new_count), min=1e-6))
        self.mean.copy_(self.mean + delta * batch_count / new_count)
        self.count.copy_(new_count)
