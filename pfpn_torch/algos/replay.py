"""Uniform replay ring as one preallocated packed tensor on the env's device.

Counterpart of ``pfpn_tpu/algos/replay.py``: the dict-of-fields API over
ONE (capacity, D) float32 tensor with a static field -> column-slice spec
(fields sorted by name; only dtypes that round-trip exactly through
float32, ``replay.py:38-60``). An insert is one scatter of the packed rows,
wrapping around the ring (``:88-99``); a draw is one gather of
``batch_size`` rows taken uniformly with replacement from
[0, max(size, 1)) (``:107-111``) with the run's generator.

``pointer`` and ``size`` are Python ints, so that gating on "enough
samples" costs no host sync; so are the counters ``rows_inserted`` and
``rows_drawn``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

# dtypes that round-trip exactly through the float32 packed storage
_EXACT_VIA_F32 = frozenset((torch.float32, torch.float16, torch.bfloat16, torch.bool,
                            torch.int8, torch.int16, torch.uint8))

Spec = Tuple[Tuple[str, Tuple[int, int, Tuple[int, ...], torch.dtype]], ...]


def _build_spec(example: Dict[str, torch.Tensor]) -> Tuple[Spec, int]:
    spec, off = [], 0
    for k in sorted(example):
        v = example[k]
        if v.dtype not in _EXACT_VIA_F32:
            raise TypeError(
                f"replay field {k!r} has dtype {v.dtype}, which does not round-trip "
                "exactly through the packed float32 ring")
        shape = tuple(int(s) for s in v.shape[1:])
        size = math.prod(shape)
        spec.append((k, (off, size, shape, v.dtype)))
        off += size
    return tuple(spec), off


class ReplayBuffer:
    """The packed ring: ``data`` (capacity, D) float32 and the field spec."""

    def __init__(self, capacity: int, example: Dict[str, torch.Tensor]):
        """An empty ring of ``capacity`` transitions shaped like ``example``'s
        rows, on its device."""
        self.spec, width = _build_spec(example)
        self.data = torch.zeros(capacity, width, device=next(iter(example.values())).device)
        self.pointer = 0
        self.size = 0
        self.rows_inserted = 0
        self.rows_drawn = 0

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def _unpack(self, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        n = rows.shape[0]
        return {k: rows[:, off:off + size].reshape((n,) + shape).to(dtype)
                for k, (off, size, shape, dtype) in self.spec}

    def add_batch(self, batch: Dict[str, torch.Tensor]) -> None:
        """Insert a batch of transitions, wrapping around the ring."""
        n = next(iter(batch.values())).shape[0]
        packed = torch.cat([batch[k].reshape(n, -1).to(torch.float32) for k, _ in self.spec], 1)
        idx = (self.pointer + torch.arange(n, device=self.data.device)) % self.capacity
        self.data[idx] = packed
        self.pointer = (self.pointer + n) % self.capacity
        self.size = min(self.size + n, self.capacity)
        self.rows_inserted += n

    def contents(self) -> Dict[str, torch.Tensor]:
        """The whole ring as per-field (capacity, ...) tensors."""
        return self._unpack(self.data)

    def draw_indices(self, batch_size: int,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        """``batch_size`` slots drawn uniformly with replacement from the
        filled part."""
        return torch.randint(0, max(self.size, 1), (batch_size,), generator=generator,
                             device=self.data.device)

    def sample(self, batch_size: int,
               generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """``batch_size`` transitions at :meth:`draw_indices`' slots."""
        idx = self.draw_indices(batch_size, generator)
        self.rows_drawn += batch_size
        return self._unpack(self.data[idx])
