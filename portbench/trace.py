"""Reading a ``torch.profiler`` window into the numbers the metrics take.

The device's busy time is the union of its operations' intervals, as
``chip_smoke.py``'s ``profile_summary`` takes it; the traced window runs
from the first to the last event of any kind. Kernels are the device
events that are neither copies, fills nor the profiler's own markers of a
host region. A region's device time is what the kernels launched inside a
``record_function`` of that name took. The breakdown lists the device
operations by total time and the longest idle gaps, each named by the
innermost host operation running at its middle.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from . import stats

REGION_PREFIX = "portbench."
_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


class Trace:
    """The device and host events of one profiled stretch of ``steps`` env
    steps, times in microseconds."""

    def __init__(self, device_ops: List[Tuple[str, float, float]],
                 host_ops: List[Tuple[str, float, float]],
                 regions: Dict[str, float], steps: int):
        self.device_ops = device_ops
        self.host_ops = host_ops
        self.regions = regions
        self.steps = steps
        times = [t for _, a, b in device_ops + host_ops for t in (a, b)]
        self.t0 = min(times) if times else 0.0
        self.t1 = max(times) if times else 0.0
        self.merged = stats.union((a, b) for _, a, b in device_ops)

    @property
    def kernels(self) -> List[Tuple[str, float, float]]:
        return [k for k in self.device_ops if not k[0].startswith(_NOT_KERNELS)]

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_us(self) -> float:
        return sum(b - a for a, b in self.merged)

    def kernels_named(self, fragment: str) -> List[Tuple[str, float, float]]:
        return [k for k in self.kernels if fragment in k[0]]

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time and the longest idle
        gaps, by name, in seconds."""
        by_name: Dict[str, float] = {}
        for name, a, b in self.device_ops:
            by_name[name[:120]] = by_name.get(name[:120], 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        holes = [(self.t0, self.merged[0][0])] if self.merged else []
        holes += stats.gaps(self.merged)
        if self.merged:
            holes.append((self.merged[-1][1], self.t1))
        holes = sorted((h for h in holes if h[1] > h[0]), key=lambda h: h[0] - h[1])[:top]
        host = sorted(self.host_ops, key=lambda e: e[1])
        starts = [e[1] for e in host]
        gaps = []
        for a, b in holes:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            name = "no host operation"
            for j in range(i - 1, max(-1, i - 4000), -1):   # innermost: latest start
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            gaps.append([name[:120], (b - a) / 1e6])
        return {"device_ops": [[n, us / 1e6] for n, us in ops], "idle_gaps": gaps}


def _device_us(e) -> Optional[float]:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return None


def from_profiler(prof, steps: int) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device_ops, host_ops, regions = [], [], {}
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(REGION_PREFIX) or getattr(e, "is_user_annotation", False):
                continue
            device_ops.append(span)
        else:
            host_ops.append(span)
            if e.name.startswith(REGION_PREFIX):
                us = _device_us(e)
                if us is not None:
                    regions[e.name] = regions.get(e.name, 0.0) + us
    return Trace(device_ops, host_ops, regions, steps)


def synthetic(device_ops: Sequence[Tuple[str, float, float]],
              host_ops: Sequence[Tuple[str, float, float]] = (),
              regions: Optional[Dict[str, float]] = None, steps: int = 1) -> Trace:
    """A :class:`Trace` from given events (the CPU tests' input)."""
    return Trace(list(device_ops), list(host_ops), dict(regions or {}), steps)
