"""Order statistics and interval arithmetic of the benchmark's metrics."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default), over every value."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def intervals(ends_ms: Sequence[float], start_ms: float = 0.0) -> List[float]:
    """Durations between consecutive ends, the first from ``start_ms``."""
    out, prev = [], start_ms
    for e in ends_ms:
        out.append(e - prev)
        prev = e
    return out


def union(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals covering the union of ``spans``."""
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def covered(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``spans``."""
    return sum(b - a for a, b in union(spans))


def gaps(merged: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The holes between merged intervals, as (start, end)."""
    return [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
