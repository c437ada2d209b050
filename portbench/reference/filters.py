"""Host-side signal filters used for mocap velocity smoothing.

A copy of ``pfpn_tpu/math/filters.py`` (pure NumPy): the second-order
forward-backward Butterworth low-pass filter with first/last sample
replication. Runs at motion load time; the filtered tables then become
device tensors.
"""

from __future__ import annotations

import math

import numpy as np


def so_fb_butter_lpf(samples: np.ndarray, fs: float, fc: float) -> np.ndarray:
    """Second-order forward-backward Butterworth low-pass filter.

    Args:
      samples: (T,) or (T, C) array filtered along axis 0.
      fs: sampling frequency (Hz).
      fc: cutoff frequency (Hz).
    """
    samples = np.asarray(samples, dtype=np.float64)
    c = 1.0 / math.tan(math.pi * fc / fs)
    a0 = 1.0 / (1.0 + math.sqrt(2) * c + c * c)
    a1 = 2 * a0
    a2 = a0
    b1 = 2 * a0 * (1 - c * c)
    b2 = a0 * (1 - math.sqrt(2) * c + c * c)

    def _pass(x):
        x1 = x2 = y1 = y2 = x[0]
        ys = np.empty_like(x)
        for i in range(len(x)):
            y = a0 * x[i] + a1 * x1 + a2 * x2 - b1 * y1 - b2 * y2
            x2, x1 = x1, x[i]
            y2, y1 = y1, y
            ys[i] = y
        return ys

    forward = _pass(samples)
    backward = _pass(forward[::-1])
    return backward[::-1]
