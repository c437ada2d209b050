"""ctypes binding of the native mocap preprocessing library.

Counterpart of ``pfpn_tpu/mocap/native.py``: loads ``csrc/libpfpn_mocap.so``
(``make -C csrc``) in place when it is built; the loader
(``mocap/loader.py``) takes the NumPy path otherwise, which gives the same
motion tables.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "csrc", "libpfpn_mocap.so"),
    "libpfpn_mocap.so",
]

_lib = None


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it is not built."""
    global _lib
    if _lib is not None:
        return _lib
    for p in _LIB_PATHS:
        try:
            lib = ctypes.CDLL(p)
        except OSError:
            continue
        c_d = ctypes.POINTER(ctypes.c_double)
        c_i = ctypes.POINTER(ctypes.c_int64)
        lib.pfpn_butterworth_fb.argtypes = [
            c_d, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double]
        lib.pfpn_quat_reorder.argtypes = [
            c_d, ctypes.c_int64, ctypes.c_int64, c_i, ctypes.c_int64]
        lib.pfpn_quat_velocities.argtypes = [
            c_d, c_d, ctypes.c_int64, ctypes.c_int, c_d]
        lib.pfpn_linear_velocities.argtypes = [
            c_d, c_d, ctypes.c_int64, ctypes.c_int64, c_d]
        _lib = lib
        return lib
    return None


def available() -> bool:
    return load_library() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _columns(a: np.ndarray):
    """(contiguous float64 2-D array, whether it was 1-D)."""
    x = np.ascontiguousarray(a, dtype=np.float64)
    return (x[:, None], True) if x.ndim == 1 else (x, False)


def butterworth_fb(samples: np.ndarray, fs: float, fc: float) -> np.ndarray:
    """Forward-backward second-order Butterworth low-pass over axis 0."""
    x, squeeze = _columns(samples)
    out = x.copy()
    load_library().pfpn_butterworth_fb(_ptr(out), out.shape[0], out.shape[1],
                                       out.shape[1], fs, fc)
    return out[:, 0] if squeeze else out


def quat_reorder(frames: np.ndarray, offsets) -> np.ndarray:
    """wxyz -> xyzw of the quaternion starting at each column offset."""
    out = np.ascontiguousarray(frames, dtype=np.float64).copy()
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    load_library().pfpn_quat_reorder(
        _ptr(out), out.shape[0], out.shape[1],
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(offs))
    return out


def quat_velocities(quats: np.ndarray, dts: np.ndarray, local: bool) -> np.ndarray:
    """Finite-difference angular velocities (global or local frame), the
    last row repeated."""
    q = np.ascontiguousarray(quats, dtype=np.float64)
    d = np.ascontiguousarray(dts, dtype=np.float64)
    out = np.zeros((q.shape[0], 3))
    load_library().pfpn_quat_velocities(_ptr(q), _ptr(d), q.shape[0], int(local),
                                        _ptr(out))
    return out


def linear_velocities(vals: np.ndarray, dts: np.ndarray) -> np.ndarray:
    """Finite-difference rates over axis 0, the last row repeated."""
    v, squeeze = _columns(vals)
    d = np.ascontiguousarray(dts, dtype=np.float64)
    out = np.zeros_like(v)
    load_library().pfpn_linear_velocities(_ptr(v), _ptr(d), v.shape[0], v.shape[1],
                                          _ptr(out))
    return out[:, 0] if squeeze else out
