"""Batched inverse of small SPD matrices: a CUDA kernel and its plain version.

Counterpart of ``pfpn_tpu/ops/linalg.py``. The TPU kernel
``_spd_inverse_kernel`` (``linalg.py:32``), launched by
``_spd_inverse_pallas`` (``:51``), becomes ``csrc/spd_inverse.cu``:
hand-written CUDA C++ for ``sm_90a``, built with ``nvcc`` at first use and
bound with ctypes (``ops/_build.py``). For N = 34, the humanoid's dofs, one
warp inverts each matrix in registers (two matrices per block); every
other N in 1..63 launches a second kernel of the same source, one thread
block per matrix in shared memory.

:func:`spd_inverse` and :func:`spd_inverse_pair` dispatch on the tensor's
device, with no fallback from one to the other:

* on ``cuda`` they launch the kernel on the current stream, raise if the
  launch is refused, and add one to :data:`launches`;
* on ``cpu`` they run :func:`spd_inverse_reference`, the plain version
  (Cholesky, as ``_spd_inverse_reference``, ``linalg.py:79-81``, in float64
  and rounded to float32).

:func:`spd_inverse_host` runs the kernel's source built with g++ on CPU
tensors: the CPU tests' view of the kernel's arithmetic.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaSource

#: kernel launches made by :func:`spd_inverse` and :func:`spd_inverse_pair`
launches = 0

_MAX_N = 63      # (3 n^2 + 2n) floats of shared memory must fit in 48 KB


def _declare(lib, host: bool):
    if host:
        fn = lib.pfpn_spd_inverse_host
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int]
    else:
        fn = lib.pfpn_spd_inverse_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pfpn_spd_inverse_group_threads.argtypes = [ctypes.c_int]
    lib.pfpn_spd_inverse_group_threads.restype = ctypes.c_int


LIBRARY = CudaSource("spd_inverse", _declare, headers=("block_linalg.cuh",))


def spd_inverse_reference(a: torch.Tensor) -> torch.Tensor:
    """Inverse of SPD matrices (..., N, N) by Cholesky: the plain version.

    It factors in float64 and rounds the inverse to ``a``'s dtype. In fp32,
    Cholesky leaves ~4e-7 of relative error in the humanoid's H^-1 (cond
    ~ 4e4), which torques near the motor limits carry into ~1.2e-4 of
    velocity per substep, beyond the one-substep bound the kernel is held
    to; in float64 that error is the fp32 rounding of the result."""
    a64 = a.double()
    eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
    return torch.cholesky_solve(eye.expand_as(a64), torch.linalg.cholesky(a64)).to(a.dtype)


def _check(a: torch.Tensor) -> int:
    if a.dim() < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"spd_inverse: want (..., N, N), got {tuple(a.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"spd_inverse: dtype {a.dtype}, want float32")
    if not 1 <= a.shape[-1] <= _MAX_N:
        raise ValueError(f"spd_inverse kernel takes 1 <= N <= {_MAX_N}, "
                         f"got {a.shape[-1]}")
    return a.shape[-1]


def group_threads(n: int, host: bool = False) -> int:
    """Threads that invert one N x N matrix on the card: a warp for N = 34,
    a 256-thread block for any other N (read from the built source)."""
    return LIBRARY.load(host=host).pfpn_spd_inverse_group_threads(n)


def spd_inverse_kernel(a: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on (..., N, N) CUDA tensors: the warp kernel for
    N = 34, the block kernel for every other N."""
    global launches
    n = _check(a)
    if not a.is_cuda:
        raise ValueError("spd_inverse kernel needs a CUDA tensor")
    a = a.contiguous()
    out = torch.empty_like(a)
    count = a.numel() // (n * n)
    lib = LIBRARY.load()
    with torch.cuda.device(a.device):     # the launch goes to the current device
        rc = lib.pfpn_spd_inverse_launch(
            a.data_ptr(), out.data_ptr(), count, n,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spd_inverse kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def spd_inverse_host(a: torch.Tensor, threads: int = 1) -> torch.Tensor:
    """csrc/spd_inverse.cu built with g++, on (..., N, N) CPU tensors.

    ``threads`` host threads run the body of one matrix with a
    ``std::barrier`` in place of the card's syncs: for N = 34, 1 or 32 (the
    warp's lanes); for any other N, any count (the block's threads)."""
    n = _check(a)
    a = a.detach().cpu().contiguous()
    out = torch.empty_like(a)
    rc = LIBRARY.load(host=True).pfpn_spd_inverse_host(
        a.data_ptr(), out.data_ptr(), a.numel() // (n * n), n, int(threads))
    if rc != 0:
        raise ValueError(f"spd_inverse host build: threads={threads} refused for N={n}")
    return out


def spd_inverse(a: torch.Tensor) -> torch.Tensor:
    """Inverse of SPD matrices (B, N, N): the kernel on ``cuda``, the plain
    version on ``cpu``."""
    if a.is_cuda:
        return spd_inverse_kernel(a)
    return spd_inverse_reference(a)


def spd_inverse_pair(pair: torch.Tensor) -> torch.Tensor:
    """Invert stacked pairs (B, 2, N, N) in one launch over the 2B matrices
    (the unfused substep needs (H + diag(kd dt))^-1 and H^-1)."""
    if pair.dim() != 4 or pair.shape[1] != 2:
        raise ValueError(f"spd_inverse_pair: want (B, 2, N, N), got {tuple(pair.shape)}")
    return spd_inverse(pair)
