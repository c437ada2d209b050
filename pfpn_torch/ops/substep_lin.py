"""One substep's linear algebra: a CUDA kernel and its plain version.

Counterpart of ``pfpn_tpu/ops/substep_lin.py``. Per environment:

  Minv = (H + diag(kd dt) + eps)^-1
  a    = Minv f,  tau = kpe - kd a dt        SPD acceleration
  dtau = clamp_motors(tau) - tau             per-motor torque limits
  v*   = v + dt (a + (H + eps)^-1 dtau)
  W    = (H + eps)^-1 J^T,  A = J W          Delassus operator
  lam  = projected Jacobi with the Gershgorin step, friction cone
  v'   = v* + W lam

:func:`substep_core_reference` is the plain version, batched
``_substep_core_reference`` (``substep_lin.py:101-129``, Cholesky solves);
it is also the substep math of the megastep's plain version. The TPU
kernel (``_make_kernel``, ``substep_lin.py:136``, launched by
``_substep_core_pallas``) becomes ``csrc/substep_lin.cu``: hand-written
CUDA C++ for ``sm_90a``, one thread block per environment with its whole
workspace in shared memory, built with ``nvcc`` at first use and bound with
ctypes (``ops/_build.py``). For the humanoid's shape (34 dofs, 16 contacts,
8 limit rows) the block is two warps that invert both matrices at once in
registers; every other shape launches a second kernel of the same source,
the first design (128 threads, the two inverses one after the other in
shared memory).

:func:`substep_core` dispatches on the tensor's device, with no fallback
from one to the other: on ``cuda`` it launches the kernel on the current
stream, raises if the launch is refused and adds one to :data:`launches`;
on ``cpu`` it runs the plain version. :func:`substep_core_host` runs the
kernel's source built with g++ on CPU tensors (the CPU tests).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ._build import CudaSource

#: kernel launches made by :func:`substep_core`
launches = 0


@dataclasses.dataclass(frozen=True)
class SubstepMeta:
    ndof: int
    kd: Tuple[float, ...]
    dt: float
    sph_motors: Tuple[Tuple[int, float], ...]   # (start_dof, limit)
    rev_motors: Tuple[Tuple[int, float], ...]
    n_contacts: int
    n_limits: int
    mu: float
    cfm: float
    iterations: int
    relaxation: float
    eps: float = 1e-8

    @property
    def n_rows(self) -> int:
        return 3 * self.n_contacts + self.n_limits


def clamp_dtau(meta: SubstepMeta, tau: torch.Tensor) -> torch.Tensor:
    """clamp(tau) - tau per motor (B, ndof)."""
    dtau = torch.zeros_like(tau)
    for d, lim in meta.sph_motors:
        t3 = tau[:, d:d + 3]
        n = torch.sqrt(torch.sum(t3 * t3, -1, keepdim=True))
        scale = torch.where(n > lim, lim / torch.clamp(n, min=1e-9),
                            torch.ones_like(n))
        dtau[:, d:d + 3] = t3 * scale - t3
    for d, lim in meta.rev_motors:
        t = tau[:, d]
        dtau[:, d] = torch.clamp(t, -lim, lim) - t
    return dtau


def pgs_project(mu: float, upd, act_n, act_l):
    """Project Jacobi updates (B, R) onto the friction cones of the K
    contacts (rows [K normals, K t1, K t2]) and the limit rows after them."""
    k = act_n.shape[1]
    lam_n = torch.clamp(upd[:, :k], min=0.0) * act_n
    bound = mu * lam_n
    lam_t1 = torch.clamp(upd[:, k:2 * k], -bound, bound) * act_n
    lam_t2 = torch.clamp(upd[:, 2 * k:3 * k], -bound, bound) * act_n
    parts = [lam_n, lam_t1, lam_t2]
    if upd.shape[1] > 3 * k:
        parts.append(torch.clamp(upd[:, 3 * k:], min=0.0) * act_l)
    return torch.cat(parts, -1)


def pgs_solve(rows, w, v_star, target, act_n, act_l, mu: float, cfm: float,
              relaxation: float, iterations: int) -> torch.Tensor:
    """Projected Jacobi with the Gershgorin step on A = J W, from lam = 0.
    Returns the velocity change W lam (B, ndof)."""
    a_mat = rows @ w                                           # (B, R, R)
    rowsum = torch.sum(torch.abs(a_mat), -1) + cfm
    step = relaxation / torch.clamp(rowsum, min=1e-9)
    b = (rows @ v_star[..., None])[..., 0] - target
    lam = torch.zeros_like(target)
    for _ in range(iterations):
        upd = lam - step * ((a_mat @ lam[..., None])[..., 0] + b)
        lam = pgs_project(mu, upd, act_n, act_l)
    return (w @ lam[..., None])[..., 0]


def substep_core_reference(meta: SubstepMeta, h, f, kpe, v, rows, target,
                           act_n, act_l) -> torch.Tensor:
    """Batched ``_substep_core_reference``: returns v' (B, ndof)."""
    n = meta.ndof
    kd = torch.tensor(meta.kd, dtype=h.dtype, device=h.device)
    eye = torch.eye(n, dtype=h.dtype, device=h.device)
    m = h + torch.diag(kd * meta.dt) + meta.eps * eye
    a = torch.cholesky_solve(f[..., None], torch.linalg.cholesky(m))[..., 0]
    tau = kpe - kd * a * meta.dt
    dtau = clamp_dtau(meta, tau)
    h_ch = torch.linalg.cholesky(h + meta.eps * eye)
    qdd = a + torch.cholesky_solve(dtau[..., None], h_ch)[..., 0]
    v_star = v + meta.dt * qdd
    w = torch.cholesky_solve(rows.transpose(-1, -2), h_ch)     # (B, n, R)
    return v_star + pgs_solve(rows, w, v_star, target, act_n, act_l, meta.mu,
                              meta.cfm, meta.relaxation, meta.iterations)


def substep_flops(meta: SubstepMeta) -> int:
    """fp32 operations one env's substep needs at least (an FMA counts two),
    for the kernel's bound: a Cholesky factor of each of the two SPD
    matrices (n^3/3 each), triangular solves for Minv f, Hinv dtau and the
    R columns of W = Hinv J^T (2 n^2 each), the symmetric A = J W (R (R+1)/2
    entries of 2n), the row sums and 16 Jacobi sweeps, and v* + W lam. The
    kernel itself does more: two full Gauss-Jordan sweeps and a full A."""
    n, R, K3 = meta.ndof, meta.n_rows, 3 * meta.n_contacts
    motors = 12 * len(meta.sph_motors) + 5 * len(meta.rev_motors)
    return (2 * n ** 3 // 3                # two Cholesky factors
            + 2 * 2 * n * n                # a = Minv f, Hinv dtau
            + motors + 3 * n + 3 * n       # tau, torque clamp, v*
            + 2 * n * n * R                # W = Hinv J^T
            + n * R * (R + 1)              # A = J W, symmetric
            + 2 * R * R + 3 * R + 2 * n * R  # row sums, step, b
            + meta.iterations * (2 * R * R + 3 * R + 3 * K3)  # Jacobi
            + 2 * n * R + n)               # v* + W lam


# ---------------------------------------------------------------------------
# the kernel (struct SubstepTables in csrc/substep_lin.cu)
# ---------------------------------------------------------------------------

MAXD, MAXS, MAXR = 64, 16, 16    # SL_MAX* in csrc/substep_lin.cu
_I, _F = ctypes.c_int32, ctypes.c_float


class SubstepTables(ctypes.Structure):
    _fields_ = [(name, _I) for name in (
        "ndof", "K", "n_lim", "iterations", "n_sph_motors", "n_rev_motors")] + [
        ("sph_motor_dof", _I * MAXS), ("rev_motor_dof", _I * MAXR)] + [
        (name, _F) for name in ("dt", "mu", "cfm", "relaxation", "eps")] + [
        ("minv_diag", _F * MAXD), ("kd_dt", _F * MAXD),
        ("sph_motor_lim", _F * MAXS), ("rev_motor_lim", _F * MAXR)]


@functools.lru_cache(maxsize=8)
def pack_tables(meta: SubstepMeta) -> SubstepTables:
    """Fill the kernel's static tables; raise if the meta exceeds them."""
    n = meta.ndof
    for what, have, cap in (("dofs", n, MAXD),
                            ("spherical motors", len(meta.sph_motors), MAXS),
                            ("revolute motors", len(meta.rev_motors), MAXR)):
        if have > cap:
            raise ValueError(f"substep_lin kernel takes at most {cap} {what}, "
                             f"got {have}")
    t = SubstepTables(ndof=n, K=meta.n_contacts, n_lim=meta.n_limits,
                      iterations=meta.iterations,
                      n_sph_motors=len(meta.sph_motors),
                      n_rev_motors=len(meta.rev_motors),
                      dt=meta.dt, mu=meta.mu, cfm=meta.cfm,
                      relaxation=meta.relaxation, eps=meta.eps)
    # float32 products, as the TPU kernel forms np.float32(kd) * dt
    kd_dt = np.asarray(meta.kd, dtype=np.float32) * np.float32(meta.dt)
    for i in range(n):
        t.kd_dt[i] = float(kd_dt[i])
        t.minv_diag[i] = float(kd_dt[i] + np.float32(meta.eps))
    for i, (d, lim) in enumerate(meta.sph_motors):
        t.sph_motor_dof[i], t.sph_motor_lim[i] = d, lim
    for i, (d, lim) in enumerate(meta.rev_motors):
        t.rev_motor_dof[i], t.rev_motor_lim[i] = d, lim
    return t


def _declare(lib, host: bool):
    ptrs = [ctypes.c_void_p] * 10
    if host:
        fn = lib.pfpn_substep_lin_host
        fn.argtypes = ptrs + [ctypes.c_int, ctypes.c_int]
    else:
        fn = lib.pfpn_substep_lin_launch
        fn.argtypes = ptrs + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pfpn_substep_lin_tables_bytes.argtypes = []
    lib.pfpn_substep_lin_tables_bytes.restype = ctypes.c_int
    lib.pfpn_substep_lin_block_threads.argtypes = [ctypes.c_void_p]
    lib.pfpn_substep_lin_block_threads.restype = ctypes.c_int
    if lib.pfpn_substep_lin_tables_bytes() != ctypes.sizeof(SubstepTables):
        raise RuntimeError("SubstepTables layout differs between "
                           "csrc/substep_lin.cu and ops/substep_lin.py")


LIBRARY = CudaSource("substep_lin", _declare, headers=("block_linalg.cuh",))


def _inputs(meta: SubstepMeta, h, f, kpe, v, rows, target, act_n, act_l):
    """Check shapes, dtypes and devices; return the inputs contiguous."""
    B, n, R = h.shape[0], meta.ndof, meta.n_rows
    want = {"h": (h, (B, n, n)), "f": (f, (B, n)), "kpe": (kpe, (B, n)),
            "v": (v, (B, n)), "rows": (rows, (B, R, n)), "target": (target, (B, R)),
            "act_n": (act_n, (B, meta.n_contacts)),
            "act_l": (act_l, (B, max(meta.n_limits, 1)))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"substep_core {name}: shape {tuple(x.shape)}, want {shape}")
        if x.dtype != torch.float32:
            raise TypeError(f"substep_core {name}: dtype {x.dtype}, want float32")
        if x.device != h.device:
            raise ValueError(f"substep_core {name} on {x.device}, h on {h.device}")
    return [x.contiguous() for x, _ in want.values()]


def block_threads(meta: SubstepMeta, host: bool = False) -> int:
    """Threads per env on the card for ``meta``, read from the built source:
    64 (the two-warp kernel) for the humanoid's shape, 128 otherwise."""
    return LIBRARY.load(host=host).pfpn_substep_lin_block_threads(
        ctypes.addressof(pack_tables(meta)))


def substep_core_kernel(meta: SubstepMeta, h, f, kpe, v, rows, target, act_n,
                        act_l) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors: v' (B, ndof). The launch checks the
    shape against the two-warp kernel's (34 dofs, 16 contacts, 8 limit rows)
    and runs the first design's kernel for any other."""
    global launches
    args = _inputs(meta, h, f, kpe, v, rows, target, act_n, act_l)
    if not h.is_cuda:
        raise ValueError("substep_lin kernel needs CUDA tensors")
    tables = pack_tables(meta)
    out = torch.empty_like(args[1])
    lib = LIBRARY.load()
    with torch.cuda.device(h.device):     # the launch goes to the current device
        rc = lib.pfpn_substep_lin_launch(
            ctypes.addressof(tables), *(x.data_ptr() for x in args), out.data_ptr(),
            h.shape[0], torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"substep_lin kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def substep_core_host(meta: SubstepMeta, h, f, kpe, v, rows, target, act_n,
                      act_l, threads: int = 1) -> torch.Tensor:
    """csrc/substep_lin.cu built with g++, on CPU tensors.

    ``threads`` host threads run one env's body with ``std::barrier`` in
    place of the card's syncs: for the humanoid's shape, 1 or 64 (the two
    warps' lanes); for any other shape, any count (the block's threads)."""
    args = [x.detach().cpu() for x in (h, f, kpe, v, rows, target, act_n, act_l)]
    args = _inputs(meta, *args)
    out = torch.empty_like(args[1])
    rc = LIBRARY.load(host=True).pfpn_substep_lin_host(
        ctypes.addressof(pack_tables(meta)), *(x.data_ptr() for x in args),
        out.data_ptr(), args[0].shape[0], int(threads))
    if rc != 0:
        raise ValueError(f"substep_lin host build: threads={threads} refused")
    return out


def substep_core(meta: SubstepMeta, h, f, kpe, v, rows, target, act_n,
                 act_l) -> torch.Tensor:
    """One substep's linear algebra for a batch: the kernel on ``cuda``, the
    plain version on ``cpu``. Returns v' (B, ndof)."""
    fn = substep_core_kernel if h.is_cuda else substep_core_reference
    return fn(meta, h, f, kpe, v, rows, target, act_n, act_l)
