"""The fused Stable-PD substep's linear algebra in plain PyTorch.

A frozen copy of ``SubstepMeta``, ``clamp_dtau``, ``pgs_project``,
``pgs_solve`` and ``substep_core_reference`` of ``pfpn_torch/ops/substep_lin.py``:
both SPD solves by Cholesky, the torque clamp, W = H^-1 J^T and the
projected Jacobi sweeps over the contact and limit rows.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


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
