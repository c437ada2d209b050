"""Ground-plane contacts: candidates, constraint rows and the unfused solve.

A frozen copy of the port's counterpart of ``pfpn_tpu/sim/contact.py:40-380``: the static candidate
points (sphere centres, capsule end caps, box corners), their world
positions, the top-K deepest selection, point Jacobians, Baumgarte targets,
the revolute joint-limit rows, and :func:`solve`, the projected-Jacobi
solve of the unfused substep from an explicit H^-1. That solve is plain
PyTorch, as in JAX, where it is XLA code outside any kernel; the fused
substep solves inside ``csrc/substep_lin.cu`` and the CUDA megastep.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .substep import pgs_solve
from .dynamics import FKResult, const, index_const
from .types import FREE, GEOM_BOX, GEOM_CAPSULE, GEOM_SPHERE, KinematicTree, REVOLUTE, SPHERICAL


@dataclasses.dataclass(frozen=True)
class ContactParams:
    mu: float = 0.81            # combined friction (0.9 * 0.9, Bullet multiply rule)
    erp: float = 0.2            # Baumgarte position-correction factor
    slop: float = 0.001         # penetration slop (m)
    # projected Jacobi with the Gershgorin row-sum step (relaxation /
    # sum_j |A_ij|); plain Jacobi relaxation >= 0.45 diverges on fallen poses
    iterations: int = 16
    relaxation: float = 1.0
    # solve only the K deepest candidate points (static shape)
    max_contacts: int | None = 16
    cfm: float = 1e-6           # constraint regularization on diag(A)
    up_dir: int = 1             # index of the up axis (1 = y-up)
    limit_erp: float = 0.2      # joint-limit restitution factor


class ContactSet(NamedTuple):
    """Static candidate-point tables (host NumPy)."""

    body: np.ndarray
    offset: np.ndarray
    radius: np.ndarray
    link: np.ndarray
    dof_body: np.ndarray
    dof_axis_local: np.ndarray
    dof_is_linear: np.ndarray
    ancestor_mask: np.ndarray   # (ndof, np) 1 if dof moves point
    limit_dof: np.ndarray
    limit_rev: np.ndarray
    limit_value: np.ndarray
    limit_sign: np.ndarray


def build_contact_set(tree: KinematicTree) -> ContactSet:
    """Static candidate tables (contact.py:82), NumPy as in the JAX package."""
    pts_body, pts_off, pts_rad, pts_link = [], [], [], []

    def _mat(q):
        x, y, z, w = q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])

    for g in tree.geoms:
        R = _mat(np.asarray(g.quat))
        p = np.asarray(g.pos)
        if g.kind == GEOM_SPHERE:
            pts = [p]
            rad = g.size[0]
        elif g.kind == GEOM_CAPSULE:
            r, hl = g.size
            axis = R @ np.array([0.0, 0.0, 1.0])
            pts = [p + hl * axis, p - hl * axis]
            rad = r
        elif g.kind == GEOM_BOX:
            hx, hy, hz = g.size
            pts = [p + R @ np.array([sx * hx, sy * hy, sz * hz])
                   for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
            rad = 0.0
        else:
            raise ValueError("unknown geom")
        for pt in pts:
            pts_body.append(g.body)
            pts_off.append(pt)
            pts_rad.append(rad)
            pts_link.append(g.link)

    n_pts = len(pts_body)
    dof_body = np.zeros(tree.ndof, dtype=np.int64)
    dof_axis = np.zeros((tree.ndof, 3))
    dof_lin = np.zeros(tree.ndof, dtype=bool)
    for i in range(tree.nb):
        d = int(tree.dof_offset[i])
        if tree.joint_type[i] == FREE:
            dof_body[d:d + 6] = i
            dof_axis[d:d + 3] = np.eye(3)
            dof_axis[d + 3:d + 6] = np.eye(3)
            dof_lin[d + 3:d + 6] = True
        elif tree.joint_type[i] == SPHERICAL:
            dof_body[d:d + 3] = i
            dof_axis[d:d + 3] = np.eye(3)
        elif tree.joint_type[i] == REVOLUTE:
            dof_body[d] = i
            dof_axis[d] = tree.joint_axis[i]

    anc = np.zeros((tree.nb, tree.nb), dtype=bool)
    for b in range(tree.nb):
        j = b
        while j >= 0:
            anc[j, b] = True
            j = int(tree.parent[j])
    mask = np.zeros((tree.ndof, n_pts))
    for d in range(tree.ndof):
        for k in range(n_pts):
            mask[d, k] = anc[dof_body[d], pts_body[k]]

    lim_dof, lim_rev, lim_val, lim_sign = [], [], [], []
    for m, b in enumerate(tree.motor_bodies):
        if tree.joint_type[b] == REVOLUTE:
            lo, hi = tree.motor_movement_limit[m]
            if hi > lo:
                d = int(tree.dof_offset[b])
                r = int(tree.rev_index[b])
                lim_dof += [d, d]
                lim_rev += [r, r]
                lim_val += [lo, hi]
                lim_sign += [1.0, -1.0]

    return ContactSet(
        body=np.array(pts_body, dtype=np.int64),
        offset=np.stack(pts_off) if pts_off else np.zeros((0, 3)),
        radius=np.array(pts_rad),
        link=np.array(pts_link, dtype=np.int64),
        dof_body=dof_body, dof_axis_local=dof_axis, dof_is_linear=dof_lin,
        ancestor_mask=mask,
        limit_dof=np.array(lim_dof, dtype=np.int64),
        limit_rev=np.array(lim_rev, dtype=np.int64),
        limit_value=np.array(lim_val),
        limit_sign=np.array(lim_sign),
    )


def point_positions(cs: ContactSet, fkr: FKResult) -> torch.Tensor:
    """World positions of all candidate points: (B, np, 3)."""
    body = index_const(cs.body, fkr.body_pos)
    R = fkr.body_rot[:, body]
    p = fkr.body_pos[:, body]
    off = const(cs.offset, fkr.body_pos)
    return p + (R @ off[..., None])[..., 0]


def point_jacobians(cs: ContactSet, fkr: FKResult, x: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """J (B, k, 3, ndof): world point velocity = J @ v for points x (B, k, 3)
    with ancestor mask (B, ndof, k)."""
    ref = fkr.body_pos
    dof_body = index_const(cs.dof_body, ref)
    axes = (fkr.body_rot[:, dof_body]
            @ const(cs.dof_axis_local, ref)[..., None])[..., 0]   # (B, ndof, 3)
    anchors = fkr.body_pos[:, dof_body]                           # (B, ndof, 3)
    diff = x[:, None, :, :] - anchors[:, :, None, :]              # (B, ndof, k, 3)
    j_rot = torch.linalg.cross(axes[:, :, None, :].expand_as(diff), diff)
    is_lin = index_const(cs.dof_is_linear, ref).bool()[None, :, None, None]
    j = torch.where(is_lin, axes[:, :, None, :].expand_as(j_rot), j_rot)
    j = j * mask[..., None]
    return j.permute(0, 2, 3, 1)


class RowSet(NamedTuple):
    """Assembled constraint rows, layout [K normals, K t1, K t2, L limits]."""

    rows: torch.Tensor           # (B, n_rows, ndof)
    target: torch.Tensor         # (B, n_rows)
    act_n: torch.Tensor          # (B, K) float contact-active mask
    act_l: torch.Tensor          # (B, max(L, 1)) float limit-active mask
    active_all: torch.Tensor     # (B, np_all) bool per candidate point
    link_contact: torch.Tensor   # (B, nl+1) bool per reference link (+base)


def link_contact_matrix(tree: KinematicTree, cs: ContactSet) -> np.ndarray:
    """(np, nl+1) 0/1 table: candidate c belongs to link l (slot nl = base)."""
    nl = tree.link_pos.shape[0]
    link_idx = np.where(cs.link < 0, nl, cs.link)
    m = np.zeros((cs.body.shape[0], nl + 1))
    m[np.arange(cs.body.shape[0]), link_idx] = 1.0
    return m


def assemble_rows(tree: KinematicTree, cs: ContactSet, params: ContactParams,
                  fkr: FKResult, q_rev: torch.Tensor, dt: float) -> RowSet:
    """Candidate test, top-K selection, Jacobian rows, Baumgarte targets and
    masks (contact.py:232)."""
    ref = fkr.body_pos
    B = ref.shape[0]
    n_pts = cs.body.shape[0]
    up = params.up_dir
    radius = const(cs.radius, ref)

    x = point_positions(cs, fkr)
    dist_all = x[..., up] - radius
    active_all = dist_all < 0.0

    # Jacobians act at the SURFACE contact point (centre - radius * up)
    x_surf = x.clone()
    x_surf[..., up] = x_surf[..., up] - radius
    cmask = const(cs.ancestor_mask, ref)
    if params.max_contacts is not None and params.max_contacts < n_pts:
        k = params.max_contacts
        # lax.top_k order: deepest first, ties to the lower index (a
        # level foot puts its corners at one height)
        sel = torch.sort(-dist_all, dim=-1, descending=True,
                         stable=True).indices[:, :k]              # (B, k)
        dist = torch.gather(dist_all, 1, sel)
        active = torch.gather(active_all, 1, sel)
        mask_sel = cmask[:, sel].permute(1, 0, 2)                  # (B, ndof, k)
        xs = torch.gather(x_surf, 1, sel[..., None].expand(B, k, 3))
        jp = point_jacobians(cs, fkr, xs, mask_sel)
        n_pts = k
    else:
        dist, active = dist_all, active_all
        jp = point_jacobians(cs, fkr, x_surf, cmask.expand(B, -1, -1))

    axes = [0, 1, 2]
    axes.remove(up)
    t1, t2 = axes
    j_n, j_t1, j_t2 = jp[:, :, up], jp[:, :, t1], jp[:, :, t2]

    n_lim = cs.limit_dof.shape[0]
    if n_lim:
        j_lim = torch.zeros(n_lim, tree.ndof, device=ref.device)
        j_lim[torch.arange(n_lim), index_const(cs.limit_dof, ref)] = const(
            cs.limit_sign, ref)
        theta = q_rev[:, index_const(cs.limit_rev, ref)]
        sign = const(cs.limit_sign, ref)
        viol = sign * (const(cs.limit_value, ref) - theta)
        lim_active = (viol > 0.0).to(ref.dtype)
        lim_bias = params.limit_erp / dt * torch.clamp(viol, min=0.0)
        rows = torch.cat([j_n, j_t1, j_t2, j_lim.expand(B, -1, -1)], 1)
    else:
        lim_active = torch.zeros(B, 1, device=ref.device)
        lim_bias = torch.zeros(B, 0, device=ref.device)
        rows = torch.cat([j_n, j_t1, j_t2], 1)

    pen = torch.clamp(-dist - params.slop, min=0.0)
    v_bias_n = params.erp / dt * pen
    zeros = torch.zeros(B, n_pts, device=ref.device)
    target = torch.cat([v_bias_n, zeros, zeros, lim_bias], 1)

    link_contact = (active_all.to(ref.dtype)
                    @ const(link_contact_matrix(tree, cs), ref)) > 0.5
    return RowSet(rows=rows, target=target, act_n=active.to(ref.dtype),
                  act_l=lim_active, active_all=active_all,
                  link_contact=link_contact)


class ContactSolution(NamedTuple):
    dv: torch.Tensor             # (B, ndof) velocity change W lam
    penetrating: torch.Tensor    # (B, np_all) bool per candidate point
    link_contact: torch.Tensor   # (B, nl+1) bool per reference link (+base)


def solve(tree: KinematicTree, cs: ContactSet, params: ContactParams,
          fkr: FKResult, h_inv: torch.Tensor, v_star: torch.Tensor,
          q_rev: torch.Tensor, dt: float) -> ContactSolution:
    """Contact and joint-limit impulses for the pre-constraint velocity
    v_star (B, ndof), from the explicit inverse h_inv (B, ndof, ndof)
    (contact.py:322): W = H^-1 J^T, A = J W, the Gershgorin step and
    ``params.iterations`` projected-Jacobi sweeps."""
    rs = assemble_rows(tree, cs, params, fkr, q_rev, dt)
    w = h_inv @ rs.rows.transpose(-1, -2)                      # (B, ndof, R)
    dv = pgs_solve(rs.rows, w, v_star, rs.target, rs.act_n, rs.act_l,
                   params.mu, params.cfm, params.relaxation, params.iterations)
    return ContactSolution(dv=dv, penetrating=rs.active_all,
                           link_contact=rs.link_contact)
