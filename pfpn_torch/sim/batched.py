"""Level-batched dynamics: forward kinematics, mass matrix and bias force
in a few dense batched products (``EngineConfig.fast_dynamics``).

Counterpart of ``pfpn_tpu/sim/batched.py``. The recursion of
:mod:`~pfpn_torch.sim.dynamics` unrolls per-body loops into hundreds of
small ops; this computes the same quantities for a batch of envs with:

* forward kinematics by tree depth (4 levels for the humanoid), one
  batched quaternion op per level;
* body Jacobians in world-origin spatial coordinates sharing one column
  matrix: column d is [a_d; p_d x a_d] (rotational) or [0; a_d]
  (linear), masked per body by a static ancestor table;
* H = sum_b J_b^T I_b^O J_b and C = sum_b J_b^T (I_b^O (Jdot v) +
  v_b x* I_b^O v_b - I_b^O a_g), with the columns' time derivatives in
  closed form.

The generalized-velocity layout is :mod:`dynamics`' (base body-frame
spatial dofs first), so H, C and v are drop-in. The static tables are
NumPy, built once per tree (:func:`build_tables`) and moved to a device
once (:func:`~pfpn_torch.sim.dynamics.const` caches them). fp32 throughout
(JAX's "high" matmul precision is fp32 off the TPU; TF32 stays off,
``resolve_device``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..math import quaternion as quat
from .dynamics import FKResult, _cross, const, index_const
from .types import FREE, KinematicTree, REVOLUTE, SPHERICAL, SimState


@dataclasses.dataclass(frozen=True)
class BatchedTables:
    levels: Tuple[np.ndarray, ...]       # body indices per tree depth (>0)
    level_parents: Tuple[np.ndarray, ...]
    sph_bodies: np.ndarray               # bodies with spherical joints (sph order)
    rev_bodies: np.ndarray               # bodies with revolute joints (rev order)
    rev_axes: np.ndarray                 # (n_rev, 3) local axes
    joint_quat: np.ndarray               # (nb, 4)
    joint_pos: np.ndarray                # (nb, 3)
    dof_body: np.ndarray                 # (ndof,)
    dof_axis_local: np.ndarray           # (ndof, 3)
    dof_is_linear: np.ndarray            # (ndof,)
    body_mask: np.ndarray                # (nb, ndof) ancestor mask
    sph_dofs: np.ndarray                 # (n_sph * 3,)
    rev_dofs: np.ndarray                 # (n_rev,)
    has_free_base: bool


def build_tables(tree: KinematicTree) -> BatchedTables:
    """The static tables of ``tree`` (batched.py:70)."""
    nb = tree.nb
    depth = np.zeros(nb, dtype=np.int64)
    for i in range(1, nb):
        depth[i] = depth[int(tree.parent[i])] + 1
    levels, parents = [], []
    for d in range(1, int(depth.max()) + 1 if nb > 1 else 1):
        idx = np.where(depth == d)[0]
        levels.append(idx)
        parents.append(np.asarray(tree.parent)[idx])

    sph_bodies = np.full(tree.n_sph, -1, dtype=np.int64)
    rev_bodies = np.full(tree.n_rev, -1, dtype=np.int64)
    rev_axes = np.zeros((tree.n_rev, 3))
    for i in range(1, nb):
        if tree.joint_type[i] == SPHERICAL:
            sph_bodies[int(tree.sph_index[i])] = i
        elif tree.joint_type[i] == REVOLUTE:
            rev_bodies[int(tree.rev_index[i])] = i
            rev_axes[int(tree.rev_index[i])] = tree.joint_axis[i]

    dof_body = np.zeros(tree.ndof, dtype=np.int64)
    dof_axis = np.zeros((tree.ndof, 3))
    dof_lin = np.zeros(tree.ndof, dtype=bool)
    sph_dofs = np.zeros(tree.n_sph * 3, dtype=np.int64)
    rev_dofs = np.zeros(tree.n_rev, dtype=np.int64)
    for i in range(nb):
        d = int(tree.dof_offset[i])
        jt = tree.joint_type[i]
        if jt == FREE:
            dof_body[d:d + 6] = i
            dof_axis[d:d + 3] = np.eye(3)
            dof_axis[d + 3:d + 6] = np.eye(3)
            dof_lin[d + 3:d + 6] = True
        elif jt == SPHERICAL:
            dof_body[d:d + 3] = i
            dof_axis[d:d + 3] = np.eye(3)
            s = int(tree.sph_index[i])
            sph_dofs[3 * s:3 * s + 3] = [d, d + 1, d + 2]
        elif jt == REVOLUTE:
            dof_body[d] = i
            dof_axis[d] = tree.joint_axis[i]
            rev_dofs[int(tree.rev_index[i])] = d

    anc = np.zeros((nb, nb), dtype=bool)
    for b in range(nb):
        j = b
        while j >= 0:
            anc[j, b] = True
            j = int(tree.parent[j])
    body_mask = anc[dof_body, :].T.astype(np.float32)  # (nb, ndof)

    return BatchedTables(
        levels=tuple(levels), level_parents=tuple(parents),
        sph_bodies=sph_bodies, rev_bodies=rev_bodies, rev_axes=rev_axes,
        joint_quat=np.asarray(tree.joint_quat), joint_pos=np.asarray(tree.joint_pos),
        dof_body=dof_body, dof_axis_local=dof_axis, dof_is_linear=dof_lin,
        body_mask=body_mask, sph_dofs=sph_dofs, rev_dofs=rev_dofs,
        has_free_base=tree.joint_type[0] == FREE)


class BatchedDynamics(NamedTuple):
    fkr: FKResult            # body poses and body-frame velocities
    h: torch.Tensor          # (B, ndof, ndof)
    c: torch.Tensor          # (B, ndof) bias incl. gravity
    v: torch.Tensor          # (B, ndof) generalized velocity


def compute(tree: KinematicTree, tb: BatchedTables, state: SimState,
            gravity) -> BatchedDynamics:
    """FK, H, C and v of a batch of states (batched.py:141); ``gravity`` is
    a 3-sequence, as ``EngineConfig.gravity``."""
    nb, ndof = tree.nb, tree.ndof
    ref = state.base_pos
    B = ref.shape[0]
    gravity = const(gravity, ref)

    # ---- position FK, level by level ------------------------------------
    identity = quat.quat_identity((B, nb), device=ref.device)
    rel = identity.clone()
    jq = const(tb.joint_quat, ref)
    if tree.n_sph:
        sph = index_const(tb.sph_bodies, ref)
        rel[:, sph] = quat.quat_multiply(jq[sph], state.q_sph)
    if tree.n_rev:
        rev = index_const(tb.rev_bodies, ref)
        qj = quat.quat_from_axis_angle(
            const(tb.rev_axes, ref).expand(B, -1, -1), state.q_rev)
        rel[:, rev] = quat.quat_multiply(jq[rev], qj)

    q_w = identity
    q_w[:, 0] = state.base_quat
    p_w = torch.zeros(B, nb, 3, device=ref.device)
    p_w[:, 0] = state.base_pos
    jpos = const(tb.joint_pos, ref)
    for lvl, par in zip(tb.levels, tb.level_parents):
        lvl_i, par_i = index_const(lvl, ref), index_const(par, ref)
        qp = q_w[:, par_i]
        q_w[:, lvl_i] = quat.quat_normalize(quat.quat_multiply(qp, rel[:, lvl_i]))
        p_w[:, lvl_i] = p_w[:, par_i] + quat.quat_rotate(qp, jpos[lvl_i])
    R = quat.quat_to_matrix(q_w)                              # (B, nb, 3, 3)

    # ---- generalized velocity (dynamics.pack_velocity's layout) ---------
    v = torch.zeros(B, ndof, device=ref.device)
    if tb.has_free_base:
        R0 = R[:, 0]
        v[:, 0:3] = torch.einsum("bji,bj->bi", R0, state.base_ang)
        v[:, 3:6] = torch.einsum("bji,bj->bi", R0, state.base_lin)
    if tree.n_sph:
        v[:, index_const(tb.sph_dofs, ref)] = state.w_sph.reshape(B, -1)
    if tree.n_rev:
        v[:, index_const(tb.rev_dofs, ref)] = state.w_rev

    # ---- shared Jacobian columns (world-origin spatial coordinates) -----
    dof_body = index_const(tb.dof_body, ref)
    axes = torch.einsum("bdij,dj->bdi", R[:, dof_body], const(tb.dof_axis_local, ref))
    anchors = p_w[:, dof_body]                                # (B, ndof, 3)
    is_lin = index_const(tb.dof_is_linear, ref).bool()[:, None]
    col_ang = torch.where(is_lin, torch.zeros_like(axes), axes)
    col_lin = torch.where(is_lin, axes, _cross(anchors, axes))
    jcols = torch.cat([col_ang, col_lin], -1).transpose(1, 2)  # (B, 6, ndof)
    mask = const(tb.body_mask, ref)                           # (nb, ndof)
    jb = mask[None, :, None, :] * jcols[:, None]              # (B, nb, 6, ndof)

    # ---- world-origin spatial inertia per body --------------------------
    # X (world -> body motion transform) = [[E, 0], [-E p~, E]], E = R^T;
    # I_O = X^T I_body X
    E = R.transpose(-1, -2)
    zero3 = torch.zeros_like(E)
    X = torch.cat([torch.cat([E, zero3], -1),
                   torch.cat([-(E @ _skew_batch(p_w)), E], -1)], -2)  # (B, nb, 6, 6)
    I_O = X.transpose(-1, -2) @ const(tree.spatial_inertia, ref) @ X

    # ---- mass matrix ------------------------------------------------------
    ij = I_O @ jb                                             # (B, nb, 6, ndof)
    h = jb.reshape(B, nb * 6, ndof).transpose(1, 2) @ ij.reshape(B, nb * 6, ndof)

    # ---- bias force ---------------------------------------------------------
    vhat = (jb @ v[:, None, :, None])[..., 0]                 # (B, nb, 6)
    omega = vhat[..., :3]
    # column time derivatives:
    #   rotational dof: [w_b x a ; v_anchor x a + p x (w_b x a)]
    #   linear dof:     [0 ; w_b x a]
    w_d = omega[:, dof_body]
    v_anchor = vhat[:, dof_body, 3:] + _cross(w_d, anchors)
    a_dot = _cross(w_d, axes)
    dcol_ang = torch.where(is_lin, torch.zeros_like(a_dot), a_dot)
    dcol_lin = torch.where(is_lin, a_dot,
                           _cross(v_anchor, axes) + _cross(anchors, a_dot))
    djcols = torch.cat([dcol_ang, dcol_lin], -1).transpose(1, 2)  # (B, 6, ndof)
    a_b = ((mask[None, :, None, :] * djcols[:, None]) @ v[:, None, :, None])[..., 0]
    a_g = torch.cat([torch.zeros(3, device=ref.device), gravity])
    f_b = ((I_O @ (a_b - a_g)[..., None])[..., 0]
           + _crf_batch(vhat, (I_O @ vhat[..., None])[..., 0]))
    c = (jb.reshape(B, nb * 6, ndof).transpose(1, 2)
         @ f_b.reshape(B, nb * 6, 1))[..., 0]

    # ---- body-frame velocities for reporting ------------------------------
    v_pb = vhat[..., 3:] + _cross(omega, p_w)                 # body-origin velocity
    v_body = torch.cat([(E @ omega[..., None])[..., 0],
                        (E @ v_pb[..., None])[..., 0]], -1)

    fkr = FKResult(body_quat=q_w, body_pos=p_w, body_rot=R, v=v_body,
                   xup_E=torch.zeros(B, nb, 3, 3, device=ref.device),
                   xup_r=torch.zeros(nb, 3, device=ref.device))
    return BatchedDynamics(fkr=fkr, h=h, c=c, v=v)


def _skew_batch(v: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1),
    ], -2)


def _crf_batch(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v x* f over (..., 6)."""
    w, lin = v[..., :3], v[..., 3:]
    n, ff = f[..., :3], f[..., 3:]
    return torch.cat([_cross(w, n) + _cross(lin, ff), _cross(w, ff)], -1)
