"""Reduced-coordinate rigid-body dynamics (Featherstone), batched PyTorch.

A frozen copy of the port's counterpart of ``pfpn_tpu/sim/dynamics.py:128-397``: forward kinematics,
the CRBA mass matrix, RNEA bias forces, velocity packing, semi-implicit
integration, the motor-torque scatter and Bullet-style link states. Every function takes a batch of
environments (leading dim ``B``); the loops over the static tree unroll in
Python exactly as the JAX version unrolls them at trace time. Generalized
velocity layout (per env):

  v = [base omega (body frame, 3), base linear (body frame, 3),
       per movable joint dofs (spherical: local omega, revolute: rate)]
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from . import quaternion as quat
from .types import FIXED_BASE, FREE, KinematicTree, REVOLUTE, SPHERICAL, SimState


class FKResult(NamedTuple):
    body_quat: torch.Tensor   # (B, nb, 4)
    body_pos: torch.Tensor    # (B, nb, 3)
    body_rot: torch.Tensor    # (B, nb, 3, 3)
    v: torch.Tensor           # (B, nb, 6) spatial velocity, body coords [w; v]
    xup_E: torch.Tensor       # (B, nb, 3, 3) parent->body rotation
    xup_r: torch.Tensor       # (nb, 3) joint origin in parent frame


_CONSTS: dict = {}


def const(x, like: torch.Tensor) -> torch.Tensor:
    """A static NumPy table as an fp32 tensor on ``like``'s device.

    Cached by content and device, so a table crosses to the card once
    instead of once per call (the JAX version bakes them in as XLA
    constants)."""
    a = np.asarray(x, dtype=np.float64)
    key = (a.tobytes(), a.shape, like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.as_tensor(a, dtype=torch.float32, device=like.device)
        _CONSTS[key] = t
    return t


def index_const(x, like: torch.Tensor) -> torch.Tensor:
    """A static NumPy index table as an int64 tensor (cached like const)."""
    a = np.asarray(x, dtype=np.int64)
    key = (a.tobytes(), a.shape, like.device, "index")
    t = _CONSTS.get(key)
    if t is None:
        t = torch.as_tensor(a, device=like.device)
        _CONSTS[key] = t
    return t


def _mv(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., n, k) @ (..., k) -> (..., n)."""
    return (m @ x[..., None])[..., 0]


def _skew(v: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1),
    ], -2)


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b))


def _crm(v, u):
    """Spatial cross product (motion): v x u, batched (..., 6)."""
    w, l = v[..., :3], v[..., 3:]
    uw, ul = u[..., :3], u[..., 3:]
    return torch.cat([_cross(w, uw), _cross(w, ul) + _cross(l, uw)], -1)


def _crf(v, f):
    """Spatial cross product (force): v x* f, batched (..., 6)."""
    w, l = v[..., :3], v[..., 3:]
    n, ff = f[..., :3], f[..., 3:]
    return torch.cat([_cross(w, n) + _cross(l, ff), _cross(w, ff)], -1)


def _xup_matrix(E, r):
    """6x6 motion transform parent->child: [[E, 0], [-E r~, E]] (B, 6, 6)."""
    top = torch.cat([E, torch.zeros_like(E)], -1)
    bot = torch.cat([-E @ _skew(r), E], -1)
    return torch.cat([top, bot], -2)


def _joint_rel_quat(tree: KinematicTree, state: SimState, i: int):
    jq = const(tree.joint_quat[i], state.base_quat)
    jt = tree.joint_type[i]
    if jt == SPHERICAL:
        qj = state.q_sph[:, int(tree.sph_index[i])]
    elif jt == REVOLUTE:
        axis = const(tree.joint_axis[i], state.base_quat)
        qj = quat.quat_from_axis_angle(
            axis, state.q_rev[:, int(tree.rev_index[i])])
    else:
        raise ValueError("base body has no relative joint")
    return quat.quat_multiply(jq, qj)


def _joint_motion_subspace(tree: KinematicTree, i: int) -> np.ndarray:
    """S (6, ni) in child coordinates; static."""
    jt = tree.joint_type[i]
    if jt == FREE:
        return np.eye(6)
    if jt == FIXED_BASE:
        return np.zeros((6, 0))
    if jt == SPHERICAL:
        S = np.zeros((6, 3))
        S[:3, :3] = np.eye(3)
        return S
    S = np.zeros((6, 1))
    S[:3, 0] = tree.joint_axis[i]
    return S


def _joint_qdot(tree: KinematicTree, state: SimState, i: int):
    if tree.joint_type[i] == SPHERICAL:
        return state.w_sph[:, int(tree.sph_index[i])]
    return state.w_rev[:, int(tree.rev_index[i])][:, None]


def fk(tree: KinematicTree, state: SimState) -> FKResult:
    """Forward kinematics + body-frame spatial velocities (dynamics.py:128)."""
    ref = state.base_quat
    B = ref.shape[0]
    q_w: List[torch.Tensor] = [state.base_quat]
    p_w: List[torch.Tensor] = [state.base_pos]
    R_w: List[torch.Tensor] = [quat.quat_to_matrix(state.base_quat)]
    R0t = R_w[0].transpose(-1, -2)
    if tree.joint_type[0] == FIXED_BASE:
        v0 = torch.zeros(B, 6, device=ref.device)
    else:
        v0 = torch.cat([_mv(R0t, state.base_ang), _mv(R0t, state.base_lin)], -1)
    v: List[torch.Tensor] = [v0]
    eye = torch.eye(3, device=ref.device).expand(B, 3, 3)
    E_list: List[torch.Tensor] = [eye]

    for i in range(1, tree.nb):
        p = int(tree.parent[i])
        rel_q = _joint_rel_quat(tree, state, i)
        q_w.append(quat.quat_normalize(quat.quat_multiply(q_w[p], rel_q)))
        r = const(tree.joint_pos[i], ref)
        p_w.append(p_w[p] + R_w[p] @ r)
        R_w.append(quat.quat_to_matrix(q_w[i]))
        E = quat.quat_to_matrix(rel_q).transpose(-1, -2)
        E_list.append(E)
        wp, lp = v[p][:, :3], v[p][:, 3:]
        vi = torch.cat([_mv(E, wp), _mv(E, lp + _cross(wp, r))], -1)
        S = const(_joint_motion_subspace(tree, i), ref)
        vi = vi + _joint_qdot(tree, state, i) @ S.T
        v.append(vi)

    r_all = const(np.concatenate([np.zeros((1, 3)), tree.joint_pos[1:]]), ref)
    return FKResult(
        body_quat=torch.stack(q_w, 1),
        body_pos=torch.stack(p_w, 1),
        body_rot=torch.stack(R_w, 1),
        v=torch.stack(v, 1),
        xup_E=torch.stack(E_list, 1),
        xup_r=r_all,
    )


def crba(tree: KinematicTree, fkr: FKResult) -> torch.Tensor:
    """Composite-rigid-body mass matrix H (B, ndof, ndof) (dynamics.py:175)."""
    nb, ndof = tree.nb, tree.ndof
    ref = fkr.body_pos
    B = ref.shape[0]
    X = [None] * nb
    for i in range(1, nb):
        X[i] = _xup_matrix(fkr.xup_E[:, i], fkr.xup_r[i])

    Ic = [const(tree.spatial_inertia[i], ref).expand(B, 6, 6) for i in range(nb)]
    for i in range(nb - 1, 0, -1):
        p = int(tree.parent[i])
        Ic[p] = Ic[p] + X[i].transpose(-1, -2) @ Ic[i] @ X[i]

    H = torch.zeros(B, ndof, ndof, device=ref.device)
    for i in range(nb - 1, -1, -1):
        ni = int(tree.dof_count[i])
        if ni == 0:
            continue
        S_i = const(_joint_motion_subspace(tree, i), ref)
        di = int(tree.dof_offset[i])
        F = Ic[i] @ S_i
        H[:, di:di + ni, di:di + ni] = S_i.T @ F
        j = i
        while int(tree.parent[j]) >= 0:
            F = X[j].transpose(-1, -2) @ F
            j = int(tree.parent[j])
            nj = int(tree.dof_count[j])
            if nj == 0:
                continue
            S_j = const(_joint_motion_subspace(tree, j), ref)
            dj = int(tree.dof_offset[j])
            blk = S_j.T @ F
            H[:, dj:dj + nj, di:di + ni] = blk
            H[:, di:di + ni, dj:dj + nj] = blk.transpose(-1, -2)
    return H


def rnea(tree: KinematicTree, fkr: FKResult, qdd=None,
         gravity=None) -> torch.Tensor:
    """Recursive Newton-Euler: tau with H qdd + C = tau; qdd=None gives the
    bias force C incl. gravity (dynamics.py:216)."""
    nb = tree.nb
    ref = fkr.body_pos
    if gravity is None:
        gravity = (0.0, -9.8, 0.0)
    gravity = const(gravity, ref)

    X = [None] * nb
    a: List[torch.Tensor] = [None] * nb
    f: List[torch.Tensor] = [None] * nb
    R0t = fkr.body_rot[:, 0].transpose(-1, -2)
    a0 = torch.cat([torch.zeros_like(ref[:, 0]), _mv(R0t, -gravity.expand_as(ref[:, 0]))], -1)
    if qdd is not None and int(tree.dof_count[0]) == 6:
        d0 = int(tree.dof_offset[0])
        a0 = a0 + qdd[:, d0:d0 + 6]
    a[0] = a0
    I0 = const(tree.spatial_inertia[0], ref)
    f[0] = a[0] @ I0.T + _crf(fkr.v[:, 0], fkr.v[:, 0] @ I0.T)

    for i in range(1, nb):
        p = int(tree.parent[i])
        X[i] = _xup_matrix(fkr.xup_E[:, i], fkr.xup_r[i])
        vJ = fkr.v[:, i] - _mv(X[i], fkr.v[:, p])
        ai = _mv(X[i], a[p]) + _crm(fkr.v[:, i], vJ)
        if qdd is not None:
            S = const(_joint_motion_subspace(tree, i), ref)
            di = int(tree.dof_offset[i])
            ni = int(tree.dof_count[i])
            ai = ai + qdd[:, di:di + ni] @ S.T
        a[i] = ai
        Ii = const(tree.spatial_inertia[i], ref)
        f[i] = a[i] @ Ii.T + _crf(fkr.v[:, i], fkr.v[:, i] @ Ii.T)

    tau = torch.zeros(ref.shape[0], tree.ndof, device=ref.device)
    for i in range(nb - 1, -1, -1):
        di = int(tree.dof_offset[i])
        ni = int(tree.dof_count[i])
        if ni:
            S = const(_joint_motion_subspace(tree, i), ref)
            tau[:, di:di + ni] = f[i] @ S
        p = int(tree.parent[i])
        if p >= 0:
            f[p] = f[p] + _mv(X[i].transpose(-1, -2), f[i])
    return tau


def pack_velocity(tree: KinematicTree, state: SimState, fkr: FKResult) -> torch.Tensor:
    """State velocities -> generalized velocity (B, ndof)."""
    parts = [] if tree.joint_type[0] == FIXED_BASE else [fkr.v[:, 0]]
    for i in range(1, tree.nb):
        parts.append(_joint_qdot(tree, state, i))
    return torch.cat(parts, -1)


def _unpack_joint_velocity(tree: KinematicTree, state: SimState, v: torch.Tensor):
    w_sph = state.w_sph.clone()
    w_rev = state.w_rev.clone()
    for i in range(1, tree.nb):
        di = int(tree.dof_offset[i])
        if tree.joint_type[i] == SPHERICAL:
            w_sph[:, int(tree.sph_index[i])] = v[:, di:di + 3]
        else:
            w_rev[:, int(tree.rev_index[i])] = v[:, di]
    return w_sph, w_rev


def advance(tree: KinematicTree, state: SimState, fkr: FKResult,
            v_new: torch.Tensor, dt) -> SimState:
    """Semi-implicit Euler step (dynamics.py:298): velocities already
    updated; integrate positions and re-express the base velocity in the
    world frame with the *post-step* orientation."""
    v_new = torch.clamp(v_new, -100.0, 100.0)
    if tree.joint_type[0] == FIXED_BASE:
        base_pos, base_quat = state.base_pos, state.base_quat
        base_ang = torch.zeros_like(state.base_ang)
        base_lin = torch.zeros_like(state.base_lin)
    else:
        w_b = v_new[:, 0:3]
        l_b = v_new[:, 3:6]
        base_pos = state.base_pos + dt * _mv(fkr.body_rot[:, 0], l_b)
        base_quat = quat.quat_integrate_local(state.base_quat, w_b, dt)
        R0n = quat.quat_to_matrix(base_quat)
        base_ang = _mv(R0n, w_b)
        base_lin = _mv(R0n, l_b)

    w_sph, w_rev = _unpack_joint_velocity(tree, state, v_new)
    q_sph = (quat.quat_integrate_local(state.q_sph, w_sph, dt)
             if tree.n_sph else state.q_sph)
    q_rev = state.q_rev + dt * w_rev if tree.n_rev else state.q_rev
    return state.replace(base_pos=base_pos, base_quat=base_quat,
                         base_ang=base_ang, base_lin=base_lin,
                         q_sph=q_sph, w_sph=w_sph, q_rev=q_rev, w_rev=w_rev)


def apply_joint_torques(tree: KinematicTree, motor_torques: List[torch.Tensor]) -> torch.Tensor:
    """Scatter per-motor torques (B, dof_count) in tree.motor_* order into
    (B, ndof) (dynamics.py:344)."""
    B = motor_torques[0].shape[0]
    tau = torch.zeros(B, tree.ndof, device=motor_torques[0].device)
    for m, b in enumerate(tree.motor_bodies):
        di = int(tree.dof_offset[b])
        tau[:, di:di + int(tree.dof_count[b])] = motor_torques[m]
    return tau


class LinkStates(NamedTuple):
    frame_pos: torch.Tensor    # (B, nl, 3)
    frame_quat: torch.Tensor   # (B, nl, 4)
    com_pos: torch.Tensor      # (B, nl, 3)
    com_quat: torch.Tensor     # (B, nl, 4)
    lin_vel: torch.Tensor      # (B, nl, 3) world CoM linear velocity
    ang_vel: torch.Tensor      # (B, nl, 3) world angular velocity


def link_states(tree: KinematicTree, fkr: FKResult) -> LinkStates:
    """World-frame states of all URDF links (dynamics.py:368)."""
    b = index_const(tree.link_body, fkr.body_pos)
    R_b = fkr.body_rot[:, b]
    p_b = fkr.body_pos[:, b]
    q_b = fkr.body_quat[:, b]
    v_b = fkr.v[:, b]
    ref = fkr.body_pos
    lp = const(tree.link_pos, ref)
    lq = const(tree.link_quat, ref)
    ip = const(tree.link_inertial_pos, ref)
    iq = const(tree.link_inertial_quat, ref)

    frame_pos = p_b + _mv(R_b, lp.expand_as(p_b))
    frame_quat = quat.quat_multiply(q_b, lq)
    R_f = quat.quat_to_matrix(frame_quat)
    com_pos = frame_pos + _mv(R_f, ip.expand_as(p_b))
    com_quat = quat.quat_multiply(frame_quat, iq)

    w_world = _mv(R_b, v_b[..., :3])
    com_in_body = lp + _mv(quat.quat_to_matrix(lq), ip)
    point_vel_body = v_b[..., 3:] + _cross(v_b[..., :3], com_in_body)
    lin_vel = _mv(R_b, point_vel_body)
    return LinkStates(frame_pos, frame_quat, com_pos, com_quat, lin_vel, w_world)
