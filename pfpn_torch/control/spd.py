"""Stable-PD, torque and position control, batched.

Counterpart of ``pfpn_tpu/control/spd.py``: :func:`build_gains` expands the
per-joint gain dicts to per-dof tables, :func:`spd_errors` gives the
one-step-predicted position/velocity errors (spherical error = axis*angle of
the local-frame difference between the exp-map-predicted joint quaternion
and the target), :func:`spd_accel` the unfused Stable-PD acceleration and
torque-clamp correction, :func:`clamp_torques` the torque-mode clamp and
:func:`implicit_motor_impulses` the position-mode motor constraint. The
fused SPD solve is in ``ops/substep_lin.py`` and in the CUDA megastep.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..math import quaternion as quat
from ..sim.dynamics import _mv, const, index_const
from ..sim.types import KinematicTree, REVOLUTE, SimState


class SPDGains(NamedTuple):
    """Per-dof gain tables (ndof,) with zeros on the floating base dofs."""

    kp: np.ndarray
    kd: np.ndarray


def build_gains(tree: KinematicTree, kp_by_joint: dict, kd_by_joint: dict) -> SPDGains:
    kp = np.zeros(tree.ndof)
    kd = np.zeros(tree.ndof)
    for m, b in enumerate(tree.motor_bodies):
        name = tree.motor_names[m]
        d = int(tree.dof_offset[b])
        n = int(tree.dof_count[b])
        kp[d:d + n] = kp_by_joint[name]
        kd[d:d + n] = kd_by_joint[name]
    return SPDGains(kp=kp, kd=kd)


def _motor_dof_tables(tree: KinematicTree):
    """Spherical dofs (n_sph*3,) and revolute dofs (n_rev,), by sph/rev index."""
    sph_dofs = np.zeros((tree.n_sph, 3), dtype=np.int64)
    rev_dofs = np.zeros(tree.n_rev, dtype=np.int64)
    for b in tree.motor_bodies:
        d = int(tree.dof_offset[b])
        if tree.joint_type[b] == REVOLUTE:
            rev_dofs[int(tree.rev_index[b])] = d
        else:
            sph_dofs[int(tree.sph_index[b])] = [d, d + 1, d + 2]
    return sph_dofs.reshape(-1), rev_dofs


def spd_errors(tree: KinematicTree, gains: SPDGains, state: SimState,
               target_sph: torch.Tensor, target_rev: torch.Tensor, dt: float):
    """One-step-predicted errors (B, ndof) each (spd.py:76)."""
    B = state.base_pos.shape[0]
    ref = state.base_pos
    sph_dofs, rev_dofs = _motor_dof_tables(tree)
    e_p = torch.zeros(B, tree.ndof, device=ref.device)
    e_dp = torch.zeros(B, tree.ndof, device=ref.device)
    if tree.n_sph:
        q_pred = quat.quat_integrate_local(state.q_sph, state.w_sph, dt)
        axis, angle = quat.quat_to_axis_angle(
            quat.quat_diff_rel(q_pred, target_sph))
        idx = index_const(sph_dofs, ref)
        e_p[:, idx] = (axis * angle[..., None]).reshape(B, -1)
        e_dp[:, idx] = (-state.w_sph).reshape(B, -1)
    if tree.n_rev:
        pred = state.q_rev + state.w_rev * dt
        idx = index_const(rev_dofs, ref)
        e_p[:, idx] = target_rev - pred
        e_dp[:, idx] = -state.w_rev
    return e_p, e_dp


def _motor_limits(tree: KinematicTree):
    """Static per-joint torque limits ordered by sph/rev index."""
    sph_lim = np.zeros(tree.n_sph)
    rev_lim = np.zeros(tree.n_rev)
    for mi, b in enumerate(tree.motor_bodies):
        if tree.joint_type[b] == REVOLUTE:
            rev_lim[int(tree.rev_index[b])] = tree.motor_torque_limit[mi]
        else:
            sph_lim[int(tree.sph_index[b])] = tree.motor_torque_limit[mi]
    return sph_lim, rev_lim


def _norm_clamp(x: torch.Tensor, lim) -> torch.Tensor:
    """Rescale each 3-vector x (..., 3) to norm at most lim (a float or
    (...))."""
    n = torch.linalg.vector_norm(x, dim=-1)
    scale = torch.where(n > lim, lim / torch.clamp(n, min=1e-9), torch.ones_like(n))
    return x * scale[..., None]


def _clamp_motor_slices(tree: KinematicTree, tau: torch.Tensor):
    """Per-motor torque clamping (agent.py:317-339) of (B, ndof) torques:
    norm rescale for spherical joints, box clip for revolute ones
    (``spd.py:116``). Returns the clamped (B, ndof) torques."""
    B = tau.shape[0]
    sph_dofs, rev_dofs = _motor_dof_tables(tree)
    sph_lim, rev_lim = _motor_limits(tree)
    clamped = tau.clone()
    if tree.n_sph:
        idx = index_const(sph_dofs, tau)
        t3 = tau[:, idx].reshape(B, tree.n_sph, 3)
        clamped[:, idx] = _norm_clamp(t3, const(sph_lim, tau)).reshape(B, -1)
    if tree.n_rev:
        idx = index_const(rev_dofs, tau)
        lim = const(rev_lim, tau)
        clamped[:, idx] = torch.clamp(tau[:, idx], -lim, lim)
    return clamped


def spd_accel(tree: KinematicTree, gains: SPDGains, state: SimState,
              m_spd_inv: torch.Tensor, c: torch.Tensor,
              target_sph: torch.Tensor, target_rev: torch.Tensor, dt: float):
    """Stable-PD acceleration and clamp correction (spd.py:135), with
    m_spd_inv (B, ndof, ndof) = (H + diag(kd dt))^-1 and the bias force
    c (B, ndof).

    Returns (a, delta_tau, tau_clamped), each (B, ndof): qdd = a + H^-1
    delta_tau, and tau_clamped is the applied torque (the torque log)."""
    kp = const(gains.kp, c)
    kd = const(gains.kd, c)
    e_p, e_dp = spd_errors(tree, gains, state, target_sph, target_rev, dt)
    kp_e = kp * e_p
    kd_e = kd * e_dp
    a = _mv(m_spd_inv, kp_e + kd_e - c)
    tau = kp_e + kd_e - kd * a * dt
    tau_clamped = _clamp_motor_slices(tree, tau)
    return a, tau_clamped - tau, tau_clamped


def clamp_torques(tree: KinematicTree, torques: List[torch.Tensor]) -> List[torch.Tensor]:
    """Torque-control-mode clamping (agent.py:317-339) of per-motor torques,
    each (B, 1) or (B, 3), in tree.motor_* order (spd.py:227)."""
    out: List[torch.Tensor] = []
    for mi, b in enumerate(tree.motor_bodies):
        lim = float(tree.motor_torque_limit[mi])
        t = torques[mi]
        if tree.joint_type[b] == REVOLUTE:
            out.append(torch.clamp(t, -lim, lim))
        else:
            out.append(_norm_clamp(t, lim))
    return out


def implicit_motor_impulses(tree: KinematicTree, state: SimState,
                            h_inv: torch.Tensor, v_star: torch.Tensor,
                            target_sph: torch.Tensor, target_rev: torch.Tensor,
                            dt: float, position_gain: float = 0.3,
                            velocity_gain: float = 1.0, iterations: int = 16,
                            relaxation: float = 1.0) -> torch.Tensor:
    """Bullet POSITION_CONTROL motors as a velocity-level constraint
    (spd.py:243): the Delassus operator is the motor-row block of H^-1, the
    impulse is boxed (revolute) or norm-clamped (spherical) to limit * dt,
    and the QP is solved by projected Jacobi with the Gershgorin step.

    Returns the (B, ndof) impulse, zero on the base rows; apply it as
    v += H^-1 p and log p / dt as the torque."""
    B = v_star.shape[0]
    sph_dofs, rev_dofs = _motor_dof_tables(tree)
    sph_lim, rev_lim = _motor_limits(tree)
    m_idx = index_const(np.concatenate([sph_dofs, rev_dofs]), v_star)
    n_s = sph_dofs.shape[0]

    e = torch.zeros(B, tree.ndof, device=v_star.device)
    if tree.n_sph:
        axis, angle = quat.quat_to_axis_angle(
            quat.quat_diff_rel(state.q_sph, target_sph))
        e[:, index_const(sph_dofs, v_star)] = (axis * angle[..., None]).reshape(B, -1)
    if tree.n_rev:
        e[:, index_const(rev_dofs, v_star)] = target_rev - state.q_rev

    r = position_gain * e[:, m_idx] / dt - velocity_gain * v_star[:, m_idx]
    d_mat = h_inv[:, m_idx][:, :, m_idx]
    step = relaxation / torch.clamp(torch.sum(torch.abs(d_mat), -1), min=1e-9)
    cap_sph = const(sph_lim, v_star) * dt
    cap_rev = const(rev_lim, v_star) * dt

    def project(p):
        parts = []
        if tree.n_sph:
            p3 = p[:, :n_s].reshape(B, tree.n_sph, 3)
            parts.append(_norm_clamp(p3, cap_sph).reshape(B, -1))
        if tree.n_rev:
            parts.append(torch.clamp(p[:, n_s:], -cap_rev, cap_rev))
        return torch.cat(parts, -1)

    p = torch.zeros(B, m_idx.shape[0], device=v_star.device)
    for _ in range(iterations):
        p = project(p + step * (r - _mv(d_mat, p)))
    out = torch.zeros(B, tree.ndof, device=v_star.device)
    out[:, m_idx] = p
    return out
