"""Stable-PD controller tables and errors, batched.

Counterpart of ``pfpn_tpu/control/spd.py``: :func:`build_gains` expands the
per-joint gain dicts to per-dof tables, :func:`spd_errors` gives the
one-step-predicted position/velocity errors (spherical error = axis*angle of
the local-frame difference between the exp-map-predicted joint quaternion
and the target). The solve itself is in ``ops/substep_lin.py`` and in the
CUDA megastep.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..math import quaternion as quat
from ..sim.dynamics import index_const
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
