"""Phase-indexed reference-motion queries, batched over environments.

A frozen copy of the port's counterpart of ``pfpn_tpu/mocap/motion.py``: a gather + lerp/slerp over the
dense frame tables at a batch of query times, the cycle-wrap base offset,
the horizontal re-sync of the reference root to the simulated one, and the
left/right mirror of a pose.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import quaternion as quat
from .dynamics import const
from .loader import MotionData


class MotionPose(NamedTuple):
    """Reference pose at a batch of query times (leading dim B)."""

    base_pos: torch.Tensor    # (B, 3)
    base_quat: torch.Tensor   # (B, 4)
    base_lin: torch.Tensor    # (B, 3)
    base_ang: torch.Tensor    # (B, 3)
    q_sph: torch.Tensor       # (B, n_sph, 4)
    w_sph: torch.Tensor       # (B, n_sph, 3)
    q_rev: torch.Tensor       # (B, n_rev)
    w_rev: torch.Tensor       # (B, n_rev)


def sample_pose(motion: MotionData, time: torch.Tensor) -> MotionPose:
    """Interpolated reference pose at absolute times (B,), wrapping over the
    duration (motion.py:36)."""
    t = torch.remainder(time, motion.duration)
    t = torch.where(t < 0, t + motion.duration, t)
    times = const(motion.times, time)
    n = times.shape[0]
    f0 = torch.clamp(torch.searchsorted(times, t, right=True) - 1, 0, n - 2)
    f1 = f0 + 1
    t0, t1 = times[f0], times[f1]
    frac = (t - t0) / torch.clamp(t1 - t0, min=1e-8)

    def lerp(tbl):
        tbl = const(tbl, time)
        a, b = tbl[f0], tbl[f1]
        fr = frac.reshape(frac.shape + (1,) * (a.ndim - 1))
        return a + fr * (b - a)

    q_sph_tbl = const(motion.q_sph, time)
    bq_tbl = const(motion.base_quat, time)
    return MotionPose(
        base_pos=lerp(motion.base_pos),
        base_quat=quat.quat_slerp(bq_tbl[f0], bq_tbl[f1], frac),
        base_lin=lerp(motion.base_lin),
        base_ang=lerp(motion.base_ang),
        q_sph=quat.quat_slerp(q_sph_tbl[f0], q_sph_tbl[f1], frac[:, None]),
        w_sph=lerp(motion.w_sph),
        q_rev=lerp(motion.q_rev),
        w_rev=lerp(motion.w_rev),
    )


def apply_base_offset(pose: MotionPose, pos_offset: torch.Tensor,
                      quat_offset: torch.Tensor) -> MotionPose:
    """Apply per-env root offsets (motion.py:70)."""
    quat_offset = quat_offset.expand_as(pose.base_quat)
    return pose._replace(
        base_pos=pose.base_pos + pos_offset,
        base_quat=quat.quat_multiply(quat_offset, pose.base_quat),
        base_lin=quat.quat_rotate(quat_offset, pose.base_lin),
        base_ang=quat.quat_rotate(quat_offset, pose.base_ang),
    )


def sync_position_offset(motion: MotionData, time: torch.Tensor,
                         target_base_pos: torch.Tensor,
                         up_dir: int = 1) -> torch.Tensor:
    """New horizontal offset so the unoffset reference root matches the
    simulated root (motion.py:82)."""
    offset = target_base_pos - sample_pose(motion, time).base_pos
    offset[:, up_dir] = 0.0
    return offset


def mirror_pose(pose: MotionPose, tree, joint_pairs, up_dir: int = 1) -> MotionPose:
    """Left/right mirror of a batch of reference poses (motion.py:94, y-up):
    the lateral axis z of base position and velocity negates, the x and y
    components of quaternions and angular velocities negate, revolute joints
    with an x or y axis component negate (the knees and elbows, about z,
    keep their sign), and the left and right joints of ``joint_pairs``
    swap."""
    assert up_dir == 1, "mirror implemented for the y-up humanoid"
    neg_w = torch.tensor([1.0, 1.0, -1.0], device=pose.base_pos.device)
    neg_quat = torch.tensor([-1.0, -1.0, 1.0, 1.0], device=pose.base_pos.device)
    neg_ang = torch.tensor([-1.0, -1.0, 1.0], device=pose.base_pos.device)
    rev_sign = np.ones(tree.n_rev, dtype=np.float32)
    perm_sph, perm_rev = np.arange(tree.n_sph), np.arange(tree.n_rev)
    motor_index = {nm: i for i, nm in enumerate(tree.motor_names)}
    for b in tree.motor_bodies:
        if tree.joint_type[b] == 2:  # REVOLUTE
            ax = tree.joint_axis[b]
            if abs(ax[0]) > 1e-9 or abs(ax[1]) > 1e-9:
                rev_sign[int(tree.rev_index[b])] = -1.0
    for right, left in joint_pairs:
        br = tree.motor_bodies[motor_index[right]]
        bl = tree.motor_bodies[motor_index[left]]
        if tree.joint_type[br] == 1:  # SPHERICAL
            r, l = int(tree.sph_index[br]), int(tree.sph_index[bl])
            perm_sph[r], perm_sph[l] = perm_sph[l], perm_sph[r]
        else:
            r, l = int(tree.rev_index[br]), int(tree.rev_index[bl])
            perm_rev[r], perm_rev[l] = perm_rev[l], perm_rev[r]
    sign = const(rev_sign, pose.q_rev)
    ps = torch.as_tensor(perm_sph, device=pose.base_pos.device)
    pr = torch.as_tensor(perm_rev, device=pose.base_pos.device)
    return MotionPose(
        base_pos=pose.base_pos * neg_w,
        base_quat=pose.base_quat * neg_quat,
        base_lin=pose.base_lin * neg_w,
        base_ang=pose.base_ang * neg_ang,
        q_sph=(pose.q_sph * neg_quat)[:, ps],
        w_sph=(pose.w_sph * neg_ang)[:, ps],
        q_rev=(pose.q_rev * sign)[:, pr],
        w_rev=(pose.w_rev * sign)[:, pr],
    )
