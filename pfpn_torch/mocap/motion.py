"""Phase-indexed reference-motion queries, batched over environments.

Counterpart of ``pfpn_tpu/mocap/motion.py``: a gather + lerp/slerp over the
dense frame tables at a batch of query times, the cycle-wrap base offset and
the horizontal re-sync of the reference root to the simulated one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..math import quaternion as quat
from ..sim.dynamics import const
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
