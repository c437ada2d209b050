"""Spherical <-> stacked-revolute (z, y, x euler) joint conversion.

Counterpart of ``pfpn_tpu/math/euler_stack.py``: for humanoid variants whose
spherical joints are three stacked hinges around z, y, x. A joint quaternion
q = Rz(yaw) Ry(pitch) Rx(roll) (xyzw) with its joint-local angular velocity
w becomes three hinge angles and rates in z, y, x order, and back. Unused by
the shipped humanoid (its knees and elbows are single revolutes).
"""

from __future__ import annotations

import torch

from . import quaternion as quat


def spherical_to_stacked_zyx(q: torch.Tensor, w: torch.Tensor):
    """(angles (..., 3) in z, y, x hinge order, rates (..., 3) same order).

    The rates solve omega_parent = da z + db Rz(a) y + dc Rz(a) Ry(b) x;
    the yaw rate is the exact inverse of the recomposition,
    da = (cy vz + sy (cz vx + sz vy)) / cy, as in the JAX package."""
    roll, pitch, yaw = quat.quat_to_euler_zyx(q)
    vx, vy, vz = quat.quat_rotate(q, w).unbind(-1)
    cy_, sy_ = torch.cos(pitch), torch.sin(pitch)
    cz_, sz_ = torch.cos(yaw), torch.sin(yaw)
    d_roll = (cz_ * vx + sz_ * vy) / cy_
    d_pitch = cz_ * vy - sz_ * vx
    d_yaw = (cy_ * vz + sy_ * (cz_ * vx + sz_ * vy)) / cy_
    return (torch.stack([yaw, pitch, roll], dim=-1),
            torch.stack([d_yaw, d_pitch, d_roll], dim=-1))


def stacked_zyx_to_spherical(angles: torch.Tensor, rates: torch.Tensor):
    """Inverse: three hinge (angle, rate) pairs in z, y, x order -> (q, w)
    with w in the composed joint's local frame."""
    batch = angles.shape[:-1]
    pos = quat.quat_identity(batch, dtype=angles.dtype, device=angles.device)
    vel = torch.zeros(batch + (3,), dtype=angles.dtype, device=angles.device)
    axes = torch.eye(3, dtype=angles.dtype, device=angles.device).flip(0)
    for i in range(3):
        axis = axes[i].expand(batch + (3,))
        pos = quat.quat_multiply(
            pos, quat.quat_from_axis_angle(axis, angles[..., i]))
        vel = vel + quat.quat_rotate(pos, rates[..., i, None] * axis)
    return pos, quat.quat_rotate_inv(pos, vel)
