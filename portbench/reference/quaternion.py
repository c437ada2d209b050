"""Batched quaternion / SO(3) algebra in PyTorch.

A frozen copy of the port's counterpart of ``pfpn_tpu/math/quaternion.py`` with the same conventions:
quaternions are ``(x, y, z, w)``; every function broadcasts over leading
batch dimensions with the quaternion (4) or vector (3) in the last axis.
``quat_diff(q0, q1)`` is the global-frame difference ``q1 * conj(q0)``,
``quat_diff_rel(q0, q1)`` the local-frame ``conj(q0) * q1``.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b))


def quat_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2 in xyzw order."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w2 * x1 + x2 * w1 - y2 * z1 + z2 * y1,
        w2 * y1 + x2 * z1 + y2 * w1 - z2 * x1,
        w2 * z1 - x2 * y1 + y2 * x1 + z2 * w1,
        w2 * w1 - x2 * x1 - y2 * y1 - z2 * z1,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def quat_diff(q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    """Global-frame difference: rotation taking q0 to q1 in world coords."""
    return quat_multiply(q1, quat_conjugate(q0))


def quat_diff_rel(q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    """Local-frame difference conj(q0) ⊗ q1."""
    return quat_multiply(quat_conjugate(q0), q1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q: v + w t + u x t with t = 2 u x v."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(u, v)
    return v + w * t + _cross(u, t)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conjugate(q), v)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix from quaternion."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (xyzw): of the four candidates (w, x, y
    or z major), the one whose diagonal term is largest."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def major(d):
        return torch.sqrt(torch.clamp(d, min=_EPS)) * 0.5

    qw0 = major(1.0 + tr)
    c0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, 4.0 * qw0 * qw0], -1)
    qx1 = major(1.0 + m00 - m11 - m22)
    c1 = torch.stack([4.0 * qx1 * qx1, m01 + m10, m02 + m20, m21 - m12], -1)
    qy2 = major(1.0 - m00 + m11 - m22)
    c2 = torch.stack([m01 + m10, 4.0 * qy2 * qy2, m12 + m21, m02 - m20], -1)
    qz3 = major(1.0 - m00 - m11 + m22)
    c3 = torch.stack([m02 + m20, m12 + m21, 4.0 * qz3 * qz3, m10 - m01], -1)
    cands = torch.stack([c0 / (4.0 * qw0[..., None]), c1 / (4.0 * qx1[..., None]),
                         c2 / (4.0 * qy2[..., None]), c3 / (4.0 * qz3[..., None])], -2)
    best = torch.argmax(torch.stack([tr, m00, m11, m22], -1), dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Quaternion from (not necessarily unit) axis and angle; a near-zero
    axis gives the identity."""
    n = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    u = axis / torch.clamp(n, min=_EPS)
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    half = torch.where(n[..., 0] > _EPS, angle, torch.zeros_like(angle))
    half = half[..., None] * 0.5
    return torch.cat([u * torch.sin(half), torch.cos(half)], dim=-1)


def quat_to_axis_angle(q: torch.Tensor):
    """Shortest-path (axis, angle) with angle in [0, pi]; (1, 0, 0) axis at
    the identity."""
    q = torch.where(q[..., 3:4] < 0, -q, q)
    v = q[..., :3]
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    s = torch.linalg.vector_norm(v, dim=-1)
    angle = 2.0 * torch.atan2(s, w)
    safe = s > _EPS
    unit_x = torch.tensor([1.0, 0.0, 0.0], dtype=q.dtype, device=q.device)
    axis = torch.where(safe[..., None],
                       v / torch.clamp(s, min=_EPS)[..., None], unit_x)
    return axis, angle


def quat_log(q: torch.Tensor) -> torch.Tensor:
    axis, angle = quat_to_axis_angle(q)
    return axis * angle[..., None]


def quat_exp(v: torch.Tensor) -> torch.Tensor:
    """Quaternion from rotation vector (axis * angle)."""
    angle = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    half = 0.5 * angle
    k = torch.where(angle > 1e-6,
                    torch.sin(half) / torch.clamp(angle, min=_EPS),
                    torch.full_like(angle, 0.5))
    return torch.cat([v * k, torch.cos(half)], dim=-1)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation with shortest-path sign fix and lerp fallback."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)[..., None]
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-5
    den = torch.clamp(sin_theta, min=_EPS)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / den)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / den)
    return quat_normalize(w0 * q0 + w1 * q1)


def angular_velocity_to_quat_derivative(q: torch.Tensor,
                                        omega_local: torch.Tensor) -> torch.Tensor:
    """dq/dt (xyzw) from a local-frame angular velocity: 0.5 q ⊗ (ω, 0)."""
    zero = torch.zeros_like(omega_local[..., :1])
    return 0.5 * quat_multiply(q, torch.cat([omega_local, zero], dim=-1))


def quat_integrate_world(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    return quat_normalize(quat_multiply(quat_exp(omega_world * dt), q))


def quat_integrate_local(q: torch.Tensor, omega_local: torch.Tensor, dt) -> torch.Tensor:
    """Exact exp-map integration with body/local-frame angular velocity."""
    return quat_normalize(quat_multiply(q, quat_exp(omega_local * dt)))


def quat_to_euler_zyx(q: torch.Tensor):
    """(roll, pitch, yaw) with q = Rz(yaw) Ry(pitch) Rx(roll)."""
    x, y, z, w = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return roll, pitch, yaw


def euler_zyx_to_quat(roll, pitch, yaw) -> torch.Tensor:
    """Inverse of quat_to_euler_zyx."""
    roll, pitch, yaw = (torch.as_tensor(a) for a in (roll, pitch, yaw))
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], dim=-1)


def yaw_about_up(q: torch.Tensor, up_dir: int = 1) -> torch.Tensor:
    """Heading angle about the up axis; y-up remaps (x, y, z, w) ->
    (x, -z, y, w) and takes the z-yaw."""
    if up_dir == 1:
        q = torch.stack([q[..., 0], -q[..., 2], q[..., 1], q[..., 3]], dim=-1)
    elif up_dir != 2:
        raise ValueError("up_dir must be 1 (y-up) or 2 (z-up)")
    return quat_to_euler_zyx(q)[2]


def quat_angle(q: torch.Tensor) -> torch.Tensor:
    """Shortest rotation angle of a quaternion in [0, pi]."""
    return quat_to_axis_angle(q)[1]
