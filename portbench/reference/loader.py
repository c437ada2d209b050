"""DeepMimic mocap loading and host-side preprocessing (NumPy).

A frozen copy of the port's counterpart of ``pfpn_tpu/mocap/loader.py``, with both its branches: the
native library (``mocap/native.py``) when ``csrc/libpfpn_mocap.so`` is
built, else NumPy (``loader.py:211-232``), which ``tests/test_native.py``
holds equal to the native one: frames reordered wxyz -> xyzw, per-frame velocities by
finite difference to the next frame (world-frame for the base rotation,
local-frame for spherical joints), the last frame copying its predecessor,
then every velocity channel through the forward-backward Butterworth filter
at fc = 6 Hz. The motion files are read in place from the JAX package's data
directory (they are data, not code).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np

from .filters import so_fb_butter_lpf
from .types import KinematicTree, SPHERICAL

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MOTION_DIR = os.path.join(_REPO, "pfpn_tpu", "envs", "data", "motions")

# mocap frame slices, keyed by child-link name
FRAME_SLICES = {
    "chest": slice(8, 12),
    "head": slice(12, 16),
    "right_thign": slice(16, 20),
    "right_shin": slice(20, 21),
    "right_foot": slice(21, 25),
    "right_upper_arm": slice(25, 29),
    "right_forearm": slice(29, 30),
    "left_thign": slice(30, 34),
    "left_shin": slice(34, 35),
    "left_foot": slice(35, 39),
    "left_upper_arm": slice(39, 43),
    "left_forearm": slice(43, 44),
}

# link name -> joint name
LINK_TO_JOINT = {
    "chest": "abdomen", "head": "neck",
    "right_thign": "right_hip", "right_shin": "right_knee",
    "right_foot": "right_ankle", "right_upper_arm": "right_shoulder",
    "right_forearm": "right_elbow",
    "left_thign": "left_hip", "left_shin": "left_knee",
    "left_foot": "left_ankle", "left_upper_arm": "left_shoulder",
    "left_forearm": "left_elbow",
}


def _qmul(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array([
        w2 * x1 + x2 * w1 - y2 * z1 + z2 * y1,
        w2 * y1 + x2 * z1 + y2 * w1 - z2 * x1,
        w2 * z1 - x2 * y1 + y2 * x1 + z2 * w1,
        w2 * w1 - x2 * x1 - y2 * y1 - z2 * z1,
    ])


def _qconj(q):
    return np.array([-q[0], -q[1], -q[2], q[3]])


def _axis_angle(q):
    """Shortest-arc rotation vector (axis*angle) of a quaternion."""
    if q[3] < 0:
        q = -q
    s = np.linalg.norm(q[:3])
    if s < 1e-12:
        return np.zeros(3)
    return q[:3] / s * (2.0 * np.arctan2(s, q[3]))


def _angular_vel_global(q0, q1, dt):
    if np.dot(q0, q1) < 0:
        q1 = -q1
    return _axis_angle(_qmul(q1, _qconj(q0))) / dt


def _angular_vel_local(q0, q1, dt):
    if np.dot(q0, q1) < 0:
        q1 = -q1
    return _axis_angle(_qmul(_qconj(q0), q1)) / dt


@dataclasses.dataclass(frozen=True)
class MotionData:
    """Dense per-frame tables (host NumPy, float32)."""

    name: str
    duration: float
    times: np.ndarray        # (N,)
    base_pos: np.ndarray     # (N, 3)
    base_quat: np.ndarray    # (N, 4)
    base_lin: np.ndarray     # (N, 3)
    base_ang: np.ndarray     # (N, 3)
    q_sph: np.ndarray        # (N, n_sph, 4)
    w_sph: np.ndarray        # (N, n_sph, 3)
    q_rev: np.ndarray        # (N, n_rev)
    w_rev: np.ndarray        # (N, n_rev)
    contactable_links: Optional[Tuple[str, ...]]
    loop: str


def _read_frames(path: str):
    if path.endswith(".npz"):
        z = np.load(path, allow_pickle=True)
        frames = np.asarray(z["frames"], dtype=np.float64)
        contactable = (tuple(str(s) for s in z["contactable"])
                       if bool(z["has_contactable"]) else None)
        return frames, str(z["loop"]), contactable
    with open(path) as f:
        data = json.load(f)
    frames = np.asarray(data["Frames"], dtype=np.float64)
    return frames, data.get("Loop", "wrap"), (
        tuple(data["ContactableBodies"]) if "ContactableBodies" in data else None)


def load_motion(tree: KinematicTree, name_or_path: str) -> MotionData:
    """Load a motion by short name ("walk") or explicit file path."""
    if os.path.sep in name_or_path or name_or_path.endswith((".npz", ".txt")):
        path = name_or_path
    else:
        path = os.path.join(MOTION_DIR, f"humanoid3d_{name_or_path}.npz")
    frames, loop, contactable = _read_frames(path)
    n = frames.shape[0]

    # wxyz -> xyzw for the base and every spherical joint slice
    quat_starts = [4] + [sl.start for sl in FRAME_SLICES.values()
                         if sl.stop - sl.start == 4]
    frames = frames.copy()
    for i in quat_starts:
        w = frames[:, i].copy()
        frames[:, i:i + 3] = frames[:, i + 1:i + 4]
        frames[:, i + 3] = w

    dts = frames[:, 0]
    times = np.concatenate([[0.0], np.cumsum(dts[:-1])])
    duration = float(times[-1])
    base_pos = frames[:, 1:4]
    base_quat = frames[:, 4:8]

    sph_of_link, rev_of_link = {}, {}
    motor_index = {nm: i for i, nm in enumerate(tree.motor_names)}
    for link, joint in LINK_TO_JOINT.items():
        b = tree.motor_bodies[motor_index[joint]]
        if tree.joint_type[b] == SPHERICAL:
            sph_of_link[link] = int(tree.sph_index[b])
        else:
            rev_of_link[link] = int(tree.rev_index[b])

    q_sph = np.zeros((n, tree.n_sph, 4))
    q_sph[..., 3] = 1.0
    q_rev = np.zeros((n, tree.n_rev))
    for link, sl in FRAME_SLICES.items():
        if sl.stop - sl.start == 4:
            q_sph[:, sph_of_link[link]] = frames[:, sl]
        else:
            q_rev[:, rev_of_link[link]] = frames[:, sl.start]

    # finite-difference velocities, then Butterworth smoothing of every
    # channel, in NumPy
    fs = 1.0 / float(times[1]) if n > 1 else 30.0
    fc = 6.0
    base_lin = np.zeros((n, 3))
    base_ang = np.zeros((n, 3))
    w_sph = np.zeros((n, tree.n_sph, 3))
    w_rev = np.zeros((n, tree.n_rev))
    for i in range(n - 1):
        dt = dts[i]
        base_lin[i] = (base_pos[i + 1] - base_pos[i]) / dt
        base_ang[i] = _angular_vel_global(base_quat[i], base_quat[i + 1], dt)
        for s in range(tree.n_sph):
            w_sph[i, s] = _angular_vel_local(q_sph[i, s], q_sph[i + 1, s], dt)
        w_rev[i] = (q_rev[i + 1] - q_rev[i]) / dt
    base_lin[-1] = base_lin[-2]
    base_ang[-1] = base_ang[-2]
    w_sph[-1] = w_sph[-2]
    w_rev[-1] = w_rev[-2]

    base_lin = so_fb_butter_lpf(base_lin, fs, fc)
    base_ang = so_fb_butter_lpf(base_ang, fs, fc)
    for s in range(tree.n_sph):
        w_sph[:, s] = so_fb_butter_lpf(w_sph[:, s], fs, fc)
    w_rev = so_fb_butter_lpf(w_rev, fs, fc)

    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return MotionData(
        name=os.path.basename(path), duration=duration, times=f32(times),
        base_pos=f32(base_pos), base_quat=f32(base_quat),
        base_lin=f32(base_lin), base_ang=f32(base_ang),
        q_sph=f32(q_sph), w_sph=f32(w_sph), q_rev=f32(q_rev), w_rev=f32(w_rev),
        contactable_links=contactable, loop=loop)
