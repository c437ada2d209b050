"""Programmatic humanoid asset (DeepMimic 15-link humanoid).

A copy of the tables of ``pfpn_tpu/envs/assets.py``: the 16-link / 15-joint
humanoid at global scale 0.25, compiled through the port's URDF compiler,
and the Stable-PD gain tables. Numbers are the JAX package's, unchanged.
"""

from __future__ import annotations

import io

from .types import KinematicTree
from .urdf import load_urdf_string

# (name, mass, inertial_xyz, collision)
# collision: None | ("sphere", r, xyz, rpy) | ("capsule", (r, length), xyz, rpy)
#          | ("box", (sx, sy, sz), xyz, rpy)
_LINKS = [
    ("base", 0.001, (0, 0, 0), None),
    ("pelvis", 6.0, (0, 0.28, 0), ("sphere", 0.36, (0, 0.28, 0), (0, 0, 0))),
    ("chest", 14.0, (0, 0.48, 0), ("sphere", 0.44, (0, 0.48, 0), (0, 0, 0))),
    ("head", 2.0, (0, 0.7, 0), ("sphere", 0.41, (0, 0.7, 0), (0, 0, 0))),
    ("right_thign", 4.5, (0, -0.84, 0),
     ("capsule", (0.22, 1.2), (0, -0.84, 0), (-1.570796, 0, 0))),
    ("right_shin", 3.0, (0, -0.8, 0),
     ("capsule", (0.2, 1.24), (0, -0.8, 0), (-1.570796, 0, 0))),
    ("right_foot", 1.0, (0.18, -0.09, 0),
     ("box", (0.708, 0.22, 0.36), (0.18, -0.09, 0), (0, 0, 0))),
    ("right_upper_arm", 1.5, (0, -0.56, 0),
     ("capsule", (0.18, 0.72), (0, -0.56, 0), (-1.570796, 0, 0))),
    ("right_forearm", 1.0, (0, -0.48, 0),
     ("capsule", (0.16, 0.54), (0, -0.48, 0), (-1.570796, 0, 0))),
    ("right_hand", 0.5, (0, 0, 0), ("sphere", 0.16, (0, 0, 0), (0, 0, 0))),
    ("left_thign", 4.5, (0, -0.84, 0),
     ("capsule", (0.22, 1.2), (0, -0.84, 0), (-1.570796, 0, 0))),
    ("left_shin", 3.0, (0, -0.8, 0),
     ("capsule", (0.2, 1.24), (0, -0.8, 0), (-1.570796, 0, 0))),
    ("left_foot", 1.0, (0.18, -0.09, 0),
     ("box", (0.708, 0.22, 0.36), (0.18, -0.09, 0), (0, 0, 0))),
    ("left_upper_arm", 1.5, (0, -0.56, 0),
     ("capsule", (0.18, 0.72), (0, -0.56, 0), (-1.570796, 0, 0))),
    ("left_forearm", 1.0, (0, -0.48, 0),
     ("capsule", (0.16, 0.54), (0, -0.48, 0), (-1.570796, 0, 0))),
    ("left_hand", 0.5, (0, 0, 0), ("sphere", 0.16, (0, 0, 0), (0, 0, 0))),
]

# (name, type, parent, child, xyz, axis, effort, lower, upper)
_JOINTS = [
    ("root", "fixed", "base", "pelvis", (0, 0, 0), None, 0, 0, 0),
    ("abdomen", "spherical", "pelvis", "chest", (0, 0.944604, 0), None, 200.0, -1.2, 1.2),
    ("neck", "spherical", "chest", "head", (0, 0.895576, 0), None, 50.0, -1.0, 1.0),
    ("right_hip", "spherical", "pelvis", "right_thign", (0, 0, 0.339548), None, 200.0, -1.57, 2.57),
    ("right_knee", "revolute", "right_thign", "right_shin", (0, -1.686184, 0), (0, 0, 1), 150.0, -3.14, 0.0),
    ("right_ankle", "spherical", "right_shin", "right_foot", (0, -1.639480, 0), None, 90.0, -1.57, 1.57),
    ("right_shoulder", "spherical", "chest", "right_upper_arm", (-0.0962, 0.974, 0.73244), None, 100.0, -3.14, 3.14),
    ("right_elbow", "revolute", "right_upper_arm", "right_forearm", (0, -1.099152, 0), (0, 0, 1), 60.0, 0.0, 3.14),
    ("right_wrist", "fixed", "right_forearm", "right_hand", (0, -1.035788, 0), None, 0, 0, 0),
    ("left_hip", "spherical", "pelvis", "left_thign", (0, 0, -0.339548), None, 200.0, -1.57, 2.57),
    ("left_knee", "revolute", "left_thign", "left_shin", (0, -1.686184, 0), (0, 0, 1), 150.0, -3.14, 0.0),
    ("left_ankle", "spherical", "left_shin", "left_foot", (0, -1.639480, 0), None, 90.0, -1.57, 1.57),
    ("left_shoulder", "spherical", "chest", "left_upper_arm", (-0.0962, 0.974, -0.73244), None, 100.0, -1.5, 3.14),
    ("left_elbow", "revolute", "left_upper_arm", "left_forearm", (0, -1.099152, 0), (0, 0, 1), 60.0, 0.0, 3.14),
    ("left_wrist", "fixed", "left_forearm", "left_hand", (0, -1.035788, 0), None, 0, 0, 0),
]

# Stable-PD gain tables (reference agent.py:178-205)
HUMANOID_KP = {
    "abdomen": 1000.0, "neck": 100.0,
    "right_hip": 500.0, "right_knee": 500.0, "right_ankle": 400.0,
    "right_shoulder": 400.0, "right_elbow": 300.0,
    "left_hip": 500.0, "left_knee": 500.0, "left_ankle": 400.0,
    "left_shoulder": 400.0, "left_elbow": 300.0,
}
HUMANOID_KD = {
    "abdomen": 100.0, "neck": 10.0,
    "right_hip": 50.0, "right_knee": 50.0, "right_ankle": 40.0,
    "right_shoulder": 40.0, "right_elbow": 30.0,
    "left_hip": 50.0, "left_knee": 50.0, "left_ankle": 40.0,
    "left_shoulder": 40.0, "left_elbow": 30.0,
}

# left/right joint pairs, for mirroring a pose (reference agent.py)
HUMANOID_JOINT_PAIRS = (
    ("right_hip", "left_hip"), ("right_knee", "left_knee"),
    ("right_ankle", "left_ankle"), ("right_shoulder", "left_shoulder"),
    ("right_elbow", "left_elbow"),
)

HUMANOID_SCALE = 0.25


def humanoid_urdf_string() -> str:
    """Render the humanoid tables to URDF XML."""
    out = io.StringIO()
    out.write('<robot name="humanoid">\n')
    for name, mass, ipos, coll in _LINKS:
        out.write(f'  <link name="{name}">\n')
        out.write('    <inertial>\n')
        out.write(f'      <origin rpy="0 0 0" xyz="{ipos[0]} {ipos[1]} {ipos[2]}"/>\n')
        out.write(f'      <mass value="{mass}"/>\n')
        out.write('      <inertia ixx="0.1" ixy="0" ixz="0" iyy="0.1" iyz="0" izz="0.1"/>\n')
        out.write('    </inertial>\n')
        if coll is not None:
            kind, size, cpos, crpy = coll
            out.write('    <collision>\n')
            out.write(
                f'      <origin rpy="{crpy[0]} {crpy[1]} {crpy[2]}" '
                f'xyz="{cpos[0]} {cpos[1]} {cpos[2]}"/>\n'
            )
            out.write('      <geometry>\n')
            if kind == "sphere":
                out.write(f'        <sphere radius="{size}"/>\n')
            elif kind == "capsule":
                out.write(f'        <capsule length="{size[1]}" radius="{size[0]}"/>\n')
            else:
                out.write(f'        <box size="{size[0]} {size[1]} {size[2]}"/>\n')
            out.write('      </geometry>\n')
            out.write('    </collision>\n')
        out.write('  </link>\n')
    for name, jtype, parent, child, xyz, axis, effort, lower, upper in _JOINTS:
        out.write(f'  <joint name="{name}" type="{jtype}">\n')
        out.write(f'    <parent link="{parent}"/>\n')
        out.write(f'    <child link="{child}"/>\n')
        out.write(f'    <origin rpy="0 0 0" xyz="{xyz[0]} {xyz[1]} {xyz[2]}"/>\n')
        if axis is not None:
            out.write(f'    <axis xyz="{axis[0]} {axis[1]} {axis[2]}"/>\n')
        if jtype != "fixed":
            out.write(f'    <limit effort="{effort}" lower="{lower}" upper="{upper}"/>\n')
        out.write('  </joint>\n')
    out.write('</robot>\n')
    return out.getvalue()


def humanoid_tree(scale: float = HUMANOID_SCALE) -> KinematicTree:
    return load_urdf_string(humanoid_urdf_string(), global_scaling=scale)
