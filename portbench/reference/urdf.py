"""URDF → KinematicTree compiler (host side, NumPy).

A copy of ``pfpn_tpu/sim/urdf.py`` (the port imports nothing of the JAX
package) that compiles URDF text (:func:`load_urdf_string`), as the
humanoid asset renders it. Behavioural notes:

* ``global_scaling`` scales all origins and geometry dimensions; masses are
  unchanged (Bullet semantics).
* Like Bullet *without* ``URDF_USE_INERTIA_FROM_FILE`` (the reference does not
  pass it), inertia tensors in the file are ignored for links that have a
  collision shape: we recompute them from the (scaled) shape and the given
  mass. Links without collision geometry keep the file inertia, scaled by
  ``global_scaling**2``.
* Fixed joints are merged into the parent movable body (Bullet keeps them as
  zero-dof links; dynamics are identical). The original link set is kept in
  reporting tables, in joint declaration order (URDF_MAINTAIN_LINK_ORDER).
* The local inertial (CoM) frame of each link is the URDF inertial origin
  with identity orientation; recomputed shape inertia is rotated into the
  link frame (diagonal for all shapes used here).
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

import numpy as np

from .types import (
    FIXED_BASE, FREE, GEOM_BOX, GEOM_CAPSULE, GEOM_SPHERE, Geom, KinematicTree,
    REVOLUTE, SPHERICAL,
)


# ---------------------------------------------------------------------------
# small numpy quaternion helpers (host side; xyzw)
# ---------------------------------------------------------------------------

def _quat_mul(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array([
        w2 * x1 + x2 * w1 - y2 * z1 + z2 * y1,
        w2 * y1 + x2 * z1 + y2 * w1 - z2 * x1,
        w2 * z1 - x2 * y1 + y2 * x1 + z2 * w1,
        w2 * w1 - x2 * x1 - y2 * y1 - z2 * z1,
    ])


def _quat_to_mat(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _rpy_to_quat(r, p, y):
    # URDF rpy: R = Rz(y) @ Ry(p) @ Rx(r)
    cr, sr = math.cos(r / 2), math.sin(r / 2)
    cp, sp = math.cos(p / 2), math.sin(p / 2)
    cy, sy = math.cos(y / 2), math.sin(y / 2)
    return np.array([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ])


def _compose(p1, q1, p2, q2):
    """Transform (p2, q2) expressed in frame (p1, q1) -> world composition."""
    return p1 + _quat_to_mat(q1) @ p2, _quat_mul(q1, q2)


def _skew(v):
    return np.array([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ])


def spatial_inertia(mass: float, inertia_com: np.ndarray, com: np.ndarray) -> np.ndarray:
    """6x6 spatial inertia about the frame origin.

    Layout: motion vectors are [omega; v]; I = [[I_o, m c~], [m c~^T, m 1]]
    with I_o = I_com + m c~ c~^T (Featherstone RBDA eq. 2.63).
    """
    c = _skew(com)
    out = np.zeros((6, 6))
    out[:3, :3] = inertia_com + mass * (c @ c.T)
    out[:3, 3:] = mass * c
    out[3:, :3] = mass * c.T
    out[3:, 3:] = mass * np.eye(3)
    return out


# ---------------------------------------------------------------------------
# shape inertia (about shape CoM, in shape frame)
# ---------------------------------------------------------------------------

def _shape_inertia(kind: int, size, mass: float) -> np.ndarray:
    if kind == GEOM_SPHERE:
        (r,) = size
        i = 0.4 * mass * r * r
        return np.diag([i, i, i])
    if kind == GEOM_BOX:
        hx, hy, hz = size  # half extents
        sx, sy, sz = 2 * hx, 2 * hy, 2 * hz
        return np.diag([
            mass / 12.0 * (sy * sy + sz * sz),
            mass / 12.0 * (sx * sx + sz * sz),
            mass / 12.0 * (sx * sx + sy * sy),
        ])
    if kind == GEOM_CAPSULE:
        r, hl = size  # radius, cylinder half-length; axis = local z
        h = 2 * hl
        v_cyl = math.pi * r * r * h
        v_sph = 4.0 / 3.0 * math.pi * r ** 3
        m_cyl = mass * v_cyl / (v_cyl + v_sph)
        m_sph = mass * v_sph / (v_cyl + v_sph)
        i_axis = 0.5 * m_cyl * r * r + 0.4 * m_sph * r * r
        i_perp = (
            m_cyl * (h * h / 12.0 + r * r / 4.0)
            + m_sph * (0.4 * r * r + h * h / 4.0 + 3.0 * h * r / 8.0)
        )
        return np.diag([i_perp, i_perp, i_axis])
    raise ValueError(f"unknown geom kind {kind}")


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

def _parse_origin(elem, scale: float):
    pos = np.zeros(3)
    quat = np.array([0.0, 0.0, 0.0, 1.0])
    if elem is not None:
        o = elem.find("origin")
        if o is None:
            o = elem
        xyz = o.get("xyz")
        rpy = o.get("rpy")
        if xyz:
            pos = np.array([float(v) for v in xyz.split()]) * scale
        if rpy:
            quat = _rpy_to_quat(*[float(v) for v in rpy.split()])
    return pos, quat


def _parse_geometry(geom_elem, scale: float):
    for child in geom_elem:
        if child.tag == "sphere":
            return GEOM_SPHERE, (float(child.get("radius")) * scale,)
        if child.tag == "capsule":
            return GEOM_CAPSULE, (
                float(child.get("radius")) * scale,
                0.5 * float(child.get("length")) * scale,
            )
        if child.tag == "box":
            hx, hy, hz = [0.5 * float(v) * scale for v in child.get("size").split()]
            return GEOM_BOX, (hx, hy, hz)
    raise ValueError("unsupported geometry")


def load_urdf_string(xml: str, global_scaling: float = 1.0,
                     use_fixed_base: bool = False) -> KinematicTree:
    """Compile URDF XML text. use_fixed_base pins the root link (zero base
    dofs)."""
    return _compile(ET.fromstring(xml), global_scaling, use_fixed_base)


def _compile(root, global_scaling: float, use_fixed_base: bool) -> KinematicTree:
    s = global_scaling

    links: Dict[str, dict] = {}
    for le in root.findall("link"):
        name = le.get("name")
        inertial = le.find("inertial")
        mass = 0.0
        inertia_file = np.zeros((3, 3))
        ipos = np.zeros(3)
        if inertial is not None:
            mass = float(inertial.find("mass").get("value"))
            ie = inertial.find("inertia")
            if ie is not None:
                ixx, iyy, izz = (float(ie.get(k)) for k in ("ixx", "iyy", "izz"))
                ixy, ixz, iyz = (float(ie.get(k, "0")) for k in ("ixy", "ixz", "iyz"))
                inertia_file = np.array(
                    [[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]]
                ) * (s * s)
            ipos, _ = _parse_origin(inertial, s)
        collision = le.find("collision")
        geom = None
        if collision is not None:
            cpos, cquat = _parse_origin(collision, s)
            kind, size = _parse_geometry(collision.find("geometry"), s)
            geom = dict(kind=kind, size=size, pos=cpos, quat=cquat)
        links[name] = dict(
            name=name, mass=mass, inertia_file=inertia_file, ipos=ipos, geom=geom
        )

    joints = []
    child_links = set()
    for je in root.findall("joint"):
        jpos, jquat = _parse_origin(je, s)
        axis = np.array([0.0, 0.0, 1.0])
        ae = je.find("axis")
        if ae is not None:
            axis = np.array([float(v) for v in ae.get("xyz").split()])
            n = np.linalg.norm(axis)
            if n > 0:
                axis = axis / n
        limit = je.find("limit")
        effort = float(limit.get("effort")) if limit is not None else 0.0
        lower = float(limit.get("lower", "0")) if limit is not None else 0.0
        upper = float(limit.get("upper", "0")) if limit is not None else 0.0
        joints.append(dict(
            name=je.get("name"), type=je.get("type"),
            parent=je.find("parent").get("link"),
            child=je.find("child").get("link"),
            pos=jpos, quat=jquat, axis=axis,
            effort=effort, lower=lower, upper=upper,
        ))
        child_links.add(je.find("child").get("link"))

    root_link = next(le.get("name") for le in root.findall("link")
                     if le.get("name") not in child_links)

    # ---- build movable bodies, merging fixed joints -----------------------
    # per-link: (movable body index, transform body->link)
    link_of: Dict[str, Tuple[int, np.ndarray, np.ndarray]] = {
        root_link: (0, np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
    }
    body_names: List[str] = [root_link]
    parent: List[int] = [-1]
    joint_type: List[int] = [FIXED_BASE if use_fixed_base else FREE]
    joint_pos: List[np.ndarray] = [np.zeros(3)]
    joint_quat: List[np.ndarray] = [np.array([0.0, 0.0, 0.0, 1.0])]
    joint_axis: List[np.ndarray] = [np.array([0.0, 0.0, 1.0])]
    body_links: List[List[Tuple[str, np.ndarray, np.ndarray]]] = [
        [(root_link, np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))]
    ]

    motor_bodies, motor_names, motor_sph = [], [], []
    motor_tlim, motor_mlim = [], []

    link_names: List[str] = []
    link_tbl_body: List[int] = []
    link_tbl_pos: List[np.ndarray] = []
    link_tbl_quat: List[np.ndarray] = []
    link_parent: List[int] = []

    link_name_to_idx: Dict[str, int] = {}

    for j in joints:
        pb, ppos, pquat = link_of[j["parent"]]
        jp, jq = _compose(ppos, pquat, j["pos"], j["quat"])
        if j["type"] == "fixed":
            link_of[j["child"]] = (pb, jp, jq)
            body_links[pb].append((j["child"], jp, jq))
        else:
            if j["type"] == "spherical":
                jt = SPHERICAL
            elif j["type"] in ("revolute", "continuous"):
                jt = REVOLUTE
            else:
                raise ValueError(f"unsupported joint type {j['type']}")
            bi = len(body_names)
            body_names.append(j["child"])
            parent.append(pb)
            joint_type.append(jt)
            joint_pos.append(jp)
            joint_quat.append(jq)
            joint_axis.append(j["axis"])
            body_links.append([(j["child"], np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))])
            link_of[j["child"]] = (bi, np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
            motor_bodies.append(bi)
            motor_names.append(j["name"])
            motor_sph.append(jt == SPHERICAL)
            motor_tlim.append(j["effort"])
            motor_mlim.append((j["lower"], j["upper"]))

        # reporting table follows joint declaration order (Bullet link ids)
        li = len(link_names)
        link_name_to_idx[j["child"]] = li
        link_names.append(j["child"])
        b, tp, tq = link_of[j["child"]]
        link_tbl_body.append(b)
        link_tbl_pos.append(tp)
        link_tbl_quat.append(tq)
        link_parent.append(link_name_to_idx.get(j["parent"], -1))

    nb = len(body_names)

    # ---- inertia & geoms ---------------------------------------------------
    spatial = np.zeros((nb, 6, 6))
    mass_b = np.zeros(nb)
    com_b = np.zeros((nb, 3))
    geoms: List[Geom] = []
    link_inertial_pos, link_inertial_quat, link_mass = [], [], []

    def _link_inertia(linfo):
        """(mass, I_com(3x3) in link frame, com offset in link frame)."""
        g = linfo["geom"]
        if g is not None:
            icom = _shape_inertia(g["kind"], g["size"], linfo["mass"])
            R = _quat_to_mat(g["quat"])
            return linfo["mass"], R @ icom @ R.T, g["pos"]
        return linfo["mass"], linfo["inertia_file"], linfo["ipos"]

    for name, (b, tp, tq) in link_of.items():
        linfo = links[name]
        m, icom, com = _link_inertia(linfo)
        R = _quat_to_mat(tq)
        com_in_body = tp + R @ com
        spatial[b] += spatial_inertia(m, R @ icom @ R.T, com_in_body)
        com_b[b] = (com_b[b] * mass_b[b] + com_in_body * m) / max(mass_b[b] + m, 1e-12)
        mass_b[b] += m
        g = linfo["geom"]
        if g is not None:
            gp, gq = _compose(tp, tq, g["pos"], g["quat"])
            # root link carries Bullet's base link id -1
            geoms.append(Geom(
                body=b, kind=g["kind"], pos=tuple(gp), quat=tuple(gq),
                size=tuple(g["size"]), link=link_name_to_idx.get(name, -1),
            ))

    for name in link_names:
        linfo = links[name]
        link_inertial_pos.append(linfo["ipos"])
        link_inertial_quat.append(np.array([0.0, 0.0, 0.0, 1.0]))
        link_mass.append(linfo["mass"])

    # ---- dof bookkeeping ---------------------------------------------------
    dof_offset, dof_count = [], []
    sph_index = np.full(nb, -1, dtype=np.int64)
    rev_index = np.full(nb, -1, dtype=np.int64)
    off, ns, nr = 0, 0, 0
    for i in range(nb):
        dof_offset.append(off)
        if joint_type[i] == FREE:
            dof_count.append(6)
            off += 6
        elif joint_type[i] == FIXED_BASE:
            dof_count.append(0)
        elif joint_type[i] == SPHERICAL:
            dof_count.append(3)
            sph_index[i] = ns
            ns += 1
            off += 3
        else:
            dof_count.append(1)
            rev_index[i] = nr
            nr += 1
            off += 1

    return KinematicTree(
        nb=nb,
        parent=np.array(parent, dtype=np.int64),
        joint_type=tuple(joint_type),
        joint_pos=np.stack(joint_pos),
        joint_quat=np.stack(joint_quat),
        joint_axis=np.stack(joint_axis),
        body_names=tuple(body_names),
        spatial_inertia=spatial,
        mass=mass_b,
        com=com_b,
        ndof=off,
        dof_offset=np.array(dof_offset, dtype=np.int64),
        dof_count=np.array(dof_count, dtype=np.int64),
        sph_index=sph_index,
        rev_index=rev_index,
        n_sph=ns,
        n_rev=nr,
        link_names=tuple(link_names),
        link_body=np.array(link_tbl_body, dtype=np.int64),
        link_pos=np.stack(link_tbl_pos) if link_tbl_pos else np.zeros((0, 3)),
        link_quat=np.stack(link_tbl_quat) if link_tbl_quat else np.zeros((0, 4)),
        link_inertial_pos=np.stack(link_inertial_pos) if link_inertial_pos else np.zeros((0, 3)),
        link_inertial_quat=np.stack(link_inertial_quat) if link_inertial_quat else np.zeros((0, 4)),
        link_mass=np.array(link_mass),
        link_parent=np.array(link_parent, dtype=np.int64),
        motor_bodies=tuple(motor_bodies),
        motor_names=tuple(motor_names),
        motor_is_spherical=tuple(motor_sph),
        motor_torque_limit=np.array(motor_tlim),
        motor_movement_limit=np.array(motor_mlim) if motor_mlim else np.zeros((0, 2)),
        geoms=tuple(geoms),
    )
