"""Static kinematic-tree description and batched simulation state.

A frozen copy of the port's counterpart of ``pfpn_tpu/sim/types.py``. :class:`KinematicTree` is the same
host-side NumPy table set. :class:`SimState` is a plain dataclass of tensors
that all carry a leading batch dimension ``B`` (the JAX state is per env and
batched with ``vmap``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

FREE = 0
SPHERICAL = 1
REVOLUTE = 2
FIXED_BASE = 3  # zero-dof base (PyBullet useFixedBase)

# Contact geometry types
GEOM_SPHERE = 0
GEOM_CAPSULE = 1
GEOM_BOX = 2


@dataclasses.dataclass(frozen=True)
class Geom:
    """A collision geometry attached to a movable body (body frame coords)."""

    body: int
    kind: int
    pos: Tuple[float, ...]
    quat: Tuple[float, ...]   # xyzw
    size: Tuple[float, ...]   # sphere: (r,), capsule: (r, half_len), box: half extents
    link: int


@dataclasses.dataclass(frozen=True)
class KinematicTree:
    """Static articulated-body description (host side, NumPy)."""

    nb: int
    parent: np.ndarray
    joint_type: Tuple[int, ...]
    joint_pos: np.ndarray
    joint_quat: np.ndarray
    joint_axis: np.ndarray
    body_names: Tuple[str, ...]
    spatial_inertia: np.ndarray
    mass: np.ndarray
    com: np.ndarray
    ndof: int
    dof_offset: np.ndarray
    dof_count: np.ndarray
    sph_index: np.ndarray
    rev_index: np.ndarray
    n_sph: int
    n_rev: int
    link_names: Tuple[str, ...]
    link_body: np.ndarray
    link_pos: np.ndarray
    link_quat: np.ndarray
    link_inertial_pos: np.ndarray
    link_inertial_quat: np.ndarray
    link_mass: np.ndarray
    link_parent: np.ndarray
    motor_bodies: Tuple[int, ...]
    motor_names: Tuple[str, ...]
    motor_is_spherical: Tuple[bool, ...]
    motor_torque_limit: np.ndarray
    motor_movement_limit: np.ndarray
    geoms: Tuple[Geom, ...]

    def link_index(self, name: str) -> int:
        return self.link_names.index(name)


@dataclasses.dataclass
class SimState:
    """Batched dynamic state; every field has a leading batch dim ``B``.

    Base velocities are world-frame; joint velocities local/child-frame.
    """

    base_pos: torch.Tensor    # (B, 3)
    base_quat: torch.Tensor   # (B, 4) xyzw
    base_lin: torch.Tensor    # (B, 3)
    base_ang: torch.Tensor    # (B, 3)
    q_sph: torch.Tensor       # (B, n_sph, 4)
    w_sph: torch.Tensor       # (B, n_sph, 3)
    q_rev: torch.Tensor       # (B, n_rev)
    w_rev: torch.Tensor       # (B, n_rev)

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)


def tree_map(fn, *states):
    """Apply ``fn`` field by field across dataclass states of one type."""
    first = states[0]
    return dataclasses.replace(first, **{
        f.name: (tree_map(fn, *[getattr(s, f.name) for s in states])
                 if dataclasses.is_dataclass(getattr(first, f.name))
                 else fn(*[getattr(s, f.name) for s in states]))
        for f in dataclasses.fields(first)})


def zero_state(tree: KinematicTree, batch: int,
               device=None) -> SimState:
    z = lambda *s: torch.zeros((batch,) + s, device=device)  # noqa: E731
    base_quat = z(4)
    base_quat[:, 3] = 1.0
    q_sph = z(tree.n_sph, 4)
    q_sph[..., 3] = 1.0
    return SimState(base_pos=z(3), base_quat=base_quat, base_lin=z(3),
                    base_ang=z(3), q_sph=q_sph, w_sph=z(tree.n_sph, 3),
                    q_rev=z(tree.n_rev), w_rev=z(tree.n_rev))
