"""The 600 Hz fused Stable-PD substep and the 30 Hz control step, plain PyTorch.

A frozen copy of the plain path of ``pfpn_torch/sim/engine.py``: the
recursive dynamics (FK, CRBA, RNEA), the SPD errors, the contact and limit
rows and :func:`~.substep.substep_core_reference`, looped ``frame_skip``
times as the megastep's plain version loops them
(``pfpn_torch/ops/megastep.py``, ``Megastep.plain``). No kernel, no
batched-dynamics option.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import contact as contact_mod
from .contact import ContactParams, ContactSet
from .dynamics import advance, const, crba, fk, link_states, pack_velocity, rnea
from .spd import SPDGains, spd_errors
from .substep import SubstepMeta, substep_core_reference
from .types import KinematicTree, REVOLUTE, SimState


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    dt: float = 1.0 / 600.0
    frame_skip: int = 20
    gravity: Tuple[float, float, float] = (0.0, -9.8, 0.0)
    contact: ContactParams = dataclasses.field(default_factory=ContactParams)


class Engine:
    """Binds a kinematic tree, gains and config into batched step functions."""

    def __init__(self, tree: KinematicTree, config: EngineConfig, gains: SPDGains):
        self.tree = tree
        self.config = config
        self.gains = gains
        self.contact_set: ContactSet = contact_mod.build_contact_set(tree)
        self.substep_meta = self._build_substep_meta()
        lo = np.full(tree.n_rev, -np.inf)
        hi = np.full(tree.n_rev, np.inf)
        for m, b in enumerate(tree.motor_bodies):
            if tree.joint_type[b] == REVOLUTE:
                lo_m, hi_m = tree.motor_movement_limit[m]
                if hi_m > lo_m:
                    lo[int(tree.rev_index[b])] = lo_m
                    hi[int(tree.rev_index[b])] = hi_m
        self._rev_lo, self._rev_hi = lo, hi

    def _build_substep_meta(self) -> SubstepMeta:
        tree, cfg = self.tree, self.config
        sph_motors, rev_motors = [], []
        for m, b in enumerate(tree.motor_bodies):
            d = int(tree.dof_offset[b])
            lim = float(tree.motor_torque_limit[m])
            (rev_motors if tree.joint_type[b] == REVOLUTE else sph_motors).append((d, lim))
        n_cand = self.contact_set.body.shape[0]
        k = (cfg.contact.max_contacts
             if cfg.contact.max_contacts is not None
             and cfg.contact.max_contacts < n_cand else n_cand)
        return SubstepMeta(
            ndof=tree.ndof, kd=tuple(float(x) for x in self.gains.kd),
            dt=cfg.dt, sph_motors=tuple(sph_motors),
            rev_motors=tuple(rev_motors), n_contacts=int(k),
            n_limits=int(self.contact_set.limit_dof.shape[0]),
            mu=cfg.contact.mu, cfm=cfg.contact.cfm,
            iterations=cfg.contact.iterations,
            relaxation=cfg.contact.relaxation)

    def substep(self, state: SimState, target_sph, target_rev):
        """One fused SPD substep. Returns (state', active_all (B, n_cand))."""
        tree, cfg = self.tree, self.config
        fkr = fk(tree, state)
        h = crba(tree, fkr)
        c = rnea(tree, fkr, gravity=cfg.gravity)
        v = pack_velocity(tree, state, fkr)
        e_p, e_dp = spd_errors(tree, self.gains, state, target_sph, target_rev, cfg.dt)
        kpe = const(self.gains.kp, h) * e_p + const(self.gains.kd, h) * e_dp
        rs = contact_mod.assemble_rows(tree, self.contact_set, cfg.contact,
                                       fkr, state.q_rev, cfg.dt)
        v_new = substep_core_reference(self.substep_meta, h, kpe - c, kpe, v,
                                       rs.rows, rs.target, rs.act_n, rs.act_l)
        state = self._clamp_limits(advance(tree, state, fkr, v_new, cfg.dt))
        return state, rs.active_all

    def control_step_full(self, state: SimState, target_sph, target_rev):
        """(state', active_all (B, n_cand) of the last substep, base_hist
        (B, frame_skip, 3))."""
        hist, active = [], None
        for _ in range(self.config.frame_skip):
            state, active = self.substep(state, target_sph, target_rev)
            hist.append(state.base_pos)
        return state, active, torch.stack(hist, 1)

    def control_step_links(self, state: SimState, target_sph, target_rev):
        """:meth:`control_step_full` plus the final link states."""
        sim, active, hist = self.control_step_full(state, target_sph, target_rev)
        return sim, active, hist, link_states(self.tree, fk(self.tree, sim))

    def link_contact_from_active(self, active: torch.Tensor) -> torch.Tensor:
        """Per-candidate flags (B, n_cand) -> per-link flags (B, nl + 1)."""
        m = contact_mod.link_contact_matrix(self.tree, self.contact_set)
        return (active.float() @ const(m, active)) > 0.5

    def _clamp_limits(self, state: SimState) -> SimState:
        if not self.tree.n_rev:
            return state
        q_rev = torch.clamp(state.q_rev, const(self._rev_lo, state.q_rev),
                            const(self._rev_hi, state.q_rev))
        return state.replace(q_rev=q_rev)
