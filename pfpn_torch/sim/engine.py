"""Simulation engine: one 600 Hz substep and the 30 Hz control step, batched.

Counterpart of ``pfpn_tpu/sim/engine.py``. :meth:`Engine.substep` has the
JAX engine's three branches (``engine.py:138-205``):

* fused Stable-PD (the default): dynamics, SPD errors and contact rows in
  PyTorch, then the substep's linear algebra through
  :func:`~pfpn_torch.ops.substep_lin.substep_core` (``csrc/substep_lin.cu``
  on the card);
* unfused Stable-PD (``fused=False``, or ``return_torque``): both inverses
  in one :func:`~pfpn_torch.ops.linalg.spd_inverse_pair` launch, then
  :func:`~pfpn_torch.control.spd.spd_accel` and
  :func:`~pfpn_torch.sim.contact.solve`;
* torque and position control: :func:`~pfpn_torch.ops.linalg.spd_inverse`,
  then the motor model and :func:`~pfpn_torch.sim.contact.solve`.

:meth:`Engine.control_step` loops ``frame_skip`` substeps;
:meth:`Engine.control_step_full` runs the whole control step through the
CUDA megastep (:class:`~pfpn_torch.ops.megastep.Megastep`), which exists,
as in JAX (``engine.py:86-92``), only for fused Stable-PD with the megastep
on.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..control.spd import (SPDGains, clamp_torques, implicit_motor_impulses,
                           spd_accel, spd_errors)
from ..ops import linalg
from ..ops import substep_lin
from ..ops.megastep import Megastep, build_meta
from ..ops.substep_lin import SubstepMeta, substep_core_reference
from . import contact as contact_mod
from .contact import ContactParams, ContactSet
from .dynamics import (_mv, advance, apply_joint_torques, const, crba, fk,
                       pack_velocity, rnea)
from .types import KinematicTree, REVOLUTE, SimState


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    dt: float = 1.0 / 600.0
    frame_skip: int = 20
    gravity: Tuple[float, float, float] = (0.0, -9.8, 0.0)
    contact: ContactParams = dataclasses.field(default_factory=ContactParams)
    control_mode: str = "spd"   # "spd" | "torque" | "position"
    # the substep's SPD and contact linear algebra in one kernel
    # (csrc/substep_lin.cu); SPD control only
    fused: bool = True
    # the whole control step in one kernel (csrc/megastep.cu); fused SPD only
    megastep: bool = True


class Engine:
    """Binds a kinematic tree, gains and config into batched step functions."""

    def __init__(self, tree: KinematicTree, config: EngineConfig, gains: SPDGains):
        if config.control_mode not in ("spd", "torque", "position"):
            raise ValueError(f"unknown control mode {config.control_mode!r}")
        self.tree = tree
        self.config = config
        self.gains = gains
        self.contact_set: ContactSet = contact_mod.build_contact_set(tree)
        self.substep_meta = self._build_substep_meta()
        self.fused = config.fused and config.control_mode == "spd"
        self.meta = build_meta(tree, gains, config.contact, self.contact_set,
                               config.dt, config.frame_skip, config.gravity)
        self.mega = (Megastep(self.meta, self._substep_fused_core_full)
                     if config.megastep and self.fused else None)
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

    # -- one 600 Hz physics substep -------------------------------------
    def substep(self, state: SimState, target_sph: torch.Tensor,
                target_rev: torch.Tensor,
                torque_motors: Optional[List[torch.Tensor]] = None,
                return_torque: bool = False):
        """Advance dt. Returns (state', link_contact (B, nl + 1) bool), plus
        the applied per-dof torque (B, ndof) when ``return_torque`` (the
        torque-log channel, which runs the unfused path)."""
        tree, cfg = self.tree, self.config
        dt = cfg.dt
        if self.fused and not return_torque:
            state, rs = self._substep_fused_core(
                state, target_sph, target_rev, substep_lin.substep_core)
            return state, rs.link_contact

        fkr, h, c, v = self._dynamics(state)
        eye = torch.eye(tree.ndof, device=h.device)
        if cfg.control_mode == "spd":
            kd = const(self.gains.kd, h)
            pair = torch.stack([h + torch.diag(kd * dt) + 1e-8 * eye,
                                h + 1e-8 * eye], 1)
            invs = linalg.spd_inverse_pair(pair)
            m_spd_inv, h_inv = invs[:, 0], invs[:, 1]
            a, dtau, tau_applied = spd_accel(tree, self.gains, state, m_spd_inv,
                                             c, target_sph, target_rev, dt)
            # Stable-PD: the unclamped torques accelerate at exactly `a`;
            # only the torque clamp needs an H^-1 correction
            v_star = v + dt * (a + _mv(h_inv, dtau))
        elif cfg.control_mode == "position":
            h_inv = linalg.spd_inverse(h + 1e-8 * eye)
            v_pred = v + dt * _mv(h_inv, -c)
            p = implicit_motor_impulses(tree, state, h_inv, v_pred,
                                        target_sph, target_rev, dt)
            tau_applied = p / dt
            v_star = v_pred + _mv(h_inv, p)
        else:
            h_inv = linalg.spd_inverse(h + 1e-8 * eye)
            tau_applied = apply_joint_torques(tree, clamp_torques(tree, torque_motors))
            v_star = v + dt * _mv(h_inv, tau_applied - c)

        sol = contact_mod.solve(tree, self.contact_set, cfg.contact, fkr, h_inv,
                                v_star, state.q_rev, dt)
        state = self._clamp_limits(advance(tree, state, fkr, v_star + sol.dv, dt))
        if return_torque:
            return state, sol.link_contact, tau_applied
        return state, sol.link_contact

    def _dynamics(self, state: SimState):
        tree = self.tree
        fkr = fk(tree, state)
        h = crba(tree, fkr)
        c = rnea(tree, fkr, gravity=self.config.gravity)
        v = pack_velocity(tree, state, fkr)
        return fkr, h, c, v

    def _substep_fused_core(self, state: SimState, target_sph, target_rev, core):
        """One fused SPD substep with ``core`` as the linear algebra
        (:func:`substep_core` or its plain version). Returns (state', RowSet)."""
        tree, cfg = self.tree, self.config
        fkr, h, c, v = self._dynamics(state)
        e_p, e_dp = spd_errors(tree, self.gains, state, target_sph,
                               target_rev, cfg.dt)
        kpe = const(self.gains.kp, h) * e_p + const(self.gains.kd, h) * e_dp
        rs = contact_mod.assemble_rows(tree, self.contact_set, cfg.contact,
                                       fkr, state.q_rev, cfg.dt)
        v_new = core(self.substep_meta, h, kpe - c, kpe, v,
                     rs.rows, rs.target, rs.act_n, rs.act_l)
        state = advance(tree, state, fkr, v_new, cfg.dt)
        return self._clamp_limits(state), rs

    def _substep_fused_core_full(self, state: SimState, target_sph, target_rev):
        """(state', active_all, base_pos): the megastep's plain substep. It
        always takes the plain substep math, so that the megastep's plain
        version stays plain PyTorch on the card too."""
        state, rs = self._substep_fused_core(state, target_sph, target_rev,
                                             substep_core_reference)
        return state, rs.active_all, state.base_pos

    # -- one 30 Hz control step ------------------------------------------
    def control_step(self, state: SimState, target_sph, target_rev,
                     torque_motors: Optional[List[torch.Tensor]] = None):
        """``frame_skip`` substeps (engine.py:291). Returns (state',
        link_contact (B, nl + 1)) of the last substep, as the reference
        queries contacts after its frame_skip loop."""
        contacts = None
        for _ in range(self.config.frame_skip):
            state, contacts = self.substep(state, target_sph, target_rev,
                                           torque_motors)
        return state, contacts

    def control_step_full(self, state: SimState, target_sph, target_rev):
        """(state', active_all (B, n_cand) bool, base_hist (B, frame_skip, 3)):
        the CUDA megastep on the card, the plain substep loop on the CPU.
        Requires fused SPD with the megastep on."""
        if self.mega is None:
            raise RuntimeError("megastep not enabled")
        return self.mega(state, target_sph, target_rev)

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
