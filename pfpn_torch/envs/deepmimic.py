"""DeepMimic humanoid imitation tasks, batched over environments.

Counterpart of ``pfpn_tpu/envs/deepmimic.py``: :func:`make` (Walk, Punch,
Kick, and the multi-task batch of ``envs/multitask.py``), the constructor's
options (``fps``, ``frame_skip``, ``random_init_pose``, ``overtime``,
``control_range``, ``contact_params``, ``exact_ref_reward``), the action
tables and ``_action_to_targets`` of the three control modes (SPD, torque,
position), ``reset`` with reference-state initialization and the
ground-penetration lift, ``step`` (through :meth:`Engine.control_step_full`,
the CUDA megastep on the card, with the closed-form phase-wrap re-sync, or
:meth:`Engine.control_step_links` when ``Engine.megastep_links`` is on:
the megastep's ``emit_links`` variant, whose link states replace the fk
epilogue; or,
with the megastep off or another control mode, a loop of
:meth:`Engine.substep` with the per-substep re-sync), the torque-log
channel (``step_log``, ``torque_log``), the 197-dim observation, the
five-term imitation reward on the dense reference tables (or, with
``exact_ref_reward``, on the reference pose's own FK), ``reward_terms``,
``step_batch`` and ``step_autoreset``, whose plain PyTorch after the
megastep replays as a CUDA graph on the card (:class:`_StepGraph`).

Every function takes the whole batch: the JAX env is per environment and
batched with ``vmap``, here the leading dim ``B`` is written out. Random
phases come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..control.spd import build_gains
from ..math import quaternion as quat
from ..mocap.loader import LINK_TO_JOINT, MotionData, load_motion
from ..mocap.motion import apply_base_offset, sample_pose, sync_position_offset
from ..sim import contact as contact_mod
from ..ops.megastep import Megastep, links_to_states, pack_state, unpack_state
from ..sim.dynamics import LinkStates, const, fk, index_const, link_states
from ..sim.contact import ContactParams
from ..sim.engine import Engine, EngineConfig
from ..sim.types import KinematicTree, REVOLUTE, SimState, tree_map
from .assets import HUMANOID_KD, HUMANOID_KP, humanoid_tree

UP = 1  # y-up
_UP_VEC = np.eye(3)[UP]
_IDENTITY_QUAT = (0.0, 0.0, 0.0, 1.0)

# reward constants (deepmimic.py:62-75)
_SCALES = {"pose": 2.0, "vel": 0.1, "end_eff": 40.0, "root": 5.0, "com": 10.0}
_WEIGHTS_RAW = {"pose": 0.5, "vel": 0.05, "end_eff": 0.15, "root": 0.2, "com": 0.1}
_WSUM = sum(_WEIGHTS_RAW.values())
_WEIGHTS = {k: v / _WSUM for k, v in _WEIGHTS_RAW.items()}
_JOINT_W_RAW = {
    "base": 1.0, "chest": 0.5, "head": 0.3,
    "right_thign": 0.5, "right_shin": 0.3, "right_foot": 0.2,
    "right_upper_arm": 0.3, "right_forearm": 0.2,
    "left_thign": 0.5, "left_shin": 0.3, "left_foot": 0.2,
    "left_upper_arm": 0.3, "left_forearm": 0.2,
}
_JWSUM = sum(_JOINT_W_RAW.values())
JOINT_WEIGHTS = {k: v / _JWSUM for k, v in _JOINT_W_RAW.items()}


@dataclasses.dataclass
class EnvState:
    """Batched env state; every field has a leading batch dim ``B``."""

    sim: SimState
    elapsed_time: torch.Tensor     # (B,)
    init_time: torch.Tensor        # (B,)
    ref_pos_offset: torch.Tensor   # (B, 3) cycle-wrap root offset

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


class StepResult(NamedTuple):
    state: EnvState
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor         # terminal OR truncated
    terminated: torch.Tensor   # true terminal (fall)
    truncated: torch.Tensor    # TimeLimit


class DeepMimicEnv:
    """Binds tree, motion and engine into batched reset/step functions."""

    def __init__(self, motion: str = "walk", control_mode: str = "spd",
                 fps: float = 30.0, frame_skip: int = 20,
                 random_init_pose: bool = True, overtime: float = 20.0,
                 control_range: float = 4.0,
                 contact_params: Optional[ContactParams] = None,
                 exact_ref_reward: bool = False, device=None):
        """The JAX env's constructor (deepmimic.py:81-107); ``overtime`` is
        an episode's time limit in seconds, ``contact_params`` replaces
        ``EngineConfig.contact``."""
        self.device = resolve_device(device)
        self.tree: KinematicTree = humanoid_tree()
        self.motion_name = motion
        self.motion: MotionData = load_motion(self.tree, motion)
        self.fps = fps
        self.frame_skip = frame_skip
        self.dt = 1.0 / (fps * frame_skip)
        self.random_init_pose = random_init_pose
        self.overtime = overtime
        self.exact_ref_reward = exact_ref_reward
        self.control_range = control_range
        self.control_mode = control_mode

        cfg = EngineConfig(dt=self.dt, frame_skip=frame_skip, control_mode=control_mode,
                           **({"contact": contact_params} if contact_params else {}))
        gains = build_gains(self.tree, HUMANOID_KP, HUMANOID_KD)
        self.engine = Engine(self.tree, cfg, gains)

        self._build_action_space()
        self._build_static_tables()
        self.observation_size = 2 + 15 * 7 + 15 * 6
        self.action_size = len(self.action_mean)
        self._graphs = {}
        self.eager_steps = 0
        self.graph_captures = 0
        self.graph_replays = 0

    # -- static tables ---------------------------------------------------
    def _build_action_space(self):
        """Action normalization tables (deepmimic.py:118): targets for SPD
        and position control, torques (one per dof) for torque control."""
        tree = self.tree
        mean, std, lo, hi = [], [], [], []
        self._torque_cols = []   # each motor's torque columns, tree.motor_* order
        if self.control_mode in ("spd", "position"):
            for m, b in enumerate(tree.motor_bodies):
                l, u = tree.motor_movement_limit[m]
                if tree.joint_type[b] == REVOLUTE:
                    mean.append(0.5 * (u + l))
                    std.append((u - l) * 0.5 * self.control_range)
                    lo.append(-1.0)
                    hi.append(1.0)
                else:
                    y_off, z_off = 0.0, 0.2  # y-up
                    mean.extend([0.0, y_off, z_off, 0.0])
                    std.extend([1.0, 1.0, 1.0, (u - l) * 0.5 * self.control_range])
                    lo.extend([-1.0, -1.0 - y_off, -1.0 - z_off, -1.0])
                    hi.extend([1.0, 1.0 - y_off, 1.0 - z_off, 1.0])
        else:
            for m, b in enumerate(tree.motor_bodies):
                n = 1 if tree.joint_type[b] == REVOLUTE else 3
                self._torque_cols.append(slice(len(mean), len(mean) + n))
                mean.extend([0.0] * n)
                std.extend([tree.motor_torque_limit[m]] * n)
                lo.extend([-1.0] * n)
                hi.extend([1.0] * n)
        self.action_mean = np.array(mean, dtype=np.float32)
        self.action_std = np.array(std, dtype=np.float32)
        self.action_low = np.array(lo, dtype=np.float32)
        self.action_high = np.array(hi, dtype=np.float32)

        # action columns of each joint's target, by sph/rev index
        sph_cols = np.zeros((tree.n_sph, 4), dtype=np.int64)
        rev_cols = np.zeros(tree.n_rev, dtype=np.int64)
        i = 0
        for b in tree.motor_bodies:
            if tree.joint_type[b] == REVOLUTE:
                rev_cols[int(tree.rev_index[b])] = i
                i += 1
            else:
                sph_cols[int(tree.sph_index[b])] = np.arange(i, i + 4)
                i += 4
        self._sph_cols, self._rev_cols = sph_cols, rev_cols

    def _build_static_tables(self):
        tree = self.tree
        allowed = np.zeros(len(tree.link_names), dtype=bool)
        if self.motion.contactable_links is not None:
            for nm in self.motion.contactable_links:
                allowed[tree.link_index(nm)] = True
            self.has_termination = True
        else:
            self.has_termination = False
        # per-link slots plus the base slot, which may never touch
        self.contact_allowed = np.concatenate([allowed, [False]])

        children = set(tree.link_parent.tolist())
        ee = [i for i in range(len(tree.link_names)) if i not in children]
        for nm in ("head", "neck"):
            if nm in tree.link_names and tree.link_index(nm) in ee:
                ee.remove(tree.link_index(nm))
        self.end_effectors = np.array(ee, dtype=np.int64)

        self.group_links = []  # (link_name, weight, is_spherical, sph/rev idx)
        motor_index = {nm: i for i, nm in enumerate(tree.motor_names)}
        for link_name, joint_name in LINK_TO_JOINT.items():
            b = tree.motor_bodies[motor_index[joint_name]]
            w = JOINT_WEIGHTS[link_name]
            if tree.joint_type[b] == REVOLUTE:
                self.group_links.append((link_name, w, False, int(tree.rev_index[b])))
            else:
                self.group_links.append((link_name, w, True, int(tree.sph_index[b])))

        self.link_mass = tree.link_mass.astype(np.float32)
        if not self.exact_ref_reward:   # the exact path reads no table
            self._build_ref_tables()

    def _build_ref_tables(self):
        """Dense phase-indexed reference tables (deepmimic.py:186): the
        heading-local end-effector positions and the CoM velocity of the
        reference motion at 600 Hz resolution."""
        n = max(int(round(self.motion.duration * 600.0)),
                2 * len(np.asarray(self.motion.times)))
        ts = torch.as_tensor(np.linspace(0.0, float(self.motion.duration), n + 1),
                             dtype=torch.float32, device=self.device)
        pose = sample_pose(self.motion, ts)
        ls = link_states(self.tree, fk(self.tree, self._sim_from_pose(pose)))
        rot = self._heading_rot(pose.base_quat)
        rp = ls.frame_pos[:, index_const(self.end_effectors, ts)]
        ref_rel = rp - pose.base_pos[:, None]
        ref_rel[..., UP] = rp[..., UP]
        self.ref_ee_local = torch.einsum("bij,bkj->bki", rot, ref_rel)
        mass = const(self.link_mass, ts)[:, None]
        self.ref_com_vel = torch.sum(mass * ls.lin_vel, 1) / float(self.link_mass.sum())
        self.n_ref_samples = n

    def _ref_tables_at(self, time: torch.Tensor):
        """Lerp (ee_local (B, n_ee, 3), com_vel (B, 3)) from the tables."""
        t = torch.remainder(time, self.motion.duration)
        x = t / self.motion.duration * self.n_ref_samples
        i0 = torch.clamp(torch.floor(x).long(), 0, self.n_ref_samples - 1)
        frac = (x - i0.float())[:, None]
        ee = (self.ref_ee_local[i0] * (1.0 - frac[..., None])
              + self.ref_ee_local[i0 + 1] * frac[..., None])
        com = self.ref_com_vel[i0] * (1.0 - frac) + self.ref_com_vel[i0 + 1] * frac
        return ee, com

    # -- helpers ---------------------------------------------------------
    def unnormalize_action(self, a: torch.Tensor) -> torch.Tensor:
        return const(self.action_mean, a) + a * const(self.action_std, a)

    def _action_to_targets(self, action: torch.Tensor):
        """Unnormalized actions (B, A) -> (targets (B, n_sph, 4), (B, n_rev),
        per-motor torques or None) (deepmimic.py:244). Torque control keeps
        identity targets and returns the torques in tree.motor_* order."""
        if self.control_mode == "torque":
            B = action.shape[0]
            t_sph = torch.zeros(B, self.tree.n_sph, 4, device=action.device)
            t_sph[..., 3] = 1.0
            t_rev = torch.zeros(B, self.tree.n_rev, device=action.device)
            return t_sph, t_rev, [action[:, c] for c in self._torque_cols]
        sph = action[:, index_const(self._sph_cols, action)]      # (B, n_sph, 4)
        t_sph = quat.quat_from_axis_angle(sph[..., :3], sph[..., 3])
        t_rev = action[:, index_const(self._rev_cols, action)]
        return t_sph, t_rev, None

    def _sim_from_pose(self, pose) -> SimState:
        return SimState(
            base_pos=pose.base_pos,
            base_quat=quat.quat_normalize(pose.base_quat),
            base_lin=pose.base_lin,
            base_ang=pose.base_ang,
            q_sph=quat.quat_normalize(pose.q_sph),
            w_sph=pose.w_sph,
            q_rev=pose.q_rev,
            w_rev=pose.w_rev,
        )

    def _heading_rot(self, base_quat: torch.Tensor) -> torch.Tensor:
        """(B, 3, 3) rotation undoing the heading about the up axis."""
        heading = quat.yaw_about_up(base_quat, UP)
        return quat.quat_to_matrix(
            quat.quat_from_axis_angle(const(_UP_VEC, base_quat), -heading))

    def phase(self, state: EnvState) -> torch.Tensor:
        p = torch.remainder(state.elapsed_time / self.motion.duration, 1.0)
        return torch.where(p < 0, p + 1.0, p)

    # -- reset -----------------------------------------------------------
    def reset_batch(self, batch: int, generator: Optional[torch.Generator] = None):
        """Reference-state initialization of ``batch`` envs
        (deepmimic.py:284), at phases drawn from ``generator``, or at phase 0
        without ``random_init_pose``."""
        if self.random_init_pose:
            ph = torch.rand(batch, generator=generator, device=self.device)
        else:
            ph = torch.zeros(batch, device=self.device)
        return self.reset_at(ph * self.motion.duration)

    def reset_at(self, init_time: torch.Tensor):
        """Reset to the reference pose at ``init_time`` (B,), lifted out of
        the ground (deepmimic.py:294-300). Returns (state, obs)."""
        pose = sample_pose(self.motion, init_time)
        sim = self._sim_from_pose(pose)
        fkr = fk(self.tree, sim)
        cs = self.engine.contact_set
        x = contact_mod.point_positions(cs, fkr)
        dist = torch.amin(x[..., UP] - const(cs.radius, x), 1) - 0.001
        lift = torch.where(dist < 0, -dist, torch.zeros_like(dist))
        base_pos = sim.base_pos.clone()
        base_pos[:, UP] += lift
        sim = sim.replace(base_pos=base_pos)
        state = EnvState(sim=sim, elapsed_time=init_time.clone(), init_time=init_time,
                         ref_pos_offset=torch.zeros_like(base_pos))
        # the lift is a pure UP-translation: reuse this FK's link states
        ls = link_states(self.tree, fkr)
        frame_pos, com_pos = ls.frame_pos.clone(), ls.com_pos.clone()
        frame_pos[..., UP] += lift[:, None]
        com_pos[..., UP] += lift[:, None]
        ls = ls._replace(frame_pos=frame_pos, com_pos=com_pos)
        return state, self.observe(state, ls=ls)

    # -- step ------------------------------------------------------------
    def step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        """One 30 Hz control step of the batch (deepmimic.py:320-396):
        through the megastep, or, when the engine has none or the actions
        are torques, through ``frame_skip`` substeps."""
        t_sph, t_rev, torques = self._action_to_targets(self.unnormalize_action(action))
        if self.engine.mega is None or torques is not None:
            sim, elapsed, off, last_contact, _ = self._substep_loop(
                state, t_sph, t_rev, torques, return_torque=False)
            return self._finish(state, sim, elapsed, off, last_contact)

        ls = None
        if self.engine.megastep_links:
            # the kernel also emits the final link states, which replace the
            # fk + link_states epilogue of _finish (deepmimic.py:331-336)
            sim, active, hist, ls = self.engine.control_step_links(
                state.sim, t_sph, t_rev)
        else:
            sim, active, hist = self.engine.control_step_full(state.sim, t_sph, t_rev)
        return self._after_megastep(state, sim, active, hist, ls)

    def _after_megastep(self, state: EnvState, sim: SimState, active, hist,
                        ls: Optional[LinkStates]) -> StepResult:
        """The megastep branch of :meth:`step` after the kernel: contacts,
        the phase-wrap re-sync and :meth:`_finish`. ``state.sim`` is not
        read."""
        duration = self.motion.duration
        last_contact = self.engine.link_contact_from_active(active)

        # phase-wrap re-sync (deepmimic.py:340-352): the wrap happens at most
        # once per control step, at a closed-form substep index
        e0 = state.elapsed_time
        elapsed = e0 + self.frame_skip * self.dt
        n1 = torch.floor(elapsed / duration)
        wrapped_any = n1 > torch.floor(e0 / duration)
        t_wrap = n1 * duration
        s_star = torch.clamp(
            torch.ceil((t_wrap - e0) / self.dt - 1e-6).int() - 1,
            0, self.frame_skip - 1).long()
        e_star = e0 + (s_star + 1).float() * self.dt
        rows = torch.arange(hist.shape[0], device=hist.device)
        new_off = sync_position_offset(self.motion, e_star, hist[rows, s_star], UP)
        off = torch.where(wrapped_any[:, None], new_off, state.ref_pos_offset)
        return self._finish(state, sim, elapsed, off, last_contact, ls)

    def _substep_loop(self, state: EnvState, t_sph, t_rev, torques,
                      return_torque: bool):
        """``frame_skip`` engine substeps, re-syncing the reference root
        offset after the substep whose time wraps the motion's phase
        (deepmimic.py:354-371). Returns (sim, elapsed, offset, last
        link_contact, torque history (B, frame_skip, ndof) or None)."""
        duration = self.motion.duration
        sim, elapsed, off = state.sim, state.elapsed_time, state.ref_pos_offset
        taus = []
        for _ in range(self.frame_skip):
            out = self.engine.substep(sim, t_sph, t_rev, torques,
                                      return_torque=return_torque)
            sim, link_contact = out[0], out[1]
            if return_torque:
                taus.append(out[2])
            new_elapsed = elapsed + self.dt
            wrapped = (torch.remainder(new_elapsed, duration)
                       < torch.remainder(elapsed, duration))
            new_off = sync_position_offset(self.motion, new_elapsed, sim.base_pos, UP)
            off = torch.where(wrapped[:, None], new_off, off)
            elapsed = new_elapsed
        return sim, elapsed, off, link_contact, (torch.stack(taus, 1) if taus else None)

    def _finish(self, state: EnvState, sim: SimState, elapsed, off,
                last_contact, ls: Optional[LinkStates] = None) -> StepResult:
        """Termination, reward and observation after a control step; the
        link states of ``sim`` are computed here unless given."""
        state = EnvState(sim=sim, elapsed_time=elapsed,
                         init_time=state.init_time, ref_pos_offset=off)
        if self.has_termination:
            allowed = index_const(self.contact_allowed, last_contact).bool()
            terminated = torch.any(last_contact & ~allowed, 1)
        else:
            terminated = torch.zeros_like(elapsed, dtype=torch.bool)

        if ls is None:
            ls = link_states(self.tree, fk(self.tree, sim))
        reward = self.reward(state, terminated, ls=ls)
        truncated = ~terminated & (elapsed >= self.overtime + state.init_time)
        done = terminated | truncated
        return StepResult(state, self.observe(state, ls=ls), reward, done,
                          terminated, truncated)

    # -- torque-log channel (deepmimic.py:400-466) -------------------------
    def step_log(self, state: EnvState, action: torch.Tensor):
        """Like :meth:`step`, through the unfused substep, also returning
        the applied per-dof torque history (B, frame_skip, ndof): the
        reference's info["log"]["torque"] channel (see :meth:`torque_log`)."""
        t_sph, t_rev, torques = self._action_to_targets(self.unnormalize_action(action))
        sim, elapsed, off, last_contact, tau_hist = self._substep_loop(
            state, t_sph, t_rev, torques, return_torque=True)
        return self._finish(state, sim, elapsed, off, last_contact), tau_hist

    @property
    def torque_channels(self):
        """(name, dof) per logged channel: revolute joints under their name,
        spherical ones under name_{x,y,z} (deepmimic.py:441)."""
        tree = self.tree
        channels = []
        for m, b in enumerate(tree.motor_bodies):
            d = int(tree.dof_offset[b])
            name = tree.motor_names[m]
            if int(tree.joint_type[b]) == REVOLUTE:
                channels.append((name, d))
            else:
                channels.extend((f"{name}_{ax}", d + i) for i, ax in enumerate("xyz"))
        return channels

    def torque_log(self, tau_hist) -> dict:
        """Host-side: (.., frame_skip, ndof) torque history -> the
        reference's named-channel dict of numpy arrays."""
        hist = torch.as_tensor(tau_hist).detach().cpu().numpy()
        return {name: hist[..., d] for name, d in self.torque_channels}

    # -- observation (deepmimic.py:469) -----------------------------------
    def observe(self, state: EnvState, ls: Optional[LinkStates] = None) -> torch.Tensor:
        sim = state.sim
        if ls is None:
            ls = link_states(self.tree, fk(self.tree, sim))
        B = sim.base_pos.shape[0]
        base_height = sim.base_pos[:, UP]
        heading = quat.yaw_about_up(sim.base_quat, UP)
        inv_head = quat.quat_from_axis_angle(const(_UP_VEC, sim.base_pos), -heading)
        rot = quat.quat_to_matrix(inv_head)
        origin = sim.base_pos.clone()
        origin[:, UP] = 0.0

        pos = torch.einsum("bij,blj->bli", rot, ls.com_pos - origin[:, None])
        pos[..., UP] -= base_height[:, None]
        orient = quat.quat_multiply(inv_head[:, None], ls.com_quat)
        # the base link records its world orientation un-rotated
        orient[:, 0] = ls.com_quat[:, 0]
        orient = torch.where(orient[..., 3:4] < 0, -orient, orient)
        lin_vel = ls.lin_vel                                  # world frame
        ang_vel = torch.einsum("bij,blj->bli", rot, ls.ang_vel)

        pos_state = torch.cat([pos, orient], -1).reshape(B, -1)
        vel_state = torch.cat([lin_vel, ang_vel], -1).reshape(B, -1)
        return torch.cat([self.phase(state)[:, None], base_height[:, None],
                          pos_state, vel_state], -1)

    # -- reward (deepmimic.py:504-594) -------------------------------------
    def _reward_errors(self, state: EnvState, ls: Optional[LinkStates]) -> dict:
        sim = state.sim
        if ls is None:
            ls = link_states(self.tree, fk(self.tree, sim))
        ref = apply_base_offset(
            sample_pose(self.motion, state.elapsed_time), state.ref_pos_offset,
            const(_IDENTITY_QUAT, sim.base_pos))

        dq = quat.quat_diff(sim.base_quat, ref.base_quat)
        ang_dq = quat.quat_angle(dq)
        pose_err = JOINT_WEIGHTS["base"] * ang_dq ** 2
        dv = torch.linalg.vector_norm(sim.base_ang - ref.base_ang, dim=-1)
        vel_err = JOINT_WEIGHTS["base"] * dv ** 2
        for _, w, is_sph, idx in self.group_links:
            if is_sph:
                dp = quat.quat_angle(quat.quat_diff(sim.q_sph[:, idx], ref.q_sph[:, idx]))
                dvj = torch.linalg.vector_norm(sim.w_sph[:, idx] - ref.w_sph[:, idx], dim=-1)
            else:
                dp = sim.q_rev[:, idx] - ref.q_rev[:, idx]
                dvj = sim.w_rev[:, idx] - ref.w_rev[:, idx]
            pose_err = pose_err + w * dp ** 2
            vel_err = vel_err + w * dvj ** 2

        # end effectors: heading-local, height kept absolute
        rot = self._heading_rot(sim.base_quat)
        ee = index_const(self.end_effectors, sim.base_pos)
        p = ls.frame_pos[:, ee]
        rel = p - sim.base_pos[:, None]
        rel[..., UP] = p[..., UP]
        m = const(self.link_mass, sim.base_pos)[:, None]
        if self.exact_ref_reward:
            # the reference pose's own FK each step (deepmimic.py:517-545)
            ref_ls = link_states(self.tree, fk(self.tree, self._sim_from_pose(ref)))
            rp = ref_ls.frame_pos[:, ee]
            ref_rel = rp - ref.base_pos[:, None]
            ref_rel[..., UP] = rp[..., UP]
            ref_ee_local = torch.einsum("bij,bkj->bki", self._heading_rot(ref.base_quat),
                                        ref_rel)
            ref_com_vel = torch.sum(m * ref_ls.lin_vel, 1) / float(self.link_mass.sum())
        else:
            ref_ee_local, ref_com_vel = self._ref_tables_at(state.elapsed_time)
        d = torch.einsum("bij,bkj->bki", rot, rel) - ref_ee_local
        end_err = torch.sum(d * d, (1, 2)) / len(self.end_effectors)

        root_pos_err = torch.sum((sim.base_pos - ref.base_pos) ** 2, -1)
        root_rot_err = ang_dq ** 2
        root_vel_err = torch.sum((sim.base_lin - ref.base_lin) ** 2, -1)
        root_ang_err = torch.sum((sim.base_ang - ref.base_ang) ** 2, -1)
        root_err = (root_pos_err + 0.1 * root_rot_err
                    + 0.01 * root_vel_err + 0.001 * root_ang_err)

        com_vel = torch.sum(m * ls.lin_vel, 1) / float(self.link_mass.sum())
        com_err = 0.1 * torch.sum((com_vel - ref_com_vel) ** 2, -1)
        return {"pose": pose_err, "vel": vel_err, "end_eff": end_err,
                "root": root_err, "com": com_err}

    def reward(self, state: EnvState, terminated: torch.Tensor,
               ls: Optional[LinkStates] = None) -> torch.Tensor:
        return sum(self.reward_terms(state, terminated, ls).values())

    def reward_terms(self, state: EnvState, terminated: torch.Tensor,
                     ls: Optional[LinkStates] = None) -> dict:
        """The five weighted exp-of-error terms (deepmimic.py:596), 0 where
        terminated; their sum is :meth:`reward`."""
        e = self._reward_errors(state, ls)
        return {k: torch.where(terminated, torch.zeros_like(e[k]),
                               _WEIGHTS[k] * torch.exp(-_SCALES[k] * e[k]))
                for k in _WEIGHTS}

    # -- batched API ------------------------------------------------------
    def step_batch(self, states: EnvState, actions: torch.Tensor) -> StepResult:
        return self.step(states, actions)

    def step_autoreset(self, states: EnvState, actions: torch.Tensor,
                       generator: Optional[torch.Generator] = None):
        """Batched step with auto-reset on done (deepmimic.py:612).

        Returns (new_states, new_obs, StepResult): the StepResult is the
        pre-reset transition; new_states/new_obs are re-initialized where
        done.

        On the card, through the megastep, with no input requiring grad,
        the step after the megastep launch replays a CUDA graph (see
        :class:`_StepGraph`), one per batch size, megastep variant,
        generator and device: the first call for each runs eagerly, the
        second captures and replays, and the results are bit-equal to the
        eager step's. ``eager_steps``, ``graph_captures`` and
        ``graph_replays`` count what ran."""
        key = self._graph_key(states, actions, generator)
        graph = self._graphs.get(key) if key is not None else None
        if graph is None:
            self.eager_steps += 1
            if key is not None:
                self._graphs[key] = _StepGraph(self, actions.shape[0], generator,
                                               actions.device)
            return self._step_autoreset_eager(states, actions, generator)
        if graph.graph is None:
            graph.capture()
            self.graph_captures += 1
        self.graph_replays += 1
        return graph(states, actions)

    def _step_autoreset_eager(self, states: EnvState, actions: torch.Tensor,
                              generator: Optional[torch.Generator] = None):
        res = self.step_batch(states, actions)
        reset_states, reset_obs = self.reset_batch(actions.shape[0], generator)
        return self._pick_reset(res, reset_states, reset_obs)

    @staticmethod
    def _pick_reset(res: StepResult, reset_states: EnvState, reset_obs: torch.Tensor):
        def pick(r, n):
            return torch.where(res.done.reshape((-1,) + (1,) * (n.ndim - 1)), r, n)

        return (tree_map(pick, reset_states, res.state), pick(reset_obs, res.obs), res)

    def _graph_key(self, states: EnvState, actions: torch.Tensor,
                   generator: Optional[torch.Generator]):
        """The key of the graph that may run this step, or None where the
        step runs eagerly: off the card, off the megastep path, or where an
        input requires grad."""
        mega = self.engine.mega
        if (not actions.is_cuda or mega is None or self.control_mode == "torque"
                or any(t.requires_grad for t in _leaves((states, actions)))):
            return None
        return (actions.shape[0], self.engine.megastep_links, generator,
                actions.device, mega)


def _leaves(tree) -> list:
    """The tensors of nested dataclasses, named tuples and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    return [x for t in tree for x in _leaves(t)]


def _rebuild(tree, leaves):
    """``tree`` with its tensors replaced, in order, from the iterator
    ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)})
    items = [_rebuild(t, leaves) for t in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


class _StepGraph:
    """:meth:`DeepMimicEnv.step_autoreset` of one batch size, megastep
    variant, generator and device, with its plain PyTorch after the
    megastep in a CUDA graph.

    A call runs the action tables and the state packing eagerly (a few
    dozen launches), copies the clock fields into a static buffer, launches
    the megastep into static buffers, replays the graph, and clones each of
    the graph's outputs, so that no result aliases a buffer the next replay
    overwrites and each keeps only its own memory alive. The graph holds
    the kernel's flags and link rows, contacts, the phase-wrap re-sync, fk
    and link states (default variant), termination, reward, observation,
    ``reset_batch`` with its draw from the registered generator, and the
    picks: the eager step's operations, in its order, on the same operands.
    The megastep stays a launch of its own, counted and named as in the
    eager step."""

    def __init__(self, env: DeepMimicEnv, batch: int,
                 generator: Optional[torch.Generator], device: torch.device):
        self.env, self.batch, self.generator = env, batch, generator
        self.mega = env.engine.mega
        self.links = env.engine.megastep_links
        # the clock fields: elapsed_time, init_time, ref_pos_offset (3)
        self.clock = torch.empty(batch, 5, device=device)
        self.kernel_out = self.mega.outputs(batch, self.mega.meta.frame_skip,
                                            device, self.links)
        self.graph = None
        self.result = None      # the step's result, static tensors
        self.outputs = None     # its tensors, in _leaves order

    def feed(self, states: EnvState, actions: torch.Tensor) -> None:
        """The eager part: targets, packing, the clock copy, the megastep."""
        env = self.env
        t_sph, t_rev, _ = env._action_to_targets(env.unnormalize_action(actions))
        st = pack_state(self.mega.meta, states.sim)
        torch.cat([states.elapsed_time[:, None], states.init_time[:, None],
                   states.ref_pos_offset], 1, out=self.clock)
        self.mega.run(st, t_sph.reshape(self.batch, -1), t_rev, links=self.links,
                      out=self.kernel_out)

    def body(self) -> None:
        """The step after the megastep, from the static buffers, into
        :attr:`result`."""
        env, meta = self.env, self.mega.meta
        sim_out, active, hist = Megastep.result(*self.kernel_out)[:3]
        sim = unpack_state(meta, sim_out, SimState(*([None] * 8)))
        ls = links_to_states(meta, self.kernel_out[3]) if self.links else None
        # the pre-step sim went into the kernel packed: nothing after it reads it
        pre = EnvState(sim=None, elapsed_time=self.clock[:, 0],
                       init_time=self.clock[:, 1], ref_pos_offset=self.clock[:, 2:])
        res = env._after_megastep(pre, sim, active, hist, ls)
        reset_states, reset_obs = env.reset_batch(self.batch, self.generator)
        self.result = env._pick_reset(res, reset_states, reset_obs)
        self.outputs = _leaves(self.result)

    def capture(self) -> None:
        """Record :meth:`body` as a CUDA graph (no draw is consumed and no
        env steps while capturing)."""
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        # thread_local: other threads of the process (a process group's
        # watchdog, the profiler) may call CUDA while this one captures
        with torch.cuda.device(self.clock.device), \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.body()
        self.graph = graph

    def fresh(self) -> tuple:
        """The step's result: a new copy of each output."""
        return _rebuild(self.result, (x.clone() for x in self.outputs))

    def __call__(self, states: EnvState, actions: torch.Tensor):
        self.feed(states, actions)
        self.graph.replay()
        return self.fresh()


def make(env_name: str, device=None, **kwargs):
    """gym.make-style constructor (deepmimic.py:630): DeepMimic{Walk,Punch,
    Kick}-v0, and DeepMimicMultiTask-v0, the batch of all three
    (``envs/multitask.py``, with the one-hot task id in the observation by
    default). ``kwargs`` go to :class:`DeepMimicEnv`."""
    name = env_name[:-3] if env_name.endswith("-v0") else env_name
    if not name.startswith("DeepMimic"):
        raise ValueError(f"unknown env {env_name}")
    motion = name[len("DeepMimic"):].lower()
    if motion == "multitask":
        from .multitask import MultiTaskEnv
        kwargs.setdefault("task_obs", True)
        return MultiTaskEnv(("walk", "punch", "kick"), device=device, **kwargs)
    return DeepMimicEnv(motion=motion, device=device, **kwargs)

