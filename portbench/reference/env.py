"""DeepMimic humanoid imitation (Walk, Punch, Kick), batched, plain PyTorch.

A frozen copy of the Stable-PD path of ``pfpn_torch/envs/deepmimic.py``:
the action tables, ``reset_at`` with reference-state initialization and
the ground-penetration lift, ``step`` through the plain control step of
``engine.py`` with the closed-form phase-wrap re-sync, termination, the
five-term imitation reward on the dense reference tables, and the
197-dim observation. Torque and position control, the torque log and the
multi-task batch are left out.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .spd import build_gains
from . import quaternion as quat
from .loader import LINK_TO_JOINT, MotionData, load_motion
from .motion import apply_base_offset, sample_pose, sync_position_offset
from . import contact as contact_mod
from .dynamics import LinkStates, const, fk, index_const, link_states
from .contact import ContactParams
from .engine import Engine, EngineConfig
from .types import KinematicTree, REVOLUTE, SimState
from .assets import HUMANOID_KD, HUMANOID_KP, humanoid_tree

UP = 1  # y-up

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
        self.device = torch.device("cpu" if device is None else device)
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

        if control_mode != "spd":
            raise ValueError("the reference runs Stable-PD control only")
        cfg = EngineConfig(dt=self.dt, frame_skip=frame_skip,
                           **({"contact": contact_params} if contact_params else {}))
        gains = build_gains(self.tree, HUMANOID_KP, HUMANOID_KD)
        self.engine = Engine(self.tree, cfg, gains)

        self._build_action_space()
        self._build_static_tables()
        self.observation_size = 2 + 15 * 7 + 15 * 6
        self.action_size = len(self.action_mean)

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
        up_vec = torch.zeros(3, device=base_quat.device)
        up_vec[UP] = 1.0
        return quat.quat_to_matrix(quat.quat_from_axis_angle(up_vec, -heading))

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
        """One 30 Hz control step of the batch (deepmimic.py:320-396)
        through the plain control step."""
        t_sph, t_rev, _ = self._action_to_targets(self.unnormalize_action(action))
        duration = self.motion.duration
        sim, active, hist = self.engine.control_step_full(state.sim, t_sph, t_rev)
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
        return self._finish(state, sim, elapsed, off, last_contact)

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

    # -- observation (deepmimic.py:469) -----------------------------------
    def observe(self, state: EnvState, ls: Optional[LinkStates] = None) -> torch.Tensor:
        sim = state.sim
        if ls is None:
            ls = link_states(self.tree, fk(self.tree, sim))
        B = sim.base_pos.shape[0]
        base_height = sim.base_pos[:, UP]
        heading = quat.yaw_about_up(sim.base_quat, UP)
        up_vec = torch.zeros(3, device=sim.base_pos.device)
        up_vec[UP] = 1.0
        inv_head = quat.quat_from_axis_angle(up_vec, -heading)
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
            torch.tensor([0.0, 0.0, 0.0, 1.0], device=sim.base_pos.device))

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

def make(env_name: str, device=None, **kwargs):
    """DeepMimic{Walk,Punch,Kick}-v0; ``kwargs`` go to :class:`DeepMimicEnv`."""
    name = env_name[:-3] if env_name.endswith("-v0") else env_name
    if not name.startswith("DeepMimic"):
        raise ValueError(f"unknown env {env_name}")
    return DeepMimicEnv(motion=name[len("DeepMimic"):].lower(), device=device, **kwargs)
