"""PyTorch port: the dynamics, contact-row, SPD and mocap layers against JAX.

The layers under the megastep's plain version, one by one, on inputs made
with numpy from a seed: random poses and velocities for the dynamics,
falling states in ground contact for the contact rows and SPD errors, and
query times on both sides of the clip (and past the wrap) for the mocap.
Bounds are fp32 reassociation of the same formulas: 1e-5 absolute plus
1e-5 relative (mass-matrix entries reach ~45, bias forces ~500).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.control.spd import build_gains as t_build_gains, spd_errors as t_spd_errors  # noqa: E402
from pfpn_torch.envs.assets import humanoid_tree as t_humanoid_tree  # noqa: E402
from pfpn_torch.mocap import loader as t_loader, motion as t_motion  # noqa: E402
from pfpn_torch.sim import contact as t_contact, dynamics as t_dyn  # noqa: E402
from pfpn_torch.sim.types import SimState as TSimState  # noqa: E402
from pfpn_tpu.envs.assets import HUMANOID_KD, HUMANOID_KP, humanoid_tree  # noqa: E402
from pfpn_tpu.sim import contact as j_contact, dynamics as j_dyn  # noqa: E402
from pfpn_tpu.sim.types import SimState as JSimState  # noqa: E402
from pfpn_tpu.control.spd import build_gains as j_build_gains, spd_errors as j_spd_errors  # noqa: E402
from pfpn_tpu.mocap import loader as j_loader, motion as j_motion  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
B = 8


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=what)


def _random_states(tree, seed, height=1.2):
    rng = np.random.default_rng(seed)

    def unit(*shape):
        q = rng.standard_normal(shape + (4,))
        q[..., 3] += 3.0                          # near-upright, joints bent
        return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)

    f = lambda *shape: rng.standard_normal((B,) + shape).astype(np.float32)  # noqa: E731
    base_pos = f(3) * 0.1
    base_pos[:, 1] += height
    return {"base_pos": base_pos, "base_quat": unit(B), "base_lin": f(3),
            "base_ang": f(3), "q_sph": unit(B, tree.n_sph), "w_sph": f(tree.n_sph, 3),
            "q_rev": f(tree.n_rev) * 0.5, "w_rev": f(tree.n_rev)}


def _both(s):
    t = TSimState(**{k: torch.tensor(v) for k, v in s.items()})
    j = JSimState(**{k: jnp.asarray(v) for k, v in s.items()})
    return t, j


def test_dynamics_match_jax():
    tree_t, tree_j = t_humanoid_tree(), humanoid_tree()
    st_t, st_j = _both(_random_states(tree_j, 3))

    def jax_side(st):
        fkr = j_dyn.fk(tree_j, st)
        return (fkr, j_dyn.crba(tree_j, fkr),
                j_dyn.rnea(tree_j, fkr, gravity=jnp.array([0.0, -9.8, 0.0])),
                j_dyn.pack_velocity(tree_j, st, fkr), j_dyn.link_states(tree_j, fkr))

    fkr_j, h_j, c_j, v_j, ls_j = jax.jit(jax.vmap(jax_side))(st_j)
    fkr_t = t_dyn.fk(tree_t, st_t)
    for k in ("body_quat", "body_pos", "body_rot", "v", "xup_E"):
        _close(getattr(fkr_t, k), getattr(fkr_j, k), k)
    _close(t_dyn.crba(tree_t, fkr_t), h_j, "crba")
    _close(t_dyn.rnea(tree_t, fkr_t, gravity=(0.0, -9.8, 0.0)), c_j, "rnea")
    _close(t_dyn.pack_velocity(tree_t, st_t, fkr_t), v_j, "pack_velocity")
    ls_t = t_dyn.link_states(tree_t, fkr_t)
    for k in ls_t._fields:
        _close(getattr(ls_t, k), getattr(ls_j, k), k)
    v_new = np.random.default_rng(4).standard_normal((B, tree_j.ndof)).astype(np.float32)
    adv_j = jax.vmap(lambda s, f, v: j_dyn.advance(tree_j, s, f, v, 1.0 / 600.0))(
        st_j, fkr_j, jnp.asarray(v_new))
    adv_t = t_dyn.advance(tree_t, st_t, fkr_t, torch.tensor(v_new), 1.0 / 600.0)
    for f in dataclasses.fields(TSimState):
        _close(getattr(adv_t, f.name), getattr(adv_j, f.name), f"advance {f.name}")


def test_contact_rows_and_spd_errors_match_jax():
    tree_t, tree_j = t_humanoid_tree(), humanoid_tree()
    s = _random_states(tree_j, 5, height=0.9)
    s["q_sph"][:] = [0.0, 0.0, 0.0, 1.0]          # level feet: tied corners
    s["base_quat"][:] = [0.0, 0.0, 0.0, 1.0]
    st_t, st_j = _both(s)
    cs_t, cs_j = t_contact.build_contact_set(tree_t), j_contact.build_contact_set(tree_j)
    params_t, params_j = t_contact.ContactParams(), j_contact.ContactParams()
    gains_t = t_build_gains(tree_t, HUMANOID_KP, HUMANOID_KD)
    gains_j = j_build_gains(tree_j, HUMANOID_KP, HUMANOID_KD)
    rng = np.random.default_rng(6)
    tgt_sph = rng.standard_normal((B, tree_j.n_sph, 4)).astype(np.float32)
    tgt_sph /= np.linalg.norm(tgt_sph, axis=-1, keepdims=True)
    tgt_rev = rng.standard_normal((B, tree_j.n_rev)).astype(np.float32)

    def jax_side(st, ts, tr):
        fkr = j_dyn.fk(tree_j, st)
        rs = j_contact.assemble_rows(tree_j, cs_j, params_j, fkr, st.q_rev, 1.0 / 600.0)
        return rs, j_spd_errors(tree_j, gains_j, st, ts, tr, 1.0 / 600.0)

    rs_j, (ep_j, edp_j) = jax.jit(jax.vmap(jax_side))(st_j, jnp.asarray(tgt_sph),
                                                      jnp.asarray(tgt_rev))
    rs_t = t_contact.assemble_rows(tree_t, cs_t, params_t, t_dyn.fk(tree_t, st_t),
                                   st_t.q_rev, 1.0 / 600.0)
    for k in ("active_all", "link_contact", "act_n", "act_l"):
        np.testing.assert_array_equal(getattr(rs_t, k).numpy(), np.asarray(getattr(rs_j, k)),
                                      err_msg=k)
    _close(rs_t.rows, rs_j.rows, "rows")
    _close(rs_t.target, rs_j.target, "target")
    assert np.asarray(rs_j.act_n).sum() > 0
    ep_t, edp_t = t_spd_errors(tree_t, gains_t, st_t, torch.tensor(tgt_sph),
                               torch.tensor(tgt_rev), 1.0 / 600.0)
    _close(ep_t, ep_j, "e_p")
    _close(edp_t, edp_j, "e_dp")


def test_mocap_matches_jax():
    tree_t, tree_j = t_humanoid_tree(), humanoid_tree()
    m_t, m_j = t_loader.load_motion(tree_t, "walk"), j_loader.load_motion(tree_j, "walk")
    assert m_t.duration == m_j.duration and m_t.loop == m_j.loop
    assert m_t.contactable_links == m_j.contactable_links
    for f in ("times", "base_pos", "base_quat", "q_sph", "q_rev"):
        np.testing.assert_array_equal(getattr(m_t, f), getattr(m_j, f), err_msg=f)
    for f in ("base_lin", "base_ang", "w_sph", "w_rev"):   # filtered velocities
        _close(getattr(m_t, f), getattr(m_j, f), f)

    rng = np.random.default_rng(7)
    times = rng.uniform(-0.5 * m_j.duration, 2.5 * m_j.duration, 16).astype(np.float32)
    off = rng.standard_normal((16, 3)).astype(np.float32)
    target = rng.standard_normal((16, 3)).astype(np.float32)
    ident = jnp.array([0.0, 0.0, 0.0, 1.0])

    def jax_side(t, o, tp):
        pose = j_motion.sample_pose(m_j, t)
        return (pose, j_motion.apply_base_offset(pose, o, ident),
                j_motion.sync_position_offset(m_j, t, tp))

    pose_j, offs_j, sync_j = jax.jit(jax.vmap(jax_side))(
        jnp.asarray(times), jnp.asarray(off), jnp.asarray(target))
    t = torch.tensor(times)
    pose_t = t_motion.sample_pose(m_t, t)
    offs_t = t_motion.apply_base_offset(pose_t, torch.tensor(off),
                                        torch.tensor([0.0, 0.0, 0.0, 1.0]))
    sync_t = t_motion.sync_position_offset(m_t, t, torch.tensor(target))
    for k in pose_t._fields:
        _close(getattr(pose_t, k), getattr(pose_j, k), f"sample_pose {k}")
        _close(getattr(offs_t, k), getattr(offs_j, k), f"apply_base_offset {k}")
    _close(sync_t, sync_j, "sync_position_offset")
