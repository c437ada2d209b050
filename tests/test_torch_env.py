"""PyTorch port: the DeepMimic Walk env against JAX.

JAX and torch draw different random numbers, so the states are built by
the JAX env (``reset_batch``), converted with ``sim_state_from_numpy``, and
both envs step them with the same actions, made with numpy from a seed.
Two of the envs start just before a phase wrap, as in
``tests/test_megastep.py:25-31``, so the closed-form reference re-sync runs.

Bounds: the reference's env-level bounds (``tests/test_megastep.py:46-55``),
as ``tests/test_torch_control.py`` holds the megastep-off step: positions,
quaternions and ``q_rev`` to 1e-5, reward and ``ref_pos_offset`` to 1e-4;
the velocities (``base_lin``, ``base_ang``, ``w_sph``, ``w_rev``), which
carry 20 substeps of fp32 rounding through the 34x34 inverses, to 3e-4; the
observation, whose velocity part carries that error through its scaling,
to 1e-3; ``done`` exactly. The file keeps to four tests, so that pytest-xdist's
loadfile schedule (more tests first) does not start it before
``tests/test_megastep.py``, the suite's longest.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.envs.deepmimic import make as t_make  # noqa: E402
from pfpn_torch.sim.types import sim_state_from_numpy  # noqa: E402
from pfpn_tpu.envs.deepmimic import make as j_make  # noqa: E402

torch.set_num_threads(1)

B = 4
STATE_TOL = 1e-5     # positions, quaternions, q_rev: test_megastep.py:46-50
OFFSET_TOL = 1e-4    # ref_pos_offset and reward: test_megastep.py:51-55
VEL_TOL = 3e-4       # velocities, as tests/test_torch_control.py
OBS_TOL = 1e-3
POS_FIELDS = ("base_pos", "base_quat", "q_sph", "q_rev")
VEL_FIELDS = ("base_lin", "base_ang", "w_sph", "w_rev")
RESET_TOL = 1e-5     # reset: the same closed-form pose, one FK, no dynamics


@pytest.fixture(scope="module")
def envs():
    env_j = j_make("DeepMimicWalk-v0")
    env_t = t_make("DeepMimicWalk-v0", device="cpu")
    state, obs = jax.jit(env_j.reset_batch)(jax.random.split(jax.random.PRNGKey(3), B))
    # two envs just before a phase wrap exercise the re-sync
    et = state.elapsed_time.at[:2].set(env_j.motion.duration - 1.5 * env_j.dt)
    state = state.replace(elapsed_time=et, init_time=et)
    acts = (0.1 * np.random.default_rng(5).standard_normal((B, env_j.action_size))
            ).astype(np.float32)
    res_j = jax.jit(jax.vmap(env_j.step))(state, jnp.asarray(acts))
    res_t = env_t.step(sim_state_from_numpy(state), torch.tensor(acts))
    return env_j, env_t, state, obs, res_j, res_t


def test_static_tables_match_jax(envs):
    env_j, env_t = envs[:2]
    for name in ("action_mean", "action_std", "action_low", "action_high",
                 "end_effectors", "link_mass"):
        np.testing.assert_array_equal(getattr(env_t, name), getattr(env_j, name), err_msg=name)
    assert env_t.group_links == env_j.group_links
    assert env_t.observation_size == env_j.observation_size == 197
    assert env_t.action_size == env_j.action_size == 36
    assert env_t.n_ref_samples == env_j.n_ref_samples
    np.testing.assert_allclose(env_t.ref_ee_local.numpy(), env_j.ref_ee_local, atol=1e-5, rtol=0)
    np.testing.assert_allclose(env_t.ref_com_vel.numpy(), env_j.ref_com_vel, atol=1e-4, rtol=0)


def test_reset_matches_jax(envs):
    env_j, env_t, state = envs[:3]
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    st_j, obs_j = jax.jit(env_j.reset_batch)(keys)
    st_t, obs_t = env_t.reset_at(torch.tensor(np.asarray(st_j.init_time)))
    for k in ("base_pos", "base_quat", "base_lin", "base_ang", "q_sph", "w_sph",
              "q_rev", "w_rev"):
        np.testing.assert_allclose(getattr(st_t.sim, k).numpy(),
                                   np.asarray(getattr(st_j.sim, k)), atol=RESET_TOL,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=RESET_TOL, rtol=0)


def test_step_matches_jax(envs):
    """State, reward, observation, done and the wrap re-sync of one step."""
    env_j, res_j, res_t = envs[0], envs[4], envs[5]
    pairs = {k: (getattr(res_t.state.sim, k).numpy(), np.asarray(getattr(res_j.state.sim, k)))
             for k in POS_FIELDS + VEL_FIELDS}
    pairs["ref_pos_offset"] = (res_t.state.ref_pos_offset.numpy(),
                               np.asarray(res_j.state.ref_pos_offset))
    pairs["reward"] = (res_t.reward.numpy(), np.asarray(res_j.reward))
    pairs["obs"] = (res_t.obs.numpy(), np.asarray(res_j.obs))
    errs = {k: float(np.abs(g.astype(np.float64) - w.astype(np.float64)).max())
            for k, (g, w) in pairs.items()}
    print("\nenv step vs JAX: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    for k, (g, w) in pairs.items():
        tol = (STATE_TOL if k in POS_FIELDS else VEL_TOL if k in VEL_FIELDS
               else OBS_TOL if k == "obs" else OFFSET_TOL)
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=k)
    np.testing.assert_allclose(res_t.state.elapsed_time.numpy(),
                               np.asarray(res_j.state.elapsed_time), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(res_t.done.numpy(), np.asarray(res_j.done))
    np.testing.assert_array_equal(res_t.terminated.numpy(), np.asarray(res_j.terminated))
    # the wrap happened for the first two envs and re-synced their offset
    assert np.all(np.asarray(res_j.state.elapsed_time[:2]) > env_j.motion.duration)
    off_j = np.asarray(res_j.state.ref_pos_offset)
    assert np.abs(off_j[:2]).max() > 0 and np.abs(off_j[2:]).max() == 0


def test_step_autoreset_resets_done_envs(envs):
    env_t = envs[1]
    state, _ = env_t.reset_batch(2, torch.Generator().manual_seed(0))
    # push env 0 past its time limit so the step ends its episode
    state.elapsed_time[0] = state.init_time[0] + env_t.overtime
    acts = torch.zeros(2, env_t.action_size)
    new_state, new_obs, res = env_t.step_autoreset(state, acts, torch.Generator().manual_seed(1))
    assert res.done.tolist() == [True, False] and res.truncated[0]
    assert float(new_state.elapsed_time[0]) == float(new_state.init_time[0])
    torch.testing.assert_close(new_state.sim.base_pos[1], res.state.sim.base_pos[1])
    torch.testing.assert_close(new_obs[1], res.obs[1])
    assert env_t.engine.mega.launches == 0
