"""PyTorch port: the Punch, Kick and MultiTask envs and the env's options
against JAX.

JAX and torch draw different random numbers, so states come from the JAX
env's ``reset_batch``, converted with ``sim_state_from_numpy``, and both
envs step them with the same actions, made with numpy from a seed. JAX runs
on the CPU, where its engine turns the megastep off
(``pfpn_tpu/sim/engine.py:52-56``): no Pallas kernel is involved.

* Punch and Kick stepped as ``tests/test_torch_env.py`` steps Walk (B = 4,
  two envs just before a phase wrap), at its bounds: positions,
  quaternions and ``q_rev`` 1e-5, reward and ``ref_pos_offset`` 1e-4,
  velocities 3e-4, observation 1e-3, ``done`` exact;
* ``MultiTaskEnv`` (B = 12, four envs a task) reset and stepped against
  JAX's, the one-hot task id included, at the same bounds; its slices
  (3/3/2 at B = 8, and a batch smaller than the task count) and the order
  in which it draws;
* the constructor's options (``random_init_pose=False``, ``overtime``,
  ``exact_ref_reward=True``, ``control_range``) on one env, its step and
  ``reward_terms`` (whose sum is the reward) at the same bounds, and
  ``mirror_pose`` (1e-6, and mirroring twice is the identity).

The JAX env steps are compiled once per motion (tracing and compiling them
is most of this file's time): the JAX multi-task env's per-motion envs
serve the Punch and Kick cases, and the multi-task batch reuses their
B = 4 compiles. Four tests, so that
pytest-xdist's loadfile schedule does not start this file before
``tests/test_megastep.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.envs.assets import HUMANOID_JOINT_PAIRS as T_PAIRS  # noqa: E402
from pfpn_torch.envs.deepmimic import make as t_make  # noqa: E402
from pfpn_torch.mocap.motion import mirror_pose as t_mirror  # noqa: E402
from pfpn_torch.mocap.motion import sample_pose as t_sample_pose  # noqa: E402
from pfpn_torch.sim.types import sim_state_from_numpy  # noqa: E402
from pfpn_tpu.envs.assets import HUMANOID_JOINT_PAIRS  # noqa: E402
from pfpn_tpu.envs.deepmimic import make as j_make  # noqa: E402
from pfpn_tpu.mocap import sample_pose  # noqa: E402
from pfpn_tpu.mocap.motion import mirror_pose  # noqa: E402

torch.set_num_threads(1)

STATE_TOL = 1e-5     # positions, quaternions, q_rev: tests/test_megastep.py:46-50
OFFSET_TOL = 1e-4    # ref_pos_offset and reward: tests/test_megastep.py:51-55
VEL_TOL = 3e-4       # velocities, as tests/test_torch_env.py
OBS_TOL = 1e-3
POS_FIELDS = ("base_pos", "base_quat", "q_sph", "q_rev")
VEL_FIELDS = ("base_lin", "base_ang", "w_sph", "w_rev")


@pytest.fixture(scope="module")
def multitask():
    """JAX's and the port's multi-task envs; their per-motion envs are the
    Punch and Kick envs of the step test. Each JAX per-motion env's batched
    reset and step are jitted once, at B = 4, and serve both tests."""
    env_j = j_make("DeepMimicMultiTask-v0")
    for env in env_j.envs:
        env.reset_batch = jax.jit(env.reset_batch)
        env.step_batch = jax.jit(env.step_batch)
    env_t = t_make("DeepMimicMultiTask-v0", device="cpu")
    return env_j, env_t


def _actions(batch, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal((batch, 36))).astype(np.float32)


def _check_step(res_t, res_j, tag):
    """One step's state, offset, reward, observation and done, at the env
    bounds; prints the readings."""
    pairs = {k: (getattr(res_t.state.sim, k).numpy(), np.asarray(getattr(res_j.state.sim, k)))
             for k in POS_FIELDS + VEL_FIELDS}
    pairs["ref_pos_offset"] = (res_t.state.ref_pos_offset.numpy(),
                               np.asarray(res_j.state.ref_pos_offset))
    pairs["reward"] = (res_t.reward.numpy(), np.asarray(res_j.reward))
    pairs["obs"] = (res_t.obs.numpy(), np.asarray(res_j.obs))
    errs = {k: float(np.abs(g.astype(np.float64) - w.astype(np.float64)).max())
            for k, (g, w) in pairs.items()}
    print(f"\n{tag} step vs JAX: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    for k, (g, w) in pairs.items():
        tol = (STATE_TOL if k in POS_FIELDS else VEL_TOL if k in VEL_FIELDS
               else OBS_TOL if k == "obs" else OFFSET_TOL)
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"{tag} {k}")
    np.testing.assert_allclose(res_t.state.elapsed_time.numpy(),
                               np.asarray(res_j.state.elapsed_time), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(res_t.done.numpy(), np.asarray(res_j.done))
    np.testing.assert_array_equal(res_t.terminated.numpy(), np.asarray(res_j.terminated))
    np.testing.assert_array_equal(res_t.truncated.numpy(), np.asarray(res_j.truncated))


@pytest.mark.parametrize("task", [1, 2], ids=["punch", "kick"])
def test_motion_step_matches_jax(multitask, task):
    mt_j, mt_t = multitask
    env_j, env_t = mt_j.envs[task], mt_t.envs[task]
    name = f"DeepMimic{env_j.motion_name.capitalize()}-v0"
    assert t_make(name, device="cpu").motion_name == env_t.motion_name == env_j.motion_name
    np.testing.assert_array_equal(env_t.end_effectors, env_j.end_effectors)
    np.testing.assert_array_equal(env_t.contact_allowed[:-1], env_j.contact_allowed)
    assert env_t.has_termination == env_j.has_termination
    assert env_t.n_ref_samples == env_j.n_ref_samples
    np.testing.assert_allclose(env_t.ref_ee_local.numpy(), env_j.ref_ee_local, atol=1e-5, rtol=0)
    np.testing.assert_allclose(env_t.ref_com_vel.numpy(), env_j.ref_com_vel, atol=1e-4, rtol=0)

    B = 4
    state, obs = env_j.reset_batch(jax.random.split(jax.random.PRNGKey(3 + task), B))
    st_t, obs_t = env_t.reset_at(torch.tensor(np.asarray(state.init_time)))
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs), atol=1e-5, rtol=0)
    # two envs just before a phase wrap exercise the re-sync
    et = state.elapsed_time.at[:2].set(env_j.motion.duration - 1.5 * env_j.dt)
    state = state.replace(elapsed_time=et, init_time=et)
    acts = _actions(B, 5 + task)
    res_j = env_j.step_batch(state, jnp.asarray(acts))
    res_t = env_t.step(sim_state_from_numpy(state), torch.tensor(acts))
    _check_step(res_t, res_j, env_j.motion_name)
    assert np.all(np.asarray(res_j.state.elapsed_time[:2]) > env_j.motion.duration)
    off_j = np.asarray(res_j.state.ref_pos_offset)
    assert np.abs(off_j[:2]).max() > 0 and np.abs(off_j[2:]).max() == 0


def test_multitask_matches_jax(multitask):
    env_j, env_t = multitask
    assert env_t.motions == env_j.motions == ("walk", "punch", "kick")
    assert env_t.task_obs and env_j.task_obs
    assert env_t.observation_size == env_j.observation_size == 200
    assert env_t.action_size == 36 and env_t.engine is env_t.envs[0].engine
    assert env_t._sizes(8) == env_j._sizes(8) == [3, 3, 2]
    np.testing.assert_array_equal(env_t.task_ids(8), env_j.task_ids(8))

    B = 12    # four envs a task: the per-motion steps compiled at B = 4
    state, obs = env_j.reset_batch(jax.random.split(jax.random.PRNGKey(11), B))
    st_t, obs_t = env_t.reset_at(torch.tensor(np.asarray(state.init_time)))
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(obs_t[:, -3:].numpy(), np.repeat(np.eye(3, dtype=np.float32),
                                                                   4, 0))
    for k in POS_FIELDS + VEL_FIELDS:
        np.testing.assert_allclose(getattr(st_t.sim, k).numpy(),
                                   np.asarray(getattr(state.sim, k)), atol=1e-5, rtol=0)
    acts = _actions(B, 12)
    res_j = env_j.step_batch(state, jnp.asarray(acts))
    res_t = env_t.step_batch(sim_state_from_numpy(state), torch.tensor(acts))
    _check_step(res_t, res_j, "multitask")

    # the batch draws slice by slice from the one generator, in task order
    st, obs = env_t.reset_batch(8, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    want = torch.cat([env.reset_batch(n, g)[0].init_time
                      for env, n in zip(env_t.envs, (3, 3, 2))])
    torch.testing.assert_close(st.init_time, want, rtol=0, atol=0)
    np.testing.assert_array_equal(obs[:, -3:].argmax(-1).numpy(), [0, 0, 0, 1, 1, 1, 2, 2])
    new_st, new_obs, res = env_t.step_autoreset(st, torch.zeros(8, 36),
                                                torch.Generator().manual_seed(5))
    assert new_obs.shape == res.obs.shape == (8, 200) and res.reward.shape == (8,)
    np.testing.assert_array_equal(new_obs[:, -3:].numpy(), obs[:, -3:].numpy())
    st2, obs2 = env_t.reset_batch(2, torch.Generator().manual_seed(6))   # no Kick slot
    np.testing.assert_array_equal(obs2[:, -3:].numpy(), np.eye(3, dtype=np.float32)[:2])


def test_env_options_and_reward_terms_match_jax():
    opts = dict(random_init_pose=False, overtime=0.02, exact_ref_reward=True,
                control_range=2.0)
    env_j = j_make("DeepMimicWalk-v0", **opts)
    env_t = t_make("DeepMimicWalk-v0", device="cpu", **opts)
    assert not hasattr(env_t, "ref_ee_local")          # the exact path has no tables
    np.testing.assert_array_equal(env_t.action_std, env_j.action_std)
    assert env_t.overtime == 0.02 and env_t.control_range == 2.0

    B = 4
    state, obs = jax.jit(env_j.reset_batch)(jax.random.split(jax.random.PRNGKey(2), B))
    st_t, obs_t = env_t.reset_batch(B, torch.Generator().manual_seed(2))
    assert float(st_t.init_time.abs().max()) == 0.0 == float(jnp.abs(state.init_time).max())
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs), atol=1e-5, rtol=0)
    # a time limit of 0.02 s ends the first two episodes at the first step;
    # the other two count from a later start and run on
    it = state.init_time.at[2:].set(1.0)
    state = state.replace(init_time=it)
    acts = _actions(B, 21)

    @jax.jit
    def step_and_terms(state, acts):   # one trace and compile for both
        res = jax.vmap(env_j.step)(state, acts)
        return res, jax.vmap(env_j.reward_terms)(res.state, res.terminated)

    res_j, terms_j = step_and_terms(state, jnp.asarray(acts))
    res_t = env_t.step(sim_state_from_numpy(state), torch.tensor(acts))
    _check_step(res_t, res_j, "options")
    assert res_t.truncated.tolist() == [True, True, False, False]

    terms_t = env_t.reward_terms(res_t.state, res_t.terminated)
    assert set(terms_t) == set(terms_j)
    for k in terms_t:
        err = float(np.abs(terms_t[k].numpy() - np.asarray(terms_j[k])).max())
        print(f"reward term {k}: {err:.2e}")
        assert err <= OFFSET_TOL, k
    torch.testing.assert_close(sum(terms_t.values()), res_t.reward, rtol=0, atol=1e-6)

    # mirror_pose (pfpn_tpu/mocap/motion.py:94)
    times = np.array([0.0, 0.3, 0.61], np.float32)
    pose_t = t_sample_pose(env_t.motion, torch.tensor(times))
    m_t = t_mirror(pose_t, env_t.tree, T_PAIRS)
    m_j = jax.jit(jax.vmap(lambda t: mirror_pose(sample_pose(env_j.motion, t), env_j.tree,
                                                 HUMANOID_JOINT_PAIRS)))(jnp.asarray(times))
    for f in m_j._fields:
        np.testing.assert_allclose(getattr(m_t, f).numpy(), np.asarray(getattr(m_j, f)),
                                   atol=1e-6, rtol=0, err_msg=f)
    twice = t_mirror(m_t, env_t.tree, T_PAIRS)
    for f in pose_t._fields:
        torch.testing.assert_close(getattr(twice, f), getattr(pose_t, f), rtol=0, atol=0)
