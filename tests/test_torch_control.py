"""PyTorch port: the env off the megastep against JAX (torque control, the
torque-log channel, the scan of substeps with the megastep off).

States come from the port's reset at phases drawn with numpy from a seed,
and are converted; actions are made with numpy from a seed. Both go to
both packages, B = 4.

* torque control: the action tables equal JAX's exactly, and one torque-mode
  ``step`` matches JAX's;
* ``step_log`` matches JAX ``env.step_log`` on ``tau_hist``, obs and reward
  within rtol = atol = 2e-3 (``tests/test_env.py:170``), with ``done``
  exact, and
  ``torque_log`` has JAX's 28 channel names;
* with ``env.engine.mega = None`` on both sides (``tests/test_megastep.py:
  37-41``), ``step`` takes the scan of substeps with the per-substep
  phase-wrap re-sync; two envs start just before the wrap.

After 20 substeps the two packages' fp32 rounding has grown past the
1e-5 of ``tests/test_megastep.py:46-50`` in the velocities: ``w_sph``
reads 8.9e-5 on the scan path and in torque control, ``w_rev`` 2.7e-5 and
7.4e-5. So every env-level comparison holds positions, quaternions and
``q_rev`` to 1e-5, the reference offset and reward to 1e-4
(``tests/test_megastep.py:46-55``), the velocities to 3e-4 (about three
times the largest reading), and the observation, whose velocity part
carries the velocity error through its scaling, to 5e-3, the port's env
bound.

This file keeps to three tests: pytest-xdist's loadfile schedule hands out
files with more tests first, and this file should not delay
``tests/test_megastep.py``, the suite's longest.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.envs.deepmimic import make as t_make  # noqa: E402
from pfpn_tpu.envs.deepmimic import EnvState as JEnvState, make as j_make  # noqa: E402
from pfpn_tpu.sim.types import SimState as JSimState  # noqa: E402

torch.set_num_threads(1)

B = 4
STATE_TOL = 1e-5       # positions, quaternions, q_rev: test_megastep.py:46-50
OFFSET_TOL = 1e-4      # ref_pos_offset and reward: test_megastep.py:51-55
VEL_TOL = 3e-4         # velocities: readings up to 8.9e-5
OBS_TOL = 5e-3         # observation (carries the velocity error)
LOG_TOL = 2e-3         # step_log, rtol and atol: tests/test_env.py:170
POS_FIELDS = ("base_pos", "base_quat", "q_sph", "q_rev")
VEL_FIELDS = ("base_lin", "base_ang", "w_sph", "w_rev")


@pytest.fixture(scope="module")
def envs():
    """JAX and port Walk envs under SPD control, and B reset states (two of
    them just before the phase wrap, test_megastep.py:25-31) in the port's
    form and in JAX's."""
    env_j = j_make("DeepMimicWalk-v0")
    env_t = t_make("DeepMimicWalk-v0", device="cpu")
    t0 = np.random.default_rng(3).uniform(0.0, 1.0, B) * env_t.motion.duration
    t0[:2] = env_t.motion.duration - 1.5 * env_t.dt
    state_t, _ = env_t.reset_at(torch.tensor(t0, dtype=torch.float32))
    sim = state_t.sim
    state_j = JEnvState(
        sim=JSimState(**{k: jnp.asarray(getattr(sim, k).numpy())
                         for k in sim.__dataclass_fields__}),
        elapsed_time=jnp.asarray(state_t.elapsed_time.numpy()),
        init_time=jnp.asarray(state_t.init_time.numpy()),
        ref_pos_offset=jnp.asarray(state_t.ref_pos_offset.numpy()))
    return env_j, env_t, state_t, state_j


def _per_env(fn, *batched):
    """The per-env JAX function ``fn``, jitted once, run on each env of the
    batch; results stacked as numpy. (Unbatched, it traces and compiles in
    about two thirds of the time of its vmap.)"""
    f = jax.jit(fn)
    outs = [f(*jax.tree.map(lambda x: x[i], batched)) for i in range(B)]
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *outs)


def _actions(n, size, seed, scale=0.1):
    return (scale * np.random.default_rng(seed).standard_normal((n, size))).astype(np.float32)


def _report(what, pairs):
    errs = {k: float(np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).max())
            for k, (g, w) in pairs.items()}
    print(f"\n{what}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))


def _check_step(what, got, want):
    """A port StepResult against a JAX one under the env-level bounds."""
    pairs = {k: (getattr(got.state.sim, k).numpy(), np.asarray(getattr(want.state.sim, k)))
             for k in POS_FIELDS + VEL_FIELDS}
    pairs["ref_pos_offset"] = (got.state.ref_pos_offset.numpy(),
                               np.asarray(want.state.ref_pos_offset))
    pairs["reward"] = (got.reward.numpy(), np.asarray(want.reward))
    pairs["obs"] = (got.obs.numpy(), np.asarray(want.obs))
    _report(what, pairs)
    for k, (g, w) in pairs.items():
        tol = (STATE_TOL if k in POS_FIELDS else VEL_TOL if k in VEL_FIELDS
               else OBS_TOL if k == "obs" else OFFSET_TOL)
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"{what}: {k}")
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    np.testing.assert_allclose(got.state.elapsed_time.numpy(),
                               np.asarray(want.state.elapsed_time), atol=1e-6, rtol=0)


def test_scan_step_matches_jax(envs):
    env_j, env_t, state_t, state = envs
    acts = _actions(B, env_j.action_size, 5)
    mega_j = env_j.engine.mega
    try:
        env_j.engine.mega = None
        want = _per_env(env_j.step, state, jnp.asarray(acts))
    finally:
        env_j.engine.mega = mega_j
    mega_t = env_t.engine.mega
    try:
        env_t.engine.mega = None
        got = env_t.step(state_t, torch.tensor(acts))
    finally:
        env_t.engine.mega = mega_t
    assert mega_t.launches == 0
    _check_step("step, megastep off", got, want)
    # the wrap happened for the first two envs, and the offset was re-synced
    assert np.all(np.asarray(want.state.elapsed_time[:2]) > env_j.motion.duration)
    assert np.abs(np.asarray(want.state.ref_pos_offset[:2])).max() > 0


def test_step_log_matches_jax(envs):
    env_j, env_t, state_t, state = envs
    acts = _actions(B, env_j.action_size, 7)
    want, tau_j = _per_env(env_j.step_log, state, jnp.asarray(acts))
    got, tau_t = env_t.step_log(state_t, torch.tensor(acts))
    assert tau_t.shape == (B, env_t.frame_skip, env_t.tree.ndof)
    pairs = {"tau_hist": (tau_t.numpy(), np.asarray(tau_j)),
             "obs": (got.obs.numpy(), np.asarray(want.obs)),
             "reward": (got.reward.numpy(), np.asarray(want.reward))}
    _report("step_log", pairs)
    for k, (g, w) in pairs.items():
        np.testing.assert_allclose(g, w, rtol=LOG_TOL, atol=LOG_TOL, err_msg=k)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    assert float(np.abs(np.asarray(tau_j)).max()) > 1.0    # the motors pull
    log_t = env_t.torque_log(tau_t)
    log_j = env_j.torque_log(tau_j)
    assert list(log_t) == list(log_j) and len(log_t) == 28
    for name in log_j:
        np.testing.assert_allclose(log_t[name], log_j[name], rtol=LOG_TOL, atol=LOG_TOL)


def test_torque_mode_matches_jax(envs):
    _, _, state_t, state = envs
    env_j = j_make("DeepMimicWalk-v0", control_mode="torque")
    env_t = t_make("DeepMimicWalk-v0", device="cpu", control_mode="torque")
    assert env_t.engine.mega is None and env_j.engine.mega is None
    for name in ("action_mean", "action_std", "action_low", "action_high"):
        np.testing.assert_array_equal(getattr(env_t, name), getattr(env_j, name),
                                      err_msg=name)
    assert env_t.action_size == env_j.action_size == 28
    assert env_t.torque_channels == env_j.torque_channels
    acts = _actions(B, env_j.action_size, 9, scale=0.2)
    want = _per_env(env_j.step, state, jnp.asarray(acts))
    got = env_t.step(state_t, torch.tensor(acts))
    _check_step("torque-mode step", got, want)
