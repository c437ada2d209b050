"""PyTorch port: the gym adapter, the quaternion and stacked-hinge
conversions, the native mocap loader and the tracing helpers.

* ``GymEnv``'s surface as ``tests/test_env.py:187-246`` holds JAX's
  (mutable ``Box``, truncation at ``overtime=0.05``, ``seed``
  repeatability, ``sample`` on unbounded dims, the ``__getattr__`` guard);
* three ``GymEnv`` steps against JAX's ``GymEnv`` from one start phase
  (the two packages' random streams differ, so the port resets at the
  phase JAX drew), both envs with ``exact_ref_reward=True``, which spares
  JAX's constructor its ~11 s of reference tables (the default tables are
  held against JAX in ``tests/test_torch_env.py``): positions and the observation within the port's
  env-level bounds (``tests/test_torch_control.py``: 1e-5 on positions,
  5e-3 on the observation, which carries the velocity error), the reward
  1e-4, ``done`` and ``truncated`` exact;
* ``quat_identity``, ``matrix_to_quat``,
  ``angular_velocity_to_quat_derivative``, ``euler_zyx_to_quat`` and both
  euler-stack conversions against JAX at 1e-6 on numpy-seeded inputs (the
  same fp32 formulas), and the round trip of
  ``tests/test_quaternion.py:175-200``; then ``trace`` around one CPU env
  step, whose Chrome trace holds the ``annotate`` region;
* the loader's native branch against its NumPy branch (1e-5, as
  ``tests/test_native.py``), where ``csrc/libpfpn_mocap.so`` is built.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.envs import Box, GymEnv  # noqa: E402
from pfpn_torch.envs.deepmimic import make as t_make  # noqa: E402
from pfpn_torch.math import euler_stack as t_es  # noqa: E402
from pfpn_torch.math import quaternion as t_quat  # noqa: E402

torch.set_num_threads(1)

QUAT_TOL = 1e-6
POS_TOL = 1e-5
OBS_TOL = 5e-3
REWARD_TOL = 1e-4


def test_gym_adapter_stateful_surface():
    genv = GymEnv(t_make("DeepMimicWalk-v0", device="cpu", overtime=0.05,
                         random_init_pose=False), seed=3)
    assert isinstance(genv.action_space, Box) and isinstance(genv.observation_space, Box)
    assert genv.action_space.shape == (genv.action_size,)
    assert genv.observation_space.shape == (genv.observation_size,)
    assert str(genv) == "DeepMimicWalk-v0"
    genv.action_space.shape = [7] * genv.action_size      # plain mutable fields
    del genv.action_space.low, genv.action_space.high

    obs = genv.reset()
    assert obs.shape == (genv.observation_size,) and obs.dtype == np.float32
    a = np.zeros(genv.action_size, dtype=np.float32)
    done, info = False, {}
    for _ in range(3):
        obs, r, done, info = genv.step(a)
        assert obs.shape == (genv.observation_size,) and 0.0 <= r <= 1.0
        if done:
            break
    assert done and info["TimeLimit.truncated"] is True   # overtime=0.05

    genv2 = GymEnv(t_make("DeepMimicWalk-v0", device="cpu"), seed=5)
    o1 = genv2.reset()
    genv2.seed(5)
    np.testing.assert_array_equal(o1, genv2.reset())

    s = Box(low=np.zeros(3), high=np.ones(3)).sample()
    assert s.shape == (3,) and np.all(s >= 0) and np.all(s <= 1)
    s = Box(low=np.full(4, -np.inf), high=np.full(4, np.inf), shape=(4,)).sample()
    assert s.shape == (4,) and np.all(np.isfinite(s))
    shell = object.__new__(GymEnv)          # no __init__, no .env attribute
    with pytest.raises(AttributeError):
        shell.anything  # noqa: B018


def test_gym_steps_match_jax():
    from pfpn_tpu.envs.deepmimic import make as j_make
    from pfpn_tpu.envs.gym_adapter import GymEnv as JGymEnv

    genv_j = JGymEnv(j_make("DeepMimicWalk-v0", exact_ref_reward=True), seed=11)
    genv_t = GymEnv(t_make("DeepMimicWalk-v0", device="cpu", exact_ref_reward=True),
                    seed=11)
    obs_j = genv_j.reset()
    obs_t = genv_t.reset_at(float(genv_j._state.init_time))
    np.testing.assert_allclose(obs_t, obs_j, atol=OBS_TOL, rtol=0)
    acts = (0.1 * np.random.default_rng(4).standard_normal((3, genv_t.action_size))
            ).astype(np.float32)
    errs = {}
    for a in acts:
        oj, rj, dj, ij = genv_j.step(a)
        ot, rt, dt, it = genv_t.step(a)
        for k in ("base_pos", "base_quat", "q_sph", "q_rev"):
            errs[k] = max(errs.get(k, 0.0), float(np.abs(
                getattr(genv_t._state.sim, k)[0].numpy()
                - np.asarray(getattr(genv_j._state.sim, k))).max()))
        errs["obs"] = max(errs.get("obs", 0.0), float(np.abs(ot - oj).max()))
        errs["reward"] = max(errs.get("reward", 0.0), abs(rt - rj))
        assert (dt, it["TimeLimit.truncated"]) == (dj, ij["TimeLimit.truncated"])
    print("\nGymEnv against JAX's: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    for k, v in errs.items():
        tol = OBS_TOL if k == "obs" else REWARD_TOL if k == "reward" else POS_TOL
        assert v <= tol, (k, v)


def test_quaternion_conversions_match_jax_and_trace(tmp_path):
    from pfpn_torch.utils.profiling import annotate, trace
    from pfpn_tpu.math import euler_stack as j_es
    from pfpn_tpu.math import quaternion as j_quat

    rng = np.random.default_rng(7)
    q = rng.standard_normal((64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w = (3.0 * rng.standard_normal((64, 3))).astype(np.float32)
    # rotation matrices from each branch of matrix_to_quat (trace, x, y, z
    # largest), with the JAX package's own quat_to_matrix
    m = np.asarray(j_quat.quat_to_matrix(jnp.asarray(q)))
    euler = rng.uniform(-1.2, 1.2, (3, 64)).astype(np.float32)

    def tq(x):
        return torch.tensor(np.asarray(x))

    @jax.jit        # one compile for every JAX function held here
    def jax_side(q, w, m, euler, ang, rate):
        return (j_quat.quat_identity((2, 3)), j_quat.matrix_to_quat(m),
                j_quat.angular_velocity_to_quat_derivative(q, w),
                j_quat.euler_zyx_to_quat(*euler), j_es.spherical_to_stacked_zyx(q, w),
                j_es.stacked_zyx_to_spherical(ang, rate))

    ang_t, rate_t = t_es.spherical_to_stacked_zyx(tq(q), tq(w))
    q2_t, w2_t = t_es.stacked_zyx_to_spherical(ang_t, rate_t)
    ident, m2q, dq, e2q, (ang_j, rate_j), (q2_j, w2_j) = jax_side(
        q, w, m, euler, ang_t.numpy(), rate_t.numpy())
    pairs = {
        "quat_identity": (t_quat.quat_identity((2, 3)), ident),
        "matrix_to_quat": (t_quat.matrix_to_quat(tq(m)), m2q),
        "angular_velocity_to_quat_derivative": (
            t_quat.angular_velocity_to_quat_derivative(tq(q), tq(w)), dq),
        "euler_zyx_to_quat": (t_quat.euler_zyx_to_quat(*tq(euler)), e2q),
        "spherical_to_stacked_zyx angles": (ang_t, ang_j),
        "stacked_zyx_to_spherical q": (q2_t, q2_j),
    }
    best = np.argmax(np.stack([np.trace(m, axis1=1, axis2=2), m[:, 0, 0], m[:, 1, 1],
                               m[:, 2, 2]], -1), -1)
    assert set(best.tolist()) == {0, 1, 2, 3}
    print()
    for k, (got, want) in pairs.items():
        err = float(np.abs(got.numpy() - np.asarray(want)).max())
        print(f"{k}: {err:.2e}")
        assert err <= QUAT_TOL, k
    # rates go through 1/cos(pitch): relative to their size
    ok = np.abs(np.cos(ang_t[:, 1].numpy())) > 0.2
    np.testing.assert_allclose(rate_t.numpy()[ok], np.asarray(rate_j)[ok], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w2_t.numpy()[ok], np.asarray(w2_j)[ok], rtol=1e-4, atol=1e-4)

    # the round trip of tests/test_quaternion.py:175-200
    sign = torch.sign(torch.sum(tq(q) * q2_t, -1, keepdim=True))
    np.testing.assert_allclose((q2_t * sign).numpy()[ok], q[ok], atol=1e-5)
    np.testing.assert_allclose(w2_t.numpy()[ok], w[ok], rtol=1e-4, atol=1e-4)
    a0 = ang_t      # (yaw, pitch, roll) of quat_to_euler_zyx
    q3, w3 = t_es.stacked_zyx_to_spherical(a0, rate_t)
    a3, r3 = t_es.spherical_to_stacked_zyx(q3, w3)
    np.testing.assert_allclose(a3.numpy()[ok], a0.numpy()[ok], atol=1e-4)
    np.testing.assert_allclose(r3.numpy()[ok], rate_t.numpy()[ok], rtol=1e-3, atol=1e-3)

    # a trace around one CPU env step (of two substeps, to keep the
    # profiler's window small) holds the named region
    env = t_make("DeepMimicWalk-v0", device="cpu", frame_skip=2)
    st, _ = env.reset_batch(1, torch.Generator().manual_seed(0))
    with trace(str(tmp_path)):
        with annotate("env_step"):
            env.step(st, torch.zeros(1, env.action_size))
    with open(os.path.join(tmp_path, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "env_step" in names


def test_native_loader_matches_numpy_path(monkeypatch):
    from pfpn_torch.envs.assets import humanoid_tree
    from pfpn_torch.mocap import loader, native

    if not native.available():
        pytest.skip("csrc/libpfpn_mocap.so not built (make -C csrc)")
    tree = humanoid_tree()
    m_native = loader.load_motion(tree, "walk")
    monkeypatch.setattr(native, "available", lambda: False)
    m_numpy = loader.load_motion(tree, "walk")
    for field in ("base_pos", "base_quat", "base_lin", "base_ang", "q_sph", "w_sph",
                  "q_rev", "w_rev"):
        np.testing.assert_allclose(getattr(m_native, field), getattr(m_numpy, field),
                                   atol=1e-5, err_msg=field)
    x = np.random.default_rng(0).standard_normal((64, 5))
    from pfpn_torch.math.filters import so_fb_butter_lpf
    np.testing.assert_allclose(native.butterworth_fb(x, 30.0, 6.0),
                               so_fb_butter_lpf(x, 30.0, 6.0), atol=1e-12)
    # wxyz -> xyzw of the quaternion at each column offset
    frames = np.random.default_rng(1).standard_normal((6, 9))
    want = frames.copy()
    for o in (1, 5):
        want[:, o:o + 4] = np.roll(frames[:, o:o + 4], -1, axis=1)
    np.testing.assert_array_equal(native.quat_reorder(frames, [1, 5]), want)
