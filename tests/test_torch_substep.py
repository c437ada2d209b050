"""PyTorch port: the per-substep physics path against JAX, with the CUDA
sources of its two kernels built for the host.

Inputs are made with numpy from a seed and handed to both packages:
perturbed reset states (``tests/test_megastep.py:108-118``) and falling
drop states in ground contact (``tests/test_fused.py:26-40``).

* ``spd_inverse`` / ``spd_inverse_pair``: the plain version and
  ``csrc/spd_inverse.cu`` built with g++, against
  ``pfpn_tpu.ops.linalg._spd_inverse_reference`` on humanoid H + eps and
  H + diag(kd dt) + eps;
* ``substep_core``: the plain version and ``csrc/substep_lin.cu`` built
  with g++, against JAX ``_substep_core_reference`` on the inputs of
  ``tests/test_fused.py:100-118``, rtol = atol = 2e-4 (``test_fused.py:121``);
* ``Engine.substep`` against JAX ``Engine.substep`` for one substep in four
  modes (fused SPD, unfused SPD with ``return_torque``, torque, position),
  on the plain path and with both kernels' host builds in place of the
  kernels: 1e-5 on positions, quaternions and ``q_rev``, 1e-4 on
  velocities, exact link contact flags.

This file keeps to four tests: pytest-xdist's loadfile schedule hands out
files with more tests first, and this file should not delay
``tests/test_megastep.py``, the suite's longest.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.control.spd import spd_errors as t_spd_errors  # noqa: E402
from pfpn_torch.envs.deepmimic import make as t_make  # noqa: E402
from pfpn_torch.ops import linalg as tlinalg  # noqa: E402
from pfpn_torch.ops import substep_lin as tsl  # noqa: E402
from pfpn_torch.sim import contact as t_contact  # noqa: E402
from pfpn_torch.sim.engine import Engine as TEngine  # noqa: E402
from pfpn_torch.sim.engine import EngineConfig as TEngineConfig  # noqa: E402
from pfpn_torch.sim.types import SimState as TSimState  # noqa: E402
from pfpn_tpu.sim.engine import Engine, EngineConfig  # noqa: E402  (before control)
from pfpn_tpu.control.spd import build_gains  # noqa: E402
from pfpn_tpu.envs.assets import HUMANOID_KD, HUMANOID_KP, humanoid_tree  # noqa: E402
from pfpn_tpu.ops.linalg import _spd_inverse_reference  # noqa: E402
from pfpn_tpu.ops.substep_lin import SubstepMeta, _substep_core_reference  # noqa: E402
from pfpn_tpu.sim.types import SimState as JSimState, zero_state  # noqa: E402

torch.set_num_threads(1)

B = 8
# one substep: same math on both sides, fp32 reassociation only
SUB_POS_TOL = 1e-5     # positions, quaternions, q_rev
SUB_VEL_TOL = 1e-4     # velocities (through the 34x34 inverses, cond ~ 4e4)
# applied torque: |tau| reaches the motor limits (up to 200); the error is
# that of kd dt a, with `a` through (H + diag(kd dt))^-1
TAU_TOL = 2e-3
# the inverse: max |X - X_jax| / max |X_jax|, and max |A X - I| in float64
INV_REL_TOL = 1e-5
INV_RESID_TOL = 5e-4
# substep_core: tests/test_fused.py:121
CORE_TOL = 2e-4

POS_FIELDS = ("base_pos", "base_quat", "q_sph", "q_rev")
VEL_FIELDS = ("base_lin", "base_ang", "w_sph", "w_rev")


def _fields():
    return [f.name for f in dataclasses.fields(TSimState)]


def _report(what, pairs):
    """Print the max abs error of each (got, want) pair (pytest -s shows it)."""
    errs = {k: float(np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).max())
            for k, (g, w) in pairs.items()}
    print(f"\n{what}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))


@pytest.fixture(scope="module")
def setup():
    """The port's env (its reset and engine), and the JAX tree and gains."""
    tree = humanoid_tree()
    return {"env_t": t_make("DeepMimicWalk-v0", device="cpu"), "tree": tree,
            "gains": build_gains(tree, HUMANOID_KP, HUMANOID_KD)}


def _reset_states(env_t, n, seed):
    """Perturbed reset states (test_megastep.py:108-118) as numpy arrays."""
    rng = np.random.default_rng(seed)
    t0 = torch.tensor(rng.uniform(0.0, 1.0, n) * env_t.motion.duration, dtype=torch.float32)
    st = env_t.reset_at(t0)[0].sim
    s = {k: getattr(st, k).numpy().copy() for k in _fields()}
    s["base_lin"] = s["base_lin"] + np.array([0.1, -0.4, 0.0], np.float32)
    s["w_sph"] = s["w_sph"] + 0.3 * rng.standard_normal(s["w_sph"].shape).astype(np.float32)
    s["w_rev"] = s["w_rev"] + 0.3 * rng.standard_normal(s["w_rev"].shape).astype(np.float32)
    return s


def _drop_states(n, seed, height=0.878):
    """Falling states touching the ground (test_fused.py:26-40)."""
    rng = np.random.default_rng(seed)
    z = zero_state(humanoid_tree())
    s = {k: np.broadcast_to(np.asarray(getattr(z, k)), (n,) + np.shape(getattr(z, k))).copy()
         for k in _fields()}
    s["base_pos"][:] = [0.0, height, 0.0]
    s["base_lin"][:] = [0.1, -0.5, 0.05]
    s["base_ang"] = (0.1 * rng.standard_normal((n, 3))).astype(np.float32)
    s["w_sph"] = (0.2 * rng.standard_normal(s["w_sph"].shape)).astype(np.float32)
    s["w_rev"] = (0.2 * rng.standard_normal(s["w_rev"].shape)).astype(np.float32)
    return s


def _to_jax(s):
    return JSimState(**{k: jnp.asarray(v, dtype=jnp.float32) for k, v in s.items()})


def _to_torch(s):
    return TSimState(**{k: torch.tensor(np.asarray(v), dtype=torch.float32) for k, v in s.items()})


def _targets(tree, n, seed):
    """Random SPD / position targets near the identity, and torques."""
    rng = np.random.default_rng(seed)
    axis = rng.standard_normal((n, tree.n_sph, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    half = 0.5 * rng.uniform(-0.5, 0.5, (n, tree.n_sph, 1))
    ts = np.concatenate([axis * np.sin(half), np.cos(half)], -1).astype(np.float32)
    tr = rng.uniform(-0.5, 0.5, (n, tree.n_rev)).astype(np.float32)
    torques = []
    for m, b in enumerate(tree.motor_bodies):
        k = int(tree.dof_count[b])
        lim = float(tree.motor_torque_limit[m])
        torques.append((0.6 * lim * rng.uniform(-1, 1, (n, k))).astype(np.float32))
    return ts, tr, torques


def _states(setup, kind, seed):
    return (_reset_states(setup["env_t"], B, seed) if kind == "reset"
            else _drop_states(B, seed))


# ---------------------------------------------------------------------------
# the two kernels
# ---------------------------------------------------------------------------

def _h_pairs(setup, s):
    """(H + diag(kd dt) + eps, H + eps) of the states s (B, 2, n, n), with
    the port's mass matrix (held against JAX's in test_torch_dynamics.py)."""
    eng = setup["env_t"].engine
    h = eng._dynamics(_to_torch(s))[1].numpy()
    eye = np.eye(h.shape[-1], dtype=np.float32)
    kd_dt = np.asarray(eng.gains.kd, np.float32) * np.float32(eng.config.dt)
    return np.stack([h + np.diag(kd_dt) + 1e-8 * eye, h + 1e-8 * eye], 1)


def test_spd_inverse_matches_jax(setup):
    reset, drop = (_states(setup, kind, 3) for kind in ("reset", "drop"))
    pairs = _h_pairs(setup, {k: np.concatenate([reset[k], drop[k]]) for k in reset})
    want = np.asarray(jax.vmap(_spd_inverse_reference)(
        jnp.asarray(pairs.reshape(-1, *pairs.shape[2:])))).reshape(pairs.shape)
    a = torch.tensor(pairs)
    got = {"plain pair": tlinalg.spd_inverse_pair(a),
           "plain single": tlinalg.spd_inverse(a[:, 1]),
           "CUDA source pair": tlinalg.spd_inverse_host(a),
           "CUDA source single": tlinalg.spd_inverse_host(a[:, 1])}
    assert tlinalg.launches == 0          # CPU tensors: the plain version
    scale = np.abs(want).max()
    eye = np.eye(pairs.shape[-1])
    print()
    for name, x in got.items():
        x = x.numpy().astype(np.float64)
        ref = want if "pair" in name else want[:, 1]
        mats = pairs if "pair" in name else pairs[:, 1]
        rel = np.abs(x - ref).max() / scale
        resid = np.abs(mats.astype(np.float64) @ x - eye).max()
        print(f"spd_inverse {name}: rel err {rel:.2e}, max |A X - I| {resid:.2e}")
        assert rel <= INV_REL_TOL, (name, rel)
        assert resid <= INV_RESID_TOL, (name, resid)
    resid_jax = np.abs(pairs.astype(np.float64) @ want.astype(np.float64) - eye).max()
    print(f"spd_inverse JAX reference: max |A X - I| {resid_jax:.2e}")


def _core_inputs(setup, s):
    """substep_core inputs of the states s under identity targets, as
    test_fused.py:100-118 forms them, with the port's dynamics, SPD errors
    and contact rows (held against JAX's in test_torch_sim.py)."""
    eng = setup["env_t"].engine
    st = _to_torch(s)
    fkr, h, c, v = eng._dynamics(st)
    ts, tr = torch.zeros(B, eng.tree.n_sph, 4), torch.zeros(B, eng.tree.n_rev)
    ts[..., 3] = 1.0
    e_p, e_dp = t_spd_errors(eng.tree, eng.gains, st, ts, tr, eng.config.dt)
    kpe = (torch.tensor(eng.gains.kp, dtype=torch.float32) * e_p
           + torch.tensor(eng.gains.kd, dtype=torch.float32) * e_dp)
    rs = t_contact.assemble_rows(eng.tree, eng.contact_set, eng.config.contact,
                                 fkr, st.q_rev, eng.config.dt)
    return [x.numpy() for x in (h, kpe - c, kpe, v, rs.rows, rs.target, rs.act_n, rs.act_l)]


def test_substep_core_matches_jax(setup):
    meta_t = setup["env_t"].engine.substep_meta
    meta_j = SubstepMeta(**dataclasses.asdict(meta_t))
    args = _core_inputs(setup, _drop_states(B, 42))
    want = np.asarray(jax.jit(jax.vmap(lambda *a: _substep_core_reference(meta_j, *a)))(
        *[jnp.asarray(x) for x in args]))
    t_args = [torch.tensor(x) for x in args]
    plain = tsl.substep_core(meta_t, *t_args).numpy()
    host = tsl.substep_core_host(meta_t, *t_args).numpy()
    assert tsl.launches == 0              # CPU tensors: the plain version
    _report("substep_core vs JAX", {"plain": (plain, want), "CUDA source": (host, want)})
    np.testing.assert_allclose(plain, want, rtol=CORE_TOL, atol=CORE_TOL)
    np.testing.assert_allclose(host, want, rtol=CORE_TOL, atol=CORE_TOL)
    assert args[6].sum() > 0              # some contacts are active


# ---------------------------------------------------------------------------
# Engine.substep in four modes
# ---------------------------------------------------------------------------

def _configs(mode):
    control = mode if mode in ("torque", "position") else "spd"
    return dict(control_mode=control, fused=mode != "unfused", megastep=False)


def _engine_pair(setup, mode):
    cfg = _configs(mode)
    eng_j = Engine(setup["tree"], EngineConfig(**cfg), gains=setup["gains"])
    env_t = setup["env_t"]
    eng_t = TEngine(env_t.tree, TEngineConfig(**cfg), env_t.engine.gains)
    assert eng_t.mega is None and eng_j.mega is None
    return eng_j, eng_t


def _jax_substep(eng_j, mode):
    """JAX ``Engine.substep`` for one env, jitted (unbatched, it traces and
    compiles in about two thirds of the time of its vmap); the returned
    function runs it on each env of a batch and stacks the results."""
    ret = mode == "unfused"

    def one(st, ts, tr, torques):
        return eng_j.substep(st, ts, tr, torques if mode == "torque" else None,
                             return_torque=ret)

    f = jax.jit(one)

    def run(*batched):
        outs = [f(*jax.tree.map(lambda x: x[i], batched)) for i in range(B)]
        return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *outs)

    return run


def _check_substep(what, got, want):
    """(state, link_contact[, tau]) of both packages under the one-substep
    bounds."""
    pairs = {k: (getattr(got[0], k).numpy(), np.asarray(getattr(want[0], k)))
             for k in POS_FIELDS + VEL_FIELDS}
    if len(want) == 3:
        pairs["tau"] = (got[2].numpy(), np.asarray(want[2]))
    _report(what, pairs)
    for k, (g, w) in pairs.items():
        tol = (TAU_TOL if k == "tau" else SUB_POS_TOL if k in POS_FIELDS
               else SUB_VEL_TOL)
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"{what}: {k}")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]), err_msg=what)


def _engine_vs_jax(setup, modes, monkeypatch):
    for mode in modes:
        eng_j, eng_t = _engine_pair(setup, mode)
        step_j = _jax_substep(eng_j, mode)
        for kind in ("reset", "drop"):
            s = _states(setup, kind, 5)
            ts, tr, torques = _targets(setup["tree"], B, 6)
            want = step_j(_to_jax(s), jnp.asarray(ts), jnp.asarray(tr),
                          [jnp.asarray(t) for t in torques])
            args = (_to_torch(s), torch.tensor(ts), torch.tensor(tr),
                    [torch.tensor(t) for t in torques] if mode == "torque" else None)
            ret = mode == "unfused"
            _check_substep(f"Engine.substep {mode} ({kind}), plain",
                           eng_t.substep(*args, return_torque=ret), want)
            with monkeypatch.context() as m:   # the kernels' host builds
                m.setattr(tsl, "substep_core", tsl.substep_core_host)
                m.setattr(tlinalg, "spd_inverse", tlinalg.spd_inverse_host)
                _check_substep(f"Engine.substep {mode} ({kind}), CUDA sources",
                               eng_t.substep(*args, return_torque=ret), want)
            if kind == "drop":
                assert np.asarray(want[1]).any()   # the contact solver engaged
    assert tsl.launches == 0 and tlinalg.launches == 0


def test_engine_substep_spd_matches_jax(setup, monkeypatch):
    _engine_vs_jax(setup, ("fused", "unfused"), monkeypatch)


def test_engine_substep_torque_position_matches_jax(setup, monkeypatch):
    _engine_vs_jax(setup, ("torque", "position"), monkeypatch)
