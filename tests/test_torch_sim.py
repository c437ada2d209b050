"""PyTorch port: the megastep's physics against JAX, and its CUDA source.

Inputs are made with numpy from a seed and handed to both packages:
perturbed reset states (``tests/test_megastep.py:108-118``) and falling
drop states in ground contact (``tests/test_fused.py:26-40``).

* one substep of the port's plain path against
  ``jax.vmap(Engine._substep_fused_core_full)``: 1e-5 on positions and
  quaternions, 1e-4 on velocities, exact contact flags;
* the port's plain megastep (20 substeps) against the JAX megastep's CPU
  path, under the bounds of ``tests/test_megastep.py:139-152``;
* ``csrc/megastep.cu``'s per-env body, built for the host with g++, against
  the plain version under the same bounds (the kernel's arithmetic, without
  a card); its ``emit_links`` variant, from perturbed and drop states, equal
  to the default variant in state, flags and history, and its link rows
  against JAX's ``link_states(fk(.))`` of the kernel's own final state.

This file keeps to four tests: pytest-xdist's loadfile schedule hands out
files with more tests first, and this slower file should not delay
``tests/test_megastep.py``, the suite's longest.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.envs.deepmimic import make as t_make  # noqa: E402
from pfpn_torch.ops import megastep as tms  # noqa: E402
from pfpn_torch.sim.types import SimState as TSimState  # noqa: E402
from pfpn_tpu.envs.assets import HUMANOID_KD, HUMANOID_KP, humanoid_tree  # noqa: E402
from pfpn_torch.sim.dynamics import fk, link_states  # noqa: E402
from pfpn_tpu.sim.dynamics import fk as j_fk, link_states as j_link_states  # noqa: E402
from pfpn_tpu.sim.engine import Engine, EngineConfig  # noqa: E402
from pfpn_tpu.sim.types import SimState as JSimState, zero_state  # noqa: E402
from pfpn_tpu.control.spd import build_gains  # noqa: E402

torch.set_num_threads(1)

# one substep: same math on both sides, fp32 reassociation only
SUB_POS_TOL = 1e-5     # positions, quaternions, q_rev
SUB_VEL_TOL = 1e-4     # velocities (through the 34x34 inverses, cond ~ 4e4)
# one control step: tests/test_megastep.py:139-152
STEP_TOLS = {"base_pos": 2e-4, "base_quat": 2e-4, "q_sph": 2e-4,
             "w_sph": 5e-3, "q_rev": 2e-4}
HIST_TOL = 2e-4
# emit_links rows against JAX's link_states on the same final state: one FK
# in fp32 on each side (readings ~2e-7 on poses, ~3e-6 on velocities of up
# to 13 rad/s); tighter than test_megastep.py:160-170's 5e-4
LINK_POSE_TOL = 1e-5
LINK_VEL_TOL = 2e-5

POS_FIELDS = ("base_pos", "base_quat", "q_sph", "q_rev")
VEL_FIELDS = ("base_lin", "base_ang", "w_sph", "w_rev")


@pytest.fixture(scope="module")
def setup():
    env = t_make("DeepMimicWalk-v0", device="cpu")
    tree = humanoid_tree()
    eng_j = Engine(tree, EngineConfig(), gains=build_gains(tree, HUMANOID_KP, HUMANOID_KD))
    return env, eng_j


def _np_state(st):
    return {f.name: getattr(st, f.name).numpy().copy() for f in dataclasses.fields(TSimState)}


def _reset_states(env, B, seed):
    """Perturbed reset states (test_megastep.py:108-118) as numpy arrays."""
    rng = np.random.default_rng(seed)
    t0 = torch.tensor(rng.uniform(0.0, 1.0, B) * env.motion.duration, dtype=torch.float32)
    s = _np_state(env.reset_at(t0)[0].sim)
    s["base_lin"] = s["base_lin"] + np.array([0.1, -0.4, 0.0], np.float32)
    s["w_sph"] = s["w_sph"] + 0.3 * rng.standard_normal(s["w_sph"].shape).astype(np.float32)
    s["w_rev"] = s["w_rev"] + 0.3 * rng.standard_normal(s["w_rev"].shape).astype(np.float32)
    return s


def _drop_states(B, seed, height=0.878):
    """Falling states touching the ground (test_fused.py:26-40)."""
    rng = np.random.default_rng(seed)
    z = zero_state(humanoid_tree())
    s = {k: np.broadcast_to(np.asarray(getattr(z, k)), (B,) + np.shape(getattr(z, k))).copy()
         for k in _fields()}
    s["base_pos"][:] = [0.0, height, 0.0]
    s["base_lin"][:] = [0.1, -0.5, 0.05]
    s["base_ang"] = (0.1 * rng.standard_normal((B, 3))).astype(np.float32)
    s["w_sph"] = (0.2 * rng.standard_normal(s["w_sph"].shape)).astype(np.float32)
    s["w_rev"] = (0.2 * rng.standard_normal(s["w_rev"].shape)).astype(np.float32)
    return s


def _fields():
    return [f.name for f in dataclasses.fields(TSimState)]


def _to_jax(s):
    return JSimState(**{k: jnp.asarray(v, dtype=jnp.float32) for k, v in s.items()})


def _to_torch(s):
    return TSimState(**{k: torch.tensor(np.asarray(v), dtype=torch.float32) for k, v in s.items()})


def _targets(B, n_sph, n_rev):
    ts = np.zeros((B, n_sph, 4), np.float32)
    ts[..., 3] = 1.0
    return ts, np.zeros((B, n_rev), np.float32)


def _states(env, kind, B, seed):
    return _reset_states(env, B, seed) if kind == "reset" else _drop_states(B, seed)


def test_substep_matches_jax(setup):
    for kind in ("reset", "drop"):
        _substep_vs_jax(*setup, kind)


def _substep_vs_jax(env, eng_j, kind):
    eng = env.engine
    s = _states(env, kind, 8, 7)
    ts, tr = _targets(8, eng.meta.n_sph, eng.meta.n_rev)
    want, want_act, want_bp = jax.jit(jax.vmap(eng_j._substep_fused_core_full))(
        _to_jax(s), jnp.asarray(ts), jnp.asarray(tr))
    got, got_act, got_bp = eng._substep_fused_core_full(
        _to_torch(s), torch.tensor(ts), torch.tensor(tr))
    _report(f"substep vs JAX ({kind})",
            {k: (getattr(got, k).numpy(), np.asarray(getattr(want, k)))
             for k in POS_FIELDS + VEL_FIELDS})
    for k in POS_FIELDS + VEL_FIELDS:
        tol = SUB_POS_TOL if k in POS_FIELDS else SUB_VEL_TOL
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   atol=tol, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got_act.numpy(), np.asarray(want_act))
    np.testing.assert_allclose(got_bp.numpy(), np.asarray(want_bp), atol=SUB_POS_TOL, rtol=0)
    if kind == "drop":
        assert np.asarray(want_act).any()   # the contact solver engaged


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _report(what, pairs):
    """Print the max abs error of each (got, want) pair (pytest -s shows it)."""
    errs = {k: float(np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).max())
            for k, (g, w) in pairs.items()}
    print(f"\n{what}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))


def _check_step(got, want, what):
    """(state, act, hist) pairs as numpy dicts under the control-step bounds."""
    _report(what, {**{k: (got[0][k], want[0][k]) for k in STEP_TOLS},
                   "hist": (got[2], want[2])})
    for k, tol in STEP_TOLS.items():
        np.testing.assert_allclose(got[0][k], want[0][k], atol=tol, rtol=0, err_msg=k)
    np.testing.assert_allclose(got[2], want[2], atol=HIST_TOL, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])


def test_megastep_plain_matches_jax_megastep(setup):
    env, eng_j = setup
    eng = env.engine
    B = 6
    s = _reset_states(env, B, 11)
    ts, tr = _targets(B, eng.meta.n_sph, eng.meta.n_rev)
    w_st, w_act, w_hist = jax.jit(jax.vmap(eng_j.mega))(
        _to_jax(s), jnp.asarray(ts), jnp.asarray(tr))
    g_st, g_act, g_hist = eng.control_step_full(
        _to_torch(s), torch.tensor(ts), torch.tensor(tr))
    got = ({k: getattr(g_st, k).numpy() for k in _fields()}, g_act.numpy(), g_hist.numpy())
    want = ({k: np.asarray(getattr(w_st, k)) for k in _fields()}, np.asarray(w_act),
            np.asarray(w_hist))
    _check_step(got, want, "megastep vs JAX")
    assert want[1].sum() > 0              # contacts engaged
    assert eng.mega.launches == 0         # CPU tensors: the plain version


def _host_vs_plain(env, s, substeps):
    eng = env.engine
    B = s["base_pos"].shape[0]
    ts, tr = _targets(B, eng.meta.n_sph, eng.meta.n_rev)
    st = tms.pack_state(eng.meta, _to_torch(s))
    args = (st, torch.tensor(ts).reshape(B, -1), torch.tensor(tr))
    got = eng.mega.host(*args, substeps=substeps)
    want = eng.mega.plain(*args, substeps=substeps)

    def unpack(out):
        sim = tms.unpack_state(eng.meta, out[0], _to_torch(s))
        return ({k: getattr(sim, k).numpy() for k in _fields()},
                out[1].numpy(), out[2].numpy())

    return unpack(got), unpack(want)


def test_cuda_source_one_substep_matches_plain(setup):
    for kind in ("reset", "drop"):
        _cuda_source_one_substep(setup[0], kind)


def _cuda_source_one_substep(env, kind):
    got, want = _host_vs_plain(env, _states(env, kind, 16, 5), 1)
    _report(f"CUDA source, one substep ({kind})",
            {k: (got[0][k], want[0][k]) for k in POS_FIELDS + VEL_FIELDS})
    for k in POS_FIELDS + VEL_FIELDS:
        tol = SUB_POS_TOL if k in POS_FIELDS else SUB_VEL_TOL
        np.testing.assert_allclose(got[0][k], want[0][k], atol=tol, rtol=0, err_msg=k)
    np.testing.assert_allclose(got[2], want[2], atol=SUB_POS_TOL, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])
    if kind == "drop":
        assert want[1].any()


def test_cuda_source_control_step_matches_plain(setup):
    env, _ = setup
    got, want = _host_vs_plain(env, _reset_states(env, 6, 11), None)
    _check_step(got, want, "CUDA source, control step")
    assert want[1].sum() > 0
    for kind in ("reset", "drop"):
        _cuda_source_emit_links(env, kind)


def _cuda_source_emit_links(env, kind):
    """The megastep's emit_links variant, host-built: its state, flags and
    history equal the default variant's exactly, and its link rows match
    JAX's ``link_states(tree, fk(tree, .))`` of its own final state
    (quaternions up to sign)."""
    eng = env.engine
    tree_t = env.tree
    links = tms.Megastep(eng.meta, eng._substep_fused_core_full,
                         link_state_fn=lambda st: link_states(tree_t, fk(tree_t, st)))
    s = _states(env, kind, 16, 23)
    ts, tr = _targets(16, eng.meta.n_sph, eng.meta.n_rev)
    args = (tms.pack_state(eng.meta, _to_torch(s)), torch.tensor(ts).reshape(16, -1),
            torch.tensor(tr))
    plain_out = eng.mega.host(*args)
    out = links.host(*args)
    for a, b in zip(plain_out, out[:3]):
        assert torch.equal(a, b)
    final = tms.unpack_state(eng.meta, out[0], _to_torch(s))
    tree_j = humanoid_tree()
    want = jax.jit(jax.vmap(lambda st: j_link_states(tree_j, j_fk(tree_j, st))))(
        _to_jax({k: getattr(final, k).numpy() for k in _fields()}))
    got = tms.links_to_states(eng.meta, out[3])
    errs = {}
    for k in got._fields:
        g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        if "quat" in k:
            g = g * np.sign(np.sum(g * w, -1, keepdims=True))
        errs[k] = _max_err(g, w)
    print(f"\nCUDA source, emit_links ({kind}) vs JAX link_states: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    for k, v in errs.items():
        assert v <= (LINK_VEL_TOL if "vel" in k else LINK_POSE_TOL), k
    if kind == "drop":
        assert out[1].any()

