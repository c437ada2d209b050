"""PyTorch port: the level-batched dynamics (``pfpn_torch/sim/batched.py``)
and ``EngineConfig.fast_dynamics`` against JAX.

* ``compute`` against JAX's ``compute`` and against the port's recursion
  (``fk``, ``crba``, ``rnea``, ``pack_velocity``) on perturbed states made
  with numpy from a seed, as ``tests/test_batched.py:14-45`` makes them
  (away from the origin, random base and joint rotations and velocities),
  with that test's bounds: body positions and ``v`` 1e-5, link velocities
  1e-4, H 2e-3, C 2e-3 max(1, |C|);
* one fused Stable-PD substep with the megastep off, and one control step
  (20 such substeps), with ``fast_dynamics`` on both sides, from perturbed
  reset states under random targets: positions, quaternions and ``q_rev``
  within 2e-4 (the porting rules' kernel bound, ``tests/test_megastep.py:
  139-152``), velocities within 1e-3 after one substep (through the two
  34 x 34 inverses at cond ~ 4e4). JAX's control step is its jitted
  substep run 20 times, which is what its ``control_step`` scans.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.envs.assets import humanoid_tree as t_humanoid_tree  # noqa: E402
from pfpn_torch.envs.deepmimic import make as t_make  # noqa: E402
from pfpn_torch.ops import substep_lin  # noqa: E402
from pfpn_torch.sim import batched as t_batched  # noqa: E402
from pfpn_torch.sim.dynamics import crba, fk, pack_velocity, rnea  # noqa: E402
from pfpn_torch.sim.engine import Engine as TEngine, EngineConfig as TEngineConfig  # noqa: E402
from pfpn_torch.sim.types import SimState as TSimState  # noqa: E402
from pfpn_tpu.sim.engine import Engine, EngineConfig  # noqa: E402  (before control)
from pfpn_tpu.control.spd import build_gains  # noqa: E402
from pfpn_tpu.envs.assets import HUMANOID_KD, HUMANOID_KP, humanoid_tree  # noqa: E402
from pfpn_tpu.sim import batched as j_batched  # noqa: E402
from pfpn_tpu.sim.types import SimState as JSimState  # noqa: E402

torch.set_num_threads(1)

B = 4
G = (0.0, -9.8, 0.0)
POS_TOL = 2e-4          # positions, quaternions, q_rev
VEL_TOL = 1e-3          # velocities after one substep
FIELDS = [f.name for f in dataclasses.fields(TSimState)]
POS_FIELDS = ("base_pos", "base_quat", "q_sph", "q_rev")


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _perturbed(tree, seed):
    """tests/test_batched.py:18-28's state, B times, from numpy."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal((B,) + s).astype(np.float32)  # noqa: E731
    return {"base_pos": np.tile(np.float32([3.0, 1.2, -2.0]), (B, 1)),
            "base_quat": _unit(n(4)), "base_lin": 0.5 * n(3), "base_ang": 0.5 * n(3),
            "q_sph": _unit(n(tree.n_sph, 4)), "w_sph": 0.5 * n(tree.n_sph, 3),
            "q_rev": np.tile(np.float32([-1.0, 0.5, -1.0, 0.5]), (B, 1)),
            "w_rev": 0.5 * n(tree.n_rev)}


def _report(what, pairs):
    errs = {k: float(np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).max())
            for k, (g, w) in pairs.items()}
    print(f"\n{what}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return errs


def test_compute_matches_jax_and_recursion():
    tree_j, tree_t = humanoid_tree(), t_humanoid_tree()
    s = _perturbed(tree_j, 7)
    st = TSimState(**{k: torch.tensor(v) for k, v in s.items()})
    tb = t_batched.build_tables(tree_t)
    bd = t_batched.compute(tree_t, tb, st, G)
    assert bd.h.shape == (B, tree_t.ndof, tree_t.ndof) and bd.c.shape == (B, tree_t.ndof)

    tb_j = j_batched.build_tables(tree_j)
    want = jax.jit(jax.vmap(lambda x: j_batched.compute(tree_j, tb_j, x, jnp.asarray(G))))(
        JSimState(**{k: jnp.asarray(v) for k, v in s.items()}))
    fkr = fk(tree_t, st)
    rec = {"body_pos": fkr.body_pos, "v": pack_velocity(tree_t, st, fkr), "link v": fkr.v,
           "H": crba(tree_t, fkr), "C": rnea(tree_t, fkr, gravity=G)}
    got = {"body_pos": bd.fkr.body_pos, "v": bd.v, "link v": bd.fkr.v, "H": bd.h, "C": bd.c}
    jax_out = {"body_pos": want.fkr.body_pos, "v": want.v, "link v": want.fkr.v,
               "H": want.h, "C": want.c}
    c_scale = max(1.0, float(np.abs(rec["C"].numpy()).max()))
    tol = {"body_pos": 1e-5, "v": 1e-5, "link v": 1e-4, "H": 2e-3, "C": 2e-3 * c_scale}
    for ref_name, ref in (("JAX compute", jax_out), ("the recursion", rec)):
        errs = _report(f"compute against {ref_name}",
                       {k: (got[k].numpy(), np.asarray(ref[k])) for k in got})
        for k, e in errs.items():
            assert e <= tol[k], (ref_name, k, e)


def test_fast_dynamics_substep_and_control_step_match_jax():
    env_t = t_make("DeepMimicWalk-v0", device="cpu")
    tree_j = humanoid_tree()
    gains_j = build_gains(tree_j, HUMANOID_KP, HUMANOID_KD)
    eng_j = Engine(tree_j, EngineConfig(dt=env_t.dt, fast_dynamics=True, megastep=False),
                   gains_j)
    eng_t = TEngine(env_t.tree, TEngineConfig(dt=env_t.dt, fast_dynamics=True, megastep=False),
                    env_t.engine.gains)
    assert eng_t.batched_tables is not None and eng_t.mega is None

    # perturbed reset states (tests/test_megastep.py:108-118) and targets
    rng = np.random.default_rng(5)
    t0 = torch.tensor(rng.uniform(0.0, 1.0, B) * env_t.motion.duration, dtype=torch.float32)
    sim = env_t.reset_at(t0)[0].sim
    s = {k: getattr(sim, k).numpy().copy() for k in FIELDS}
    s["base_lin"] = s["base_lin"] + np.float32([0.1, -0.4, 0.0])
    s["w_sph"] = s["w_sph"] + 0.3 * rng.standard_normal(s["w_sph"].shape).astype(np.float32)
    s["w_rev"] = s["w_rev"] + 0.3 * rng.standard_normal(s["w_rev"].shape).astype(np.float32)
    ts = _unit(np.concatenate([0.1 * rng.standard_normal((B, tree_j.n_sph, 3)),
                               np.ones((B, tree_j.n_sph, 1))], -1))
    tr = rng.uniform(-0.5, 0.5, (B, tree_j.n_rev)).astype(np.float32)

    sub = jax.jit(jax.vmap(lambda x, a, b: eng_j.substep(x, a, b)))
    st_j = JSimState(**{k: jnp.asarray(v) for k, v in s.items()})
    st_t = TSimState(**{k: torch.tensor(v) for k, v in s.items()})
    ts_j, tr_j, ts_t, tr_t = jnp.asarray(ts), jnp.asarray(tr), torch.tensor(ts), torch.tensor(tr)

    substep_lin.launches = 0
    one_j, lc_j = sub(st_j, ts_j, tr_j)
    one_t, lc_t = eng_t.substep(st_t, ts_t, tr_t)
    errs = _report("one fused substep, fast_dynamics", {
        k: (getattr(one_t, k).numpy(), np.asarray(getattr(one_j, k))) for k in FIELDS})
    for k, e in errs.items():
        assert e <= (POS_TOL if k in POS_FIELDS else VEL_TOL), k
    np.testing.assert_array_equal(lc_t.numpy(), np.asarray(lc_j))

    for _ in range(eng_j.config.frame_skip - 1):
        one_j, _ = sub(one_j, ts_j, tr_j)
    full_t, _ = eng_t.control_step(st_t, ts_t, tr_t)
    assert substep_lin.launches == 0          # CPU tensors: the plain version
    errs = _report("one control step, fast_dynamics", {
        k: (getattr(full_t, k).numpy(), np.asarray(getattr(one_j, k))) for k in POS_FIELDS})
    for k, e in errs.items():
        assert e <= POS_TOL, k
