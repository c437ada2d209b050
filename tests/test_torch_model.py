"""PyTorch port: static model tables and quaternion algebra against JAX.

* every ``humanoid_tree()`` table and every ``build_meta`` field of the port
  equals the JAX package's exactly, and so does the packed state layout;
* the megastep wrapper never falls back: on CPU tensors it runs the plain
  version and launches nothing, and the kernel refuses CPU tensors;
* each quaternion op of ``pfpn_torch.math.quaternion`` matches
  ``pfpn_tpu.math.quaternion`` to 1e-6 on random batches made with numpy,
  on the cases of ``tests/test_quaternion.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pfpn_torch.control.spd import build_gains as t_build_gains  # noqa: E402
from pfpn_torch.envs.assets import (  # noqa: E402
    HUMANOID_KD as T_KD, HUMANOID_KP as T_KP, humanoid_tree as t_humanoid_tree,
)
from pfpn_torch.math import quaternion as tq  # noqa: E402
from pfpn_torch.ops import megastep as tms  # noqa: E402
from pfpn_torch.sim.engine import Engine as TEngine, EngineConfig as TEngineConfig  # noqa: E402
from pfpn_torch.sim.types import SimState as TSimState, sim_state_from_numpy  # noqa: E402
from pfpn_tpu.envs.assets import HUMANOID_KD, HUMANOID_KP, humanoid_tree  # noqa: E402
from pfpn_tpu.sim import contact as j_contact  # noqa: E402
from pfpn_tpu.control.spd import build_gains as j_build_gains  # noqa: E402
from pfpn_tpu.math import quaternion as jq  # noqa: E402
from pfpn_tpu.ops import megastep as jms  # noqa: E402
from pfpn_tpu.sim.contact import ContactParams  # noqa: E402
from pfpn_tpu.sim.types import SimState as JSimState  # noqa: E402

torch.set_num_threads(1)

QUAT_TOL = 1e-6   # fp32 ops on unit quaternions, same formulas both sides


def _eq(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def test_humanoid_tree_tables_equal_jax():
    t, j = t_humanoid_tree(), humanoid_tree()
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name == "geoms":   # two Geom classes: compare their fields
            a = [dataclasses.astuple(g) for g in a]
            b = [dataclasses.astuple(g) for g in b]
        _eq(a, b, f.name)
    assert t.nb == 13 and t.ndof == 34 and t.n_sph == 8 and t.n_rev == 4


def test_gain_tables_equal_jax():
    assert T_KP == HUMANOID_KP and T_KD == HUMANOID_KD
    gt = t_build_gains(t_humanoid_tree(), T_KP, T_KD)
    gj = j_build_gains(humanoid_tree(), HUMANOID_KP, HUMANOID_KD)
    np.testing.assert_array_equal(gt.kp, gj.kp)
    np.testing.assert_array_equal(gt.kd, gj.kd)


@pytest.fixture(scope="module")
def engines():
    """The port's engine (CPU) and the JAX package's MegaMeta and contact set."""
    tree_j = humanoid_tree()
    gains_j = j_build_gains(tree_j, HUMANOID_KP, HUMANOID_KD)
    cs_j = j_contact.build_contact_set(tree_j)
    meta_j = jms.build_meta(tree_j, gains_j, ContactParams(), cs_j,
                            1.0 / 600.0, 20, (0.0, -9.8, 0.0))
    tree_t = t_humanoid_tree()
    eng = TEngine(tree_t, TEngineConfig(), t_build_gains(tree_t, T_KP, T_KD))
    return eng, meta_j, cs_j


def test_build_meta_equals_jax(engines):
    eng, meta_j, cs_j = engines
    for f in dataclasses.fields(jms.MegaMeta):
        assert getattr(eng.meta, f.name) == getattr(meta_j, f.name), f.name
    assert sim_state_from_numpy(meta_j) == eng.meta
    for f in cs_j._fields:
        _eq(getattr(eng.contact_set, f), getattr(cs_j, f), f)
    # humanoid sizes: 37 candidates, K = 16, 8 limit rows, 56 rows, 77 state rows
    m = eng.meta
    assert (m.n_cand, m.n_contacts, m.n_lim, m.n_rows, m.rows_state) == (37, 16, 8, 56, 77)
    assert (m.iterations, m.frame_skip) == (16, 20)


def _random_sim(B, seed):
    rng = np.random.default_rng(seed)

    def unit(*shape):
        q = rng.standard_normal(shape + (4,)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    f = lambda *shape: rng.standard_normal((B,) + shape).astype(np.float32)  # noqa: E731
    return {"base_pos": f(3), "base_quat": unit(B), "base_lin": f(3), "base_ang": f(3),
            "q_sph": unit(B, 8), "w_sph": f(8, 3), "q_rev": f(4), "w_rev": f(4)}


def test_pack_state_matches_jax(engines):
    eng, meta_j, _ = engines
    s = _random_sim(4, 3)
    st_j = JSimState(**{k: jnp.asarray(v) for k, v in s.items()})
    st_t = TSimState(**{k: torch.tensor(v) for k, v in s.items()})
    got = tms.pack_state(eng.meta, st_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jms.pack_state(meta_j, st_j)))
    back = tms.unpack_state(eng.meta, got, st_t)
    conv = sim_state_from_numpy(st_j)
    for k, v in s.items():
        np.testing.assert_array_equal(getattr(back, k).numpy(), v)
        np.testing.assert_array_equal(getattr(conv, k).numpy(), v)


def test_megastep_wrapper_never_falls_back(engines):
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; the kernel itself refuses CPU tensors; bad inputs raise."""
    mega = engines[0].mega
    s = _random_sim(2, 1)
    st = tms.pack_state(engines[0].meta, TSimState(**{k: torch.tensor(v) for k, v in s.items()}))
    ts = torch.zeros(2, 32)
    ts[:, 3::4] = 1.0
    tr = torch.zeros(2, 4)
    out = mega.run(st, ts, tr, substeps=1)
    assert mega.launches == 0
    assert out[0].shape == (2, 77) and out[1].shape == (2, 37) and out[2].shape == (2, 1, 3)
    with pytest.raises(ValueError, match="CUDA"):
        mega.kernel(st, ts, tr)
    with pytest.raises(TypeError):
        mega.run(st.double(), ts, tr)
    with pytest.raises(ValueError):
        mega.run(st[:, :70], ts, tr)
    assert mega.launches == 0


# ---------------------------------------------------------------------------
# quaternions
# ---------------------------------------------------------------------------

def _rng():
    return np.random.default_rng(1234)


def _unit(rng, n=64):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _cases():
    rng = _rng()
    q0, q1 = _unit(rng), _unit(rng)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    w = (0.5 * rng.standard_normal((64, 3))).astype(np.float32)
    ang = rng.uniform(-3.0, 3.0, 64).astype(np.float32)
    axis = v.copy()
    axis[:4] = 0.0                      # zero axes give the identity
    ident = np.tile(np.array([0, 0, 0, 1], np.float32), (64, 1))
    near_ident = ident.copy()
    near_ident[:, :3] = 1e-9
    small = (1e-8 * v).astype(np.float32)
    t = rng.uniform(0.0, 1.0, 64).astype(np.float32)
    opp = -q0 + 1e-3 * _unit(rng)       # opposite hemisphere: shortest path
    return {
        "multiply": ("quat_multiply", (q0, q1)),
        "multiply_identity": ("quat_multiply", (q0, ident)),
        "multiply_conjugate": ("quat_multiply", (q0, np.asarray(jq.quat_conjugate(q0)))),
        "conjugate": ("quat_conjugate", (q0,)),
        "normalize": ("quat_normalize", (3.0 * q0,)),
        "diff": ("quat_diff", (q0, q1)),
        "diff_rel": ("quat_diff_rel", (q0, q1)),
        "rotate": ("quat_rotate", (q0, v)),
        "rotate_inv": ("quat_rotate_inv", (q0, v)),
        "to_matrix": ("quat_to_matrix", (q0,)),
        "from_axis_angle": ("quat_from_axis_angle", (axis, ang)),
        "to_axis_angle": ("quat_to_axis_angle", (q0,)),
        "to_axis_angle_identity": ("quat_to_axis_angle", (near_ident,)),
        "log": ("quat_log", (q0,)),
        "exp": ("quat_exp", (v,)),
        "exp_small": ("quat_exp", (small,)),
        "slerp": ("quat_slerp", (q0, q1, t)),
        "slerp_endpoints": ("quat_slerp", (q0, q1, np.float32(0.0))),
        "slerp_shortest_path": ("quat_slerp", (q0, opp, np.float32(0.5))),
        "integrate_world": ("quat_integrate_world", (q0, w, 1.0 / 600.0)),
        "integrate_local": ("quat_integrate_local", (q0, w, 1.0 / 600.0)),
        "to_euler_zyx": ("quat_to_euler_zyx", (q0,)),
        "yaw_about_up": ("yaw_about_up", (q0,)),
        "angle": ("quat_angle", (q0,)),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_quaternion_op_matches_jax(case):
    fn, args = _cases()[case]
    t_args = [torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    j_args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    got = getattr(tq, fn)(*t_args)
    want = getattr(jq, fn)(*j_args)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=QUAT_TOL, rtol=0)
