"""PyTorch port: the CUDA sources of ``spd_inverse`` and ``substep_lin``,
built with g++, at the card's thread counts and against JAX.

Each source holds two kernels, chosen by shape: a body specialised for the
humanoid (``spd_inverse``: one warp per 34 x 34 matrix in registers;
``substep_lin``: two warps per env for 34 dofs, 16 contacts and 8 limit
rows) and the first design for every other shape (one block per matrix or
env). The host build runs a body on as many host threads as the card runs
it (32, 64, 256 or 128), with ``std::barrier`` in place of the card's
syncs, or on one thread that runs every lane in turn. A missing sync lets
the host threads race, so each test holds the device thread count
bit-equal to one thread, then the result against JAX
(``_spd_inverse_reference``, ``_substep_core_reference``) at the bounds of
``tests/test_torch_substep.py``.

Inputs are made with numpy from a seed: H + diag(kd dt) + eps and H + eps
from perturbed reset and drop states (``tests/test_torch_substep.py``), a
random SPD 12 x 12 batch for the generic inverse, and the
``substep_core`` inputs of ``tests/test_fused.py:100-118`` at B = 8, for
the generic body with the first 8 of the 16 contacts' rows.

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

from pfpn_torch.envs.deepmimic import make as t_make  # noqa: E402
from pfpn_torch.ops import linalg as tlinalg  # noqa: E402
from pfpn_torch.ops import substep_lin as tsl  # noqa: E402
from pfpn_tpu.ops.linalg import _spd_inverse_reference  # noqa: E402
from pfpn_tpu.ops.substep_lin import SubstepMeta, _substep_core_reference  # noqa: E402
from test_torch_substep import (CORE_TOL, INV_REL_TOL, INV_RESID_TOL,  # noqa: E402
                                _core_inputs, _drop_states, _h_pairs, _states)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    return {"env_t": t_make("DeepMimicWalk-v0", device="cpu")}


def _humanoid_pairs(setup):
    reset, drop = (_states(setup, kind, 13) for kind in ("reset", "drop"))
    return _h_pairs(setup, {k: np.concatenate([reset[k], drop[k]]) for k in reset})


def _generic_spd(n=12, count=8, seed=17):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((count, n, n))
    return (m @ m.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("body", ["warp", "block"])
def test_spd_inverse_host_threads_and_jax(setup, body):
    """The N = 34 warp body (32 lanes) and the generic block body (256
    threads): the device thread count bit-equal to one thread; both within
    the inverse's bounds of JAX's Cholesky reference."""
    mats = (_humanoid_pairs(setup).reshape(-1, 34, 34) if body == "warp"
            else _generic_spd())
    n = mats.shape[-1]
    threads = tlinalg.group_threads(n, host=True)
    assert threads == (32 if body == "warp" else 256)
    a = torch.tensor(mats)
    one = tlinalg.spd_inverse_host(a, threads=1)
    many = tlinalg.spd_inverse_host(a, threads=threads)
    assert torch.equal(one, many), f"{body}: {threads} threads differ from 1"
    want = np.asarray(jax.vmap(_spd_inverse_reference)(jnp.asarray(mats)), np.float64)
    x = many.numpy().astype(np.float64)
    rel = np.abs(x - want).max() / np.abs(want).max()
    resid = np.abs(mats.astype(np.float64) @ x - np.eye(n)).max()
    print(f"\nspd_inverse {body} body, N={n}, {threads} host threads: bit-equal to 1 thread; "
          f"rel err vs JAX {rel:.2e}, max |A X - I| {resid:.2e}")
    assert rel <= INV_REL_TOL
    assert resid <= INV_RESID_TOL


def _reduced_rows(meta, args, k2):
    """The inputs with only the first k2 of the K contacts' rows: a shape the
    two-warp kernel does not take."""
    K = meta.n_contacts
    rows, tgt, act_n = args[4], args[5], args[6]
    keep = np.r_[0:k2, K:K + k2, 2 * K:2 * K + k2, 3 * K:rows.shape[1]]
    args = list(args)
    args[4], args[5], args[6] = (np.ascontiguousarray(rows[:, keep]),
                                 np.ascontiguousarray(tgt[:, keep]),
                                 np.ascontiguousarray(act_n[:, :k2]))
    return dataclasses.replace(meta, n_contacts=k2), args


@pytest.mark.parametrize("body", ["warps", "block"])
def test_substep_core_host_threads_and_jax(setup, body):
    """The two-warp body (64 lanes, the humanoid's shape) and the generic
    block body (128 threads, 8 contacts): the device thread count bit-equal
    to one thread; both within rtol = atol = 2e-4 of JAX
    (tests/test_fused.py:121)."""
    meta_t = setup["env_t"].engine.substep_meta
    args = _core_inputs(setup, _drop_states(8, 42))
    if body == "block":
        meta_t, args = _reduced_rows(meta_t, args, 8)
    threads = tsl.block_threads(meta_t, host=True)
    assert threads == (64 if body == "warps" else 128)
    t_args = [torch.tensor(x) for x in args]
    one = tsl.substep_core_host(meta_t, *t_args, threads=1)
    many = tsl.substep_core_host(meta_t, *t_args, threads=threads)
    assert torch.equal(one, many), f"{body}: {threads} threads differ from 1"
    meta_j = SubstepMeta(**dataclasses.asdict(meta_t))
    want = np.asarray(jax.jit(jax.vmap(lambda *a: _substep_core_reference(meta_j, *a)))(
        *[jnp.asarray(x) for x in args]))
    err = float(np.abs(many.numpy().astype(np.float64) - want).max())
    print(f"\nsubstep_core {body} body, {threads} host threads: bit-equal to 1 thread; "
          f"max abs err vs JAX {err:.2e}, {int(args[6].sum())} active contacts")
    np.testing.assert_allclose(many.numpy(), want, rtol=CORE_TOL, atol=CORE_TOL)
    assert args[6].sum() > 0              # some contacts are active
    assert tsl.launches == 0 and tlinalg.launches == 0
