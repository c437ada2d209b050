"""PyTorch port: the off-policy slice as a whole against the JAX package.

* the replay ring (``pfpn_torch/algos/replay.py``) against
  ``pfpn_tpu.algos.replay`` on the same inserts through a wrap: the packed
  contents, field by field and dtype by dtype, ``pointer`` and ``size``
  exactly; a draw takes whole rows of the filled part;
* the shipped SAC + PFPN-35 Walk policy loaded on both sides (the JAX
  package's ``tools/export_policy.py`` ``unflatten``, the port's
  ``load_jax_params`` with its ``q1``, ``q2`` and 0-d ``log_alpha``): the
  deterministic actions on 16 reset observations of the JAX env at full
  width (ACT_TOL), and two steps of each package's ``SAC.evaluate`` from the
  same start phases, JAX's env against the port's (REWARD_TOL);

A SAC round through ``python -m pfpn_torch ... --train`` on the CPU, its
resume without the ring, the evaluation through the CLI and the export of
its checkpoint are held in ``tests/test_torch_eval.py``.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.algos.replay import ReplayBuffer  # noqa: E402
from pfpn_torch.harness import settings  # noqa: E402
from pfpn_torch.harness.build import build_algo  # noqa: E402
from pfpn_torch.tools.export_policy import load_policy  # noqa: E402
from pfpn_tpu.algos import replay as j_replay  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAC_NPZ = os.path.join(ROOT, "results", "policies",
                       "DeepMimicWalk-v0_deepmimic_sac_pfpn_particle35_34114_step11138592.npz")
ACT_TOL = 1e-5
REWARD_TOL = 1e-4


def test_replay_ring_matches_jax():
    rng = np.random.default_rng(0)
    cap, n = 10, 4

    def batch():
        return {"obs": rng.standard_normal((n, 3)).astype(np.float32),
                "action": rng.standard_normal((n, 2)).astype(np.float16),
                "reward": rng.standard_normal(n).astype(np.float32),
                "not_terminal": rng.random(n) > 0.3,
                "tag": rng.integers(-100, 100, (n, 2)).astype(np.int8)}

    first = batch()
    buf_j = j_replay.create(cap, {k: jnp.asarray(v) for k, v in first.items()})
    buf_t = ReplayBuffer(cap, {k: torch.tensor(v) for k, v in first.items()})
    assert [k for k, _ in buf_t.spec] == [k for k, _ in buf_j.spec]
    for i in range(5):                       # 20 inserts: the ring wraps twice
        b = first if i == 0 else batch()
        buf_j = j_replay.add_batch(buf_j, {k: jnp.asarray(v) for k, v in b.items()})
        buf_t.add_batch({k: torch.tensor(v) for k, v in b.items()})
        assert (buf_t.pointer, buf_t.size) == (int(buf_j.pointer), int(buf_j.size))
        np.testing.assert_array_equal(buf_t.data.numpy(), np.asarray(buf_j.data))
    got, want = buf_t.contents(), j_replay.contents(buf_j)
    for k, v in want.items():
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)

    # a draw is whole rows of the filled part: every field of a drawn
    # transition comes from one row
    part = ReplayBuffer(cap, {k: torch.tensor(v) for k, v in first.items()})
    part.add_batch({k: torch.tensor(v) for k, v in first.items()})
    draw = part.sample(64, torch.Generator().manual_seed(1))
    rows = {tuple(r) for r in part.data[:n].tolist()}
    packed = torch.cat([draw[k].reshape(64, -1).float() for k, _ in part.spec], 1)
    assert {tuple(r) for r in packed.tolist()} <= rows
    assert len({tuple(r) for r in packed.tolist()}) == n


def _unflatten():
    spec = importlib.util.spec_from_file_location(
        "jax_export_policy", os.path.join(ROOT, "tools", "export_policy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.unflatten


def test_shipped_sac_policy_acts_and_evaluates_as_jax():
    from pfpn_tpu.harness.build import build_algo as j_build_algo
    from pfpn_tpu.harness.settings import build as j_build

    episodes = 16
    with np.load(SAC_NPZ) as z:
        data = {k: z[k] for k in z.files}
    algo_j = j_build_algo(j_build("deepmimic_sac_pfpn", particles=35))
    params = _unflatten()({k[len("params/"):]: jnp.asarray(v, jnp.float32)
                           for k, v in data.items() if k.startswith("params/")})
    norm = algo_j.net.init_norm()._replace(**{
        k[len("norm/"):]: jnp.asarray(v, jnp.float32) for k, v in data.items()
        if k.startswith("norm/")})
    key = jax.random.PRNGKey(3)
    env_state, obs = jax.jit(algo_j.env.reset_batch)(jax.random.split(key, episodes))
    want = np.asarray(jax.jit(algo_j._actor_mode)(params, norm, obs))
    out_j = jax.jit(lambda p, n, k: algo_j.evaluate(p, n, k, num_episodes=episodes,
                                                    max_steps=2))(params, norm, key)

    # the port: the preset's algorithm with a ring of one transition (the
    # preset's million would take 1.7 GB of host memory here)
    cfg = settings.build("deepmimic_sac_pfpn", particles=35)
    cfg = dataclasses.replace(cfg, worker=dataclasses.replace(cfg.worker, buffer_capacity=1))
    algo = build_algo(cfg, "cpu")
    load_policy(algo, SAC_NPZ)
    assert float(algo.net.log_alpha.detach()) == float(data["params/log_alpha"])
    with torch.no_grad():
        got = algo.net.act_deterministic(torch.tensor(np.asarray(obs))).numpy()
    err = float(np.abs(got.astype(np.float64) - want).max())
    print(f"\nshipped SAC policy, deterministic actions on {episodes} reset observations: "
          f"JAX vs port {err:.2e} (max |action| {np.abs(want).max():.3g})")
    assert got.shape == want.shape == (episodes, 36)
    assert err <= ACT_TOL
    out = algo.evaluate(num_episodes=episodes, max_steps=2,
                        init_time=torch.tensor(np.asarray(env_state.init_time)))
    rew, rew_j = out["reward"].numpy(), np.asarray(out_j["reward"])
    err = float(np.abs(rew.astype(np.float64) - rew_j).max())
    print(f"two evaluate steps from JAX's start phases: return JAX vs port {err:.2e} "
          f"(mean {rew_j.mean():.4f})")
    np.testing.assert_array_equal(out["frames"].numpy(), np.asarray(out_j["frames"]))
    assert err <= REWARD_TOL * np.abs(rew_j).max()
