"""PyTorch port: evaluation through the CLI and the policy export.

* ``python -m pfpn_torch ...`` without ``--train`` on the CPU, shrunk as
  ``tests/test_torch_train.py::test_cli_trains_and_resumes_on_cpu`` is (two
  envs, a 4-step unroll, one training round first; a 12-step evaluation,
  episodes cut at 0.09 s so that frames after ``done`` are recorded too):
  the trajectory npz has the JAX package's keys and shapes, and the
  printed returns equal ``PPO.evaluate``'s from the same start states;
* a port checkpoint exported by ``pfpn_torch.tools.export_policy`` and
  loaded through ``tools/export_policy.py``'s ``unflatten`` into the JAX
  package's network gives the port's deterministic action to 1e-5: the
  particle preset on Walk and the categorical preset on MultiTask (200-wide
  observations), at full width; the exported npz then plays through the
  tool's ``--play`` with ``--record`` (shrunk to two episodes of four
  steps), which writes a trajectory in the same layout;
* the off-policy presets through the CLI on the CPU, ``deepmimic_sac_pfpn``
  at a tiny size (trunks of 32, 8 particles, batch 8, a ring of 10, two
  envs, rounds of 6 env steps): a round inserts 12 transitions (the ring
  wraps) and runs 2 gradient steps per env step once the ring holds 8
  (``tests/test_algos.py``'s ratio rule: 3 x 2 = 6); the checkpoint holds
  no ring and restores the parameters, targets and three-group Adam state;
  a second run resumes with a fresh, empty ring (6 more steps); the CLI
  without ``--train`` evaluates it as ``SAC.evaluate`` does; the export
  has the JAX package's SAC layout (``q1``, ``q2``, ``log_alpha``, no
  targets), and the JAX package's network acts on it as the port does
  (1e-5); ``--play`` replays it.

Run as a script, this file prints the JAX package's own deterministic play
of the shipped Punch, Kick and MultiTask DPPO policies, or with
``--setting deepmimic_sac_pfpn`` of the shipped SAC + PFPN-35 Walk policy
(``tools/export_policy.py --play``'s ``evaluate`` from ``PRNGKey(k)`` split
10 ways): each episode's start time and return. ``chip_smoke.py`` plays the
port from those start times and holds its mean return against JAX's::

  JAX_PLATFORMS=cpu python tests/test_torch_eval.py [--keys 0 1] [--env ...]
  JAX_PLATFORMS=cpu python tests/test_torch_eval.py --setting deepmimic_sac_pfpn --keys 0 1
"""

import dataclasses
import functools
import importlib
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICIES = {   # setting -> env -> shipped npz
    "deepmimic_dppo_pfpn": {
        "DeepMimicPunch-v0": "DeepMimicPunch-v0_deepmimic_dppo_pfpn_particle35_34114_step58608.npz",
        "DeepMimicKick-v0": "DeepMimicKick-v0_deepmimic_dppo_pfpn_particle35_34114_step58608.npz",
        "DeepMimicMultiTask-v0":
            "DeepMimicMultiTask-v0_deepmimic_dppo_pfpn_particle35_34114_step175792.npz",
    },
    "deepmimic_sac_pfpn": {
        "DeepMimicWalk-v0":
            "DeepMimicWalk-v0_deepmimic_sac_pfpn_particle35_34114_step11138592.npz",
    },
}


def jax_play(env_name: str, npz: str, key: int, episodes: int = 10, max_steps: int = 600,
             setting: str = "deepmimic_dppo_pfpn"):
    """(init_time (E,), return (E,), frames (E,)) of the JAX package's
    deterministic play of ``setting``'s policy, as ``tools/export_policy.py
    --play`` runs it."""
    import jax
    import jax.numpy as jnp

    from pfpn_tpu.harness.build import build_algo
    from pfpn_tpu.harness.settings import build

    algo = build_algo(build(setting, particles=35, env=env_name))
    with np.load(npz) as z:
        data = {k: z[k] for k in z.files}
    params = _export_tool().unflatten({k[len("params/"):]: jnp.asarray(v, jnp.float32)
                                       for k, v in data.items() if k.startswith("params/")})
    norm = algo.net.init_norm()._replace(**{
        k[len("norm/"):]: jnp.asarray(v, jnp.float32) for k, v in data.items()
        if k.startswith("norm/")})
    k = jax.random.PRNGKey(key)
    state, _ = algo.env.reset_batch(jax.random.split(k, episodes))
    out = jax.jit(lambda p, n, kk: algo.evaluate(p, n, kk, num_episodes=episodes,
                                                 max_steps=max_steps))(params, norm, k)
    return (np.asarray(state.init_time), np.asarray(out["reward"]),
            np.asarray(out["frames"]))


def _export_tool():
    """tools/export_policy.py as a module (its ``unflatten``)."""
    spec = importlib.util.spec_from_file_location(
        "jax_export_policy", os.path.join(ROOT, "tools", "export_policy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny(build):
    """The preset at a tiny size (test_torch_train.py's shrink)."""
    def tiny(*args, **kwargs):
        cfg = build(*args, **kwargs)
        return dataclasses.replace(
            cfg, workers=2,
            worker=dataclasses.replace(cfg.worker, unroll_length=4, batch_size=4),
            network=dataclasses.replace(cfg.network, actor_shape=(32,), critic_shape=(32,)))
    return tiny


def test_cli_evaluates_latest_checkpoint_on_cpu(tmp_path, monkeypatch):
    from pfpn_torch.envs import deepmimic
    from pfpn_torch.harness import build as build_mod, cli, eval as eval_mod, settings

    torch.set_num_threads(1)
    # TensorBoard stays out: importing it pulls in TensorFlow
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(settings, "build", _tiny(settings.build))
    # episodes of 0.09 s (3 steps): the 12 recorded frames run past done
    monkeypatch.setattr(build_mod, "make", functools.partial(deepmimic.make, overtime=0.09))
    steps = 12
    monkeypatch.setattr(eval_mod, "rollout_trajectory",
                        functools.partial(eval_mod.rollout_trajectory, max_steps=steps))
    argv = ["--env", "DeepMimicWalk-v0", "--setting", "deepmimic_dppo_pfpn",
            "--particles", "35", "--seed", "5", "--device", "cpu", "--root", str(tmp_path)]
    assert cli.main(argv) is None                      # no checkpoint yet
    algo, _ = cli.main(argv + ["--train", "--max_rounds", "1"])
    path, ret = cli.main(argv)
    cfg = settings.build("deepmimic_dppo_pfpn", particles=35, env="DeepMimicWalk-v0", seed=5)
    assert path == os.path.join(cfg.log_dir(str(tmp_path)), "trajectory.npz")
    with np.load(path) as z:
        assert sorted(z.files) == ["done", "link_names", "link_pos", "link_quat"]
        assert z["link_pos"].shape == (steps, 3, 15, 3)
        assert z["link_quat"].shape == (steps, 3, 15, 4)
        assert z["done"].shape == (steps, 3) and z["done"].dtype == bool
        assert list(z["link_names"]) == list(algo.env.tree.link_names)
        np.testing.assert_allclose(np.linalg.norm(z["link_quat"], axis=-1), 1.0, atol=1e-5)
        done = z["done"]
    assert not done[:2].any() and done[2:].all()       # done at the third step, then kept
    # evaluate from the same start states and the trained parameters stops at
    # the third step; the recorded returns add nothing after done
    out = algo.evaluate(num_episodes=3, max_steps=steps,
                        generator=torch.Generator().manual_seed(cfg.seed))
    np.testing.assert_array_equal(out["frames"].numpy(), [3, 3, 3])
    np.testing.assert_allclose(ret, out["reward"].numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("setting,env_name", [("deepmimic_dppo_pfpn", "DeepMimicWalk-v0"),
                                              ("deepmimic_dppo_dis", "DeepMimicMultiTask-v0")],
                         ids=["pfpn_walk", "dis_multitask"])
def test_exported_checkpoint_acts_alike_in_jax(tmp_path, monkeypatch, setting, env_name):
    import jax.numpy as jnp

    from pfpn_torch.harness.build import build_algo
    from pfpn_torch.harness.checkpoint import CheckpointManager
    from pfpn_torch.harness.settings import build
    from pfpn_torch.tools import export_policy
    from pfpn_torch.tools.export_policy import export
    from pfpn_tpu.harness.settings import build as j_build

    torch.set_num_threads(1)
    cfg = build(setting, particles=35, env=env_name, seed=3)
    algo = build_algo(cfg, "cpu")
    state = algo.init_state(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in algo.net.parameters():       # fp16 values: the export is exact
            p.add_(0.02 * torch.randn(p.shape, generator=g))
            p.copy_(p.half().float())
        obs_dim = algo.env.observation_size
        algo.net.norm.mean.copy_(torch.randn(obs_dim, generator=g))
        algo.net.norm.std.copy_(torch.rand(obs_dim, generator=g) + 0.5)
    CheckpointManager(cfg.checkpoint_dir(str(tmp_path))).save(7, state)
    monkeypatch.chdir(tmp_path)
    path = export(env_name, setting, particles=35, seed=3, root=str(tmp_path), device="cpu")
    assert path == f"results/policies/{env_name}_{setting}_particle35_3_step7.npz"
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    assert all(v.dtype == np.float16 for k, v in data.items() if k.startswith("params/"))

    # the JAX package's network of the same preset, as tools/export_policy.py
    # --play loads the npz
    env_like = type("Env", (), {"observation_size": obs_dim, "action_size": 36,
                                "action_low": -np.ones(36, np.float32),
                                "action_high": np.ones(36, np.float32)})()
    net_j = importlib.import_module("pfpn_tpu.harness.build").build_net(
        j_build(setting, particles=35, env=env_name, seed=3), env_like)
    params = _export_tool().unflatten({k[len("params/"):]: jnp.asarray(v, jnp.float32)
                                       for k, v in data.items() if k.startswith("params/")})
    norm = net_j.init_norm()._replace(**{k[len("norm/"):]: jnp.asarray(v, jnp.float32)
                                         for k, v in data.items() if k.startswith("norm/")})
    obs = np.asarray(algo.net.norm.mean) + np.random.default_rng(5).standard_normal(
        (32, obs_dim)).astype(np.float32)
    want = np.asarray(net_j.act_deterministic(params, norm, jnp.asarray(obs, jnp.float32)))
    with torch.no_grad():
        got = algo.net.act_deterministic(torch.tensor(obs, dtype=torch.float32)).numpy()
    err = float(np.abs(got.astype(np.float64) - want).max())
    print(f"\n{setting} on {env_name}: exported policy, JAX vs port deterministic action {err:.2e}")
    assert got.shape == want.shape == (32, 36)
    assert err <= 1e-5

    # --play with --record, shrunk: two episodes of four steps
    rec = str(tmp_path / "rec.npz")
    out = export_policy.main(["--play", path, "--env", env_name, "--setting", setting,
                              "--particles", "35", "--seed", "3", "--episodes", "2",
                              "--max_steps", "4", "--record", rec, "--device", "cpu"])
    assert out["reward"].shape == (2,)
    with np.load(rec) as z:
        assert z["link_pos"].shape == (4, 2, 15, 3) and z["link_quat"].shape == (4, 2, 15, 4)
        assert z["done"].shape == (4, 2) and len(z["link_names"]) == 15


def test_cli_sac_trains_resumes_evaluates_and_exports_on_cpu(tmp_path, monkeypatch):
    import jax.numpy as jnp

    from pfpn_torch.algos.sac import SACConfig
    from pfpn_torch.harness import build as build_mod, cli, eval as eval_mod, settings
    from pfpn_torch.harness.checkpoint import CheckpointManager
    from pfpn_torch.tools import export_policy
    from pfpn_tpu.harness.build import build_net as j_build_net
    from pfpn_tpu.harness.settings import build as j_build

    torch.set_num_threads(1)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    build0 = settings.build

    def tiny(*args, **kwargs):
        cfg = build0(*args, **kwargs)
        return dataclasses.replace(
            cfg, worker=dataclasses.replace(cfg.worker, batch_size=8, buffer_capacity=10),
            network=dataclasses.replace(cfg.network, actor_shape=(32,), critic_shape=(32,)))

    monkeypatch.setattr(settings, "build", tiny)
    monkeypatch.setattr(export_policy, "build", tiny)
    monkeypatch.setattr(build_mod, "SACConfig", functools.partial(SACConfig, steps_per_round=6))
    monkeypatch.setenv("PFPN_MEGASTEP_LINKS", "1")
    argv = ["--env", "DeepMimicWalk-v0", "--setting", "deepmimic_sac_pfpn", "--particles", "8",
            "--seed", "5", "--env_multiplier", "2", "--device", "cpu", "--root", str(tmp_path)]
    algo, state = cli.main(argv + ["--train", "--max_rounds", "1"])
    assert algo.cfg.updates_per_step == algo.cfg.num_envs == 2 and algo.cfg.batch_size == 8
    assert algo.net.cfg.head.squash and algo.env.engine.megastep_links
    assert (state.total_samples, state.global_step) == (12, 6)
    assert (state.buffer.size, state.buffer.pointer) == (10, 2)
    cfg = tiny("deepmimic_sac_pfpn", particles=8, env="DeepMimicWalk-v0", seed=5,
               env_multiplier=2)
    ckpt = CheckpointManager(cfg.checkpoint_dir(str(tmp_path)))
    assert ckpt.steps() == [6]
    saved = torch.load(ckpt.path(6), weights_only=True)
    assert "buffer" not in saved and {"net", "target", "opt", "ou_state"} <= set(saved)

    fresh = build_mod.build_algo(cfg, "cpu")
    st = ckpt.restore_latest(fresh.init_state(torch.Generator().manual_seed(99)))
    for a, b in ((algo.net, fresh.net), (algo.target, fresh.target)):
        for (k, v), (k2, v2) in zip(a.state_dict().items(), b.state_dict().items()):
            assert k == k2 and torch.equal(v, v2), k
    sd, sd2 = algo.opt.state_dict()["state"], fresh.opt.state_dict()["state"]
    assert len(algo.opt.adam.param_groups) == 3          # actor, critics, log_alpha
    assert sd.keys() == sd2.keys() and all(
        torch.equal(sd[i]["exp_avg_sq"], sd2[i]["exp_avg_sq"]) for i in sd)
    assert (st.global_step, st.total_samples, st.buffer.size) == (6, 12, 0)
    assert torch.equal(st.generator.get_state(), state.generator.get_state())

    # the second run resumes: an empty ring, so the same gate again
    algo, state = cli.main(argv + ["--train", "--max_rounds", "1"])
    assert (state.global_step, state.total_samples) == (12, 24) and ckpt.steps() == [12]

    # the CLI without --train evaluates the latest checkpoint
    steps = 4
    monkeypatch.setattr(eval_mod, "rollout_trajectory",
                        functools.partial(eval_mod.rollout_trajectory, max_steps=steps))
    path, ret = cli.main(argv)
    with np.load(path) as z:
        assert z["link_pos"].shape == (steps, 3, 15, 3) and z["done"].shape == (steps, 3)
    out = algo.evaluate(num_episodes=3, max_steps=steps,
                        generator=torch.Generator().manual_seed(cfg.seed))
    np.testing.assert_allclose(ret, out["reward"].numpy(), rtol=1e-6, atol=0)

    # the export, in the JAX package's SAC layout, acts in JAX as in the port
    monkeypatch.chdir(tmp_path)
    npz = export_policy.export("DeepMimicWalk-v0", "deepmimic_sac_pfpn", particles=8, seed=5,
                               root=str(tmp_path), env_multiplier=2, device="cpu")
    assert npz == "results/policies/DeepMimicWalk-v0_deepmimic_sac_pfpn_particle8_5_step12.npz"
    with np.load(npz) as z:
        data = {k: z[k] for k in z.files}
    tops = {k.split("/")[1] for k in data if k.startswith("params/")}
    assert tops == {"actor_trunk", "head", "q1", "q2", "log_alpha"}
    assert data["params/log_alpha"].shape == () and "norm/count" in data
    assert all(v.dtype == np.float16 for k, v in data.items() if k.startswith("params/"))
    jcfg = j_build("deepmimic_sac_pfpn", particles=8, env="DeepMimicWalk-v0", seed=5)
    jcfg = dataclasses.replace(jcfg, network=dataclasses.replace(
        jcfg.network, actor_shape=(32,), critic_shape=(32,)))
    net_j = j_build_net(jcfg, algo.env)
    params = _export_tool().unflatten({k[len("params/"):]: jnp.asarray(v, jnp.float32)
                                       for k, v in data.items() if k.startswith("params/")})
    norm = net_j.init_norm()._replace(**{k[len("norm/"):]: jnp.asarray(v, jnp.float32)
                                         for k, v in data.items() if k.startswith("norm/")})
    obs = state.obs.numpy()[:1] + np.random.default_rng(5).standard_normal((16, 197)).astype(
        np.float32)
    want = np.asarray(net_j.act_deterministic(params, norm, jnp.asarray(obs)))
    with torch.no_grad():
        for p in algo.net.parameters():       # the npz's fp16 values
            p.copy_(p.half().float())
        got = algo.net.act_deterministic(torch.tensor(obs)).numpy()
    err = float(np.abs(got.astype(np.float64) - want).max())
    print(f"\nSAC export: JAX vs port deterministic action {err:.2e}")
    assert got.shape == want.shape == (16, 36) and err <= 1e-5
    out = export_policy.main(["--play", npz, "--env", "DeepMimicWalk-v0", "--setting",
                              "deepmimic_sac_pfpn", "--particles", "8", "--seed", "5",
                              "--episodes", "2", "--max_steps", "2", "--device", "cpu"])
    assert out["reward"].shape == (2,) and bool(torch.isfinite(out["reward"]).all())


if __name__ == "__main__":
    import argparse
    import time

    sys.path.insert(0, ROOT)

    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, nargs="+", default=[0])
    ap.add_argument("--setting", default="deepmimic_dppo_pfpn", choices=list(POLICIES))
    ap.add_argument("--env", nargs="+", default=None)
    args = ap.parse_args()
    policies = POLICIES[args.setting]
    for env_name in args.env or list(policies):
        for key in args.keys:
            t0 = time.time()
            init, ret, frames = jax_play(env_name, os.path.join(ROOT, "results", "policies",
                                                                policies[env_name]), key,
                                         setting=args.setting)
            print(f"{env_name} PRNGKey({key}): init_time {init.tolist()}", flush=True)
            print(f"{env_name} PRNGKey({key}): return {ret.tolist()} frames {frames.tolist()} "
                  f"mean {ret.mean():.4f} ({time.time() - t0:.0f} s)", flush=True)
