"""Data-parallel training (``pfpn_torch/distributed/mesh.py``) on the CPU.

Two gloo ranks, subprocesses of this file, each run one DPPO round and one
SAC round through the CLI at tiny widths (4 DPPO envs x 4 steps in 2
minibatches of 8; 2 SAC envs x 4 steps, batch 8). Each round must be the
one-process round from the same seed, which the test runs in its own
process meanwhile: parameters and Adam state within 1e-6 (the observation
normalizer is part of the parameters' state dict), ``global_step``,
``total_samples`` and the logged metrics within 1e-6 as well. Rank 1's
parameters and Adam state must equal rank 0's exactly: the split DPPO
update sums the gradients and the replicated SAC steps average them, so
the replicas stay equal by construction. The world-2 DPPO checkpoint then
restores into a one-process state. The ranks get a
free port and a hard timeout, so a stuck rendezvous fails the test instead
of hanging it.

The one-process rounds step and reset their envs in the two ranks' slices.
The CPU's PyTorch is not batch-invariant: a product such as
``(B k, 3) @ (3, 3)`` in the forward kinematics rounds a row differently
at another ``B`` (MKL picks its kernel by the size), and the 20 contact
substeps of an env step grow such an ulp to ~1e-5. Stepped in one batch of
4, the one-process DPPO round's normalizer ends ~4e-5 from the world-2
round's. On the card the megastep computes each env in its own thread
block, whatever the batch.

    python tests/test_torch_distributed.py --root DIR --out PREFIX \\
        --world 2 --rank R --port P

runs one rank by hand; it writes its results to ``PREFIX.rank<R>.pt``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60          # seconds for both ranks' rounds
TOL = 1e-6
SETTINGS = ("deepmimic_dppo_pfpn", "deepmimic_sac_pfpn")
DIST_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _tiny_build(build0, *args, **kwargs):
    """The preset at tiny widths: 4 DPPO envs x 4 steps in 2 minibatches of
    8, or SAC with a batch of 8 and a ring of 10."""
    cfg = build0(*args, **kwargs)
    net = dataclasses.replace(cfg.network, actor_shape=(32,), critic_shape=(32,))
    if cfg.algo in ("sac", "ddpg"):
        worker = dataclasses.replace(cfg.worker, batch_size=8, buffer_capacity=10)
        return dataclasses.replace(cfg, worker=worker, network=net)
    worker = dataclasses.replace(cfg.worker, unroll_length=4, batch_size=2)
    return dataclasses.replace(cfg, workers=4, worker=worker, network=net)


def _rounds(root):
    """One CLI training round of each setting on the CPU. Returns what this
    process (the lead rank, or the only process) ended each with."""
    from pfpn_torch.algos.sac import SACConfig
    from pfpn_torch.harness import build as build_mod, cli, settings

    build0, sac0 = settings.build, build_mod.SACConfig
    settings.build = functools.partial(_tiny_build, build0)
    build_mod.SACConfig = functools.partial(SACConfig, steps_per_round=4)
    out = {}
    try:
        for setting in SETTINGS:
            mult = "2" if "sac" in setting else "1"
            algo, state = cli.main([
                "--env", "DeepMimicWalk-v0", "--setting", setting, "--particles", "8",
                "--seed", "5", "--device", "cpu", "--root", str(root), "--train",
                "--max_rounds", "1", "--env_multiplier", mult])
            cfg = settings.build(setting, particles=8, env="DeepMimicWalk-v0", seed=5,
                                 env_multiplier=int(mult))
            log = os.path.join(cfg.log_dir(str(root)), "metrics.jsonl")
            metrics = []
            if os.path.exists(log):
                with open(log) as f:
                    metrics = [m for m in map(json.loads, f) if "train/loss" in m]
            opt = algo.opt.state_dict()["state"]
            out[setting] = {
                "net": algo.net.state_dict(),
                "adam": {f"{i}.{k}": v for i, s in opt.items() for k, v in s.items()},
                "counters": (state.global_step, state.total_samples),
                "obs": state.obs, "metrics": metrics,
                "ckpt": cfg.checkpoint_dir(str(root))}
    finally:
        settings.build, build_mod.SACConfig = build0, sac0
    return out


def _rank_main(args) -> None:
    """One rank of a world-``args.world`` run; it writes its results."""
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None     # keeps TensorFlow out
    os.environ.update(PFPN_MEGASTEP_LINKS="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(args.port), WORLD_SIZE=str(args.world),
                      RANK=str(args.rank), LOCAL_RANK="0")
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    from pfpn_torch.distributed import mesh

    assert mesh.init_distributed("cpu") and dist.get_backend() == "gloo"
    try:
        out = _rounds(args.root)
        # the per-round replica check raises where the ranks hold different values
        probe = mesh.DataMesh(rank=args.rank, world=args.world)
        try:
            probe.check_replicated([torch.full((3,), float(args.rank))], "probe")
            out["mismatch_caught"] = False
        except RuntimeError:
            out["mismatch_caught"] = True
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{args.out}.rank{args.rank}.pt")


def _step_in_slices(monkeypatch, n: int) -> None:
    """Step and reset the one-process run's envs in ``n`` slices, the
    batches each rank of a world-``n`` run steps."""
    from pfpn_torch.envs.deepmimic import DeepMimicEnv, StepResult
    from pfpn_torch.sim.types import tree_map

    step0, reset0 = DeepMimicEnv.step_batch, DeepMimicEnv.reset_at

    def cat(parts):
        if isinstance(parts[0], torch.Tensor):
            return torch.cat(parts, 0)
        return tree_map(lambda *xs: torch.cat(xs, 0), *parts)

    def step_batch(self, states, actions):
        k = actions.shape[0] // n
        parts = [step0(self, tree_map(lambda x: x[i * k:(i + 1) * k], states),
                       actions[i * k:(i + 1) * k]) for i in range(n)]
        return StepResult(*[cat([getattr(p, f) for p in parts]) for f in StepResult._fields])

    def reset_at(self, init_time):
        k = init_time.shape[0] // n
        parts = [reset0(self, init_time[i * k:(i + 1) * k]) for i in range(n)]
        return cat([p[0] for p in parts]), cat([p[1] for p in parts])

    monkeypatch.setattr(DeepMimicEnv, "step_batch", step_batch)
    monkeypatch.setattr(DeepMimicEnv, "reset_at", reset_at)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _max_err(a, b, group):
    assert a[group].keys() == b[group].keys()
    return max(float((a[group][k].double() - b[group][k].double()).abs().max())
               for k in a[group] if a[group][k].numel())


def _assert_same_round(setting, a, b):
    assert a["counters"] == b["counters"], setting
    for group in ("net", "adam"):
        err = _max_err(a, b, group)
        print(f"{setting} {group}: max |world 2 - world 1| = {err:.3g}")
        assert err <= TOL, (setting, group)
    (ma,), (mb,) = a["metrics"], b["metrics"]
    assert ma.keys() == mb.keys()
    for k in ma:
        if k not in ("time", "train/sps"):
            np.testing.assert_allclose(ma[k], mb[k], rtol=TOL, atol=TOL,
                                       err_msg=f"{setting} {k}")


def test_rounds_on_two_gloo_ranks_are_the_one_process_rounds(tmp_path, monkeypatch):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in DIST_VARS}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--root", str(tmp_path / "w2"),
         "--out", str(tmp_path / "w2"), "--world", "2", "--rank", str(r),
         "--port", str(port)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    try:
        # the one-process rounds, in this process while the ranks run
        torch.set_num_threads(1)
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
        monkeypatch.setenv("PFPN_MEGASTEP_LINKS", "1")
        for v in DIST_VARS:
            monkeypatch.delenv(v, raising=False)
        _step_in_slices(monkeypatch, 2)
        w1 = _rounds(tmp_path / "w1")
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    w2, w2r1 = (torch.load(tmp_path / f"w2.rank{r}.pt", weights_only=True) for r in (0, 1))

    assert w1["deepmimic_dppo_pfpn"]["counters"] == (2, 16)
    assert w1["deepmimic_sac_pfpn"]["counters"][1] == 8
    assert w2["mismatch_caught"] and w2r1["mismatch_caught"]
    for setting in SETTINGS:
        _assert_same_round(setting, w2[setting], w1[setting])
        assert w2r1[setting]["counters"] == w2[setting]["counters"], setting
        for group in ("net", "adam"):      # the replicas, equal by construction
            assert _max_err(w2r1[setting], w2[setting], group) == 0.0, (setting, group)

    # the world-2 checkpoint holds the global per-env fields (rank 0's
    # slice first) and restores into a one-process run's state
    from pfpn_torch.harness import settings
    from pfpn_torch.harness.build import build_algo
    from pfpn_torch.harness.checkpoint import CheckpointManager

    cfg = _tiny_build(settings.build, "deepmimic_dppo_pfpn", particles=8,
                      env="DeepMimicWalk-v0", seed=5)
    algo = build_algo(cfg, "cpu")
    st = CheckpointManager(w2["deepmimic_dppo_pfpn"]["ckpt"]).restore_latest(
        algo.init_state(torch.Generator().manual_seed(0)))
    assert (st.global_step, st.total_samples) == (2, 16)
    assert st.env_state.sim.base_pos.shape[0] == st.ep_return.shape[0] == 4
    torch.testing.assert_close(st.obs, w1["deepmimic_dppo_pfpn"]["obs"], rtol=0, atol=TOL)


def test_sharding_is_by_field_name_and_init_needs_the_variables(monkeypatch):
    from pfpn_torch.distributed import mesh

    for v in DIST_VARS:
        monkeypatch.delenv(v, raising=False)
    assert mesh.init_distributed("cpu") is False
    assert mesh.current_mesh() is None

    @dataclasses.dataclass
    class State:
        trunk: torch.Tensor          # a parameter as wide as num_envs
        obs: torch.Tensor
        carry: tuple
        ou_state: torch.Tensor

    n = 4
    st = State(trunk=torch.arange(n * 3.0).reshape(n, 3),
               obs=torch.arange(n * 2.0).reshape(n, 2),
               carry=(torch.arange(n * 1.0), torch.arange(n * 1.0) + 10),
               ou_state=torch.zeros(n, 5))
    m = mesh.DataMesh(rank=1, world=2)
    sh = mesh.shard_state(st, m)
    assert torch.equal(sh.trunk, st.trunk)                # replicated
    assert torch.equal(sh.obs, st.obs[2:]) and sh.ou_state.shape == (2, 5)
    assert torch.equal(sh.carry[1], torch.tensor([12.0, 13.0]))
    with pytest.raises(ValueError, match="num_envs=6 .* world size 4"):
        mesh.check_divisible(6, 4)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    _rank_main(p.parse_args())
