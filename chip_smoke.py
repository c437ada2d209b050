#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``pfpn_torch``) on one card.

Phases, in order; any failure exits non-zero:

1. a CUDA card is required; prints its name and power limit;
2. builds the three kernels (``pfpn_torch/csrc/megastep.cu``,
   ``spd_inverse.cu``, ``substep_lin.cu``) with nvcc for sm_90a, one nvcc
   per source, all started together, and prints what ptxas reports
   (registers, shared memory, stack frame, spills) for the megastep's two
   instantiations, ``spd_inverse``'s warp kernel and ``substep_lin``'s
   two-warp kernel;
3. holds the megastep kernel against its plain PyTorch version on the card,
   from perturbed reset states: one substep (B=256), one control step
   (B=16, and B=1, the off-policy presets' one env, in both variants), and
   the share of envs past the bounds at B=1024; then one env step through
   the kernel against the plain path on the CPU;
4. the acting path: plays the shipped DPPO + PFPN-35 Walk policy for 10
   deterministic episodes through ``pfpn_torch.tools.export_policy.play``
   and checks that every env step launched the megastep's default variant
   and nothing else;
5. times both megastep variants at B=8 and B=8192 for 64, 128 and 256
   threads per block (one block per env), each as the median of five
   groups taken in turns, with their range; the plain version at B=8192;
   the env step rate with random actions and with the policy in the loop
   (CUDA events);
6. ``spd_inverse_pair`` against its plain version at B=1024, on H from
   perturbed and drop states; times it (16,384 matrices), ``spd_inverse``
   (8,192), the plain version and the library yardstick
   (``torch.linalg.cholesky_ex`` + ``torch.cholesky_inverse``) at B=8192,
   each as the median of five groups of calls, with their spread; prints
   the threads per matrix and the share of the bound;
7. ``substep_core`` against its plain version at B=256 on the inputs of
   ``tests/test_fused.py:100-118``; times both at B=8192 as phase 6 does,
   with the threads per env and the share of the bound;
8. ``Engine.substep``, kernel path against plain path on the card at B=256,
   in four modes: fused SPD with the megastep off, unfused SPD with
   ``return_torque``, torque and position control;
9. one control step at B=1024, ``Engine.control_step`` with the megastep off
   against the megastep kernel;
10. the megastep-off path: plays the shipped Walk npz for 600 steps with
   the env's engine built with ``EngineConfig(megastep=False)``, 20
   ``substep_lin`` launches and no megastep launch per env step; holds each
   episode's return at step 300 within 1% of phase 4's megastep play at
   the same step (same start states), and the mean return over the 600
   steps within 5% of the JAX package's 578.53. It runs in a second
   process (``chip_smoke.py --megastep-off-play``) beside phases 14-16
   and 18-25: all are paced by the host launching small kernels, the card
   idle most of the time, while the kernel timings run alone;
11. the ``spd_inverse`` paths at B=8192: ``step_log`` (20
   ``spd_inverse_pair`` launches per env step) and torque-control
   ``step_autoreset`` under random normalized torques (20 ``spd_inverse``
   launches per step);
12. the megastep's ``emit_links`` variant: one control step at B=1024 from
   perturbed reset states, its link rows against the plain
   ``link_states(fk(.))`` of its final state on the card, its state, flags
   and history bit-equal to the default variant's; one env step with
   ``PFPN_MEGASTEP_LINKS=1`` against one without (obs, reward, done); at
   the training batch, B=8, the variant against its plain version (state to
   phase 3's control-step bounds, flags exact, link rows as at B=1024); at
   B=8192 and B=8 both variants (in turns) and the plain epilogue timed as
   the median of five groups;
13. training: ``pfpn_torch.harness.cli.main([... "--train", "--max_rounds",
   "2"])`` on the ``deepmimic_dppo_pfpn`` preset with ``PFPN_MEGASTEP_LINKS=1``:
   2 x 512 launches of the links variant and no other kernel launch,
   ``global_step`` 32, ``total_samples`` 8192, finite losses, moved
   parameters, a checkpoint that restores the same parameters and Adam
   state; the round time split into rollout (of which the megastep) and
   update; a ``torch.profiler`` window over rollout steps at B=8 (the
   device's busy share, the kernels by device time); then one update from
   an identical state and trajectory on the card and on the CPU;
14. plays the shipped Punch, Kick and MultiTask npz for 10 deterministic
   episodes of 600 steps from the JAX package's own start phases (its CPU
   play from ``PRNGKey(0)``, ``TASK_PLAYS``) through ``reset_at``: each
   mean return within 5% of JAX's, 600 default-variant launches per
   single-motion play and 1,800 for MultiTask (one per task per step);
15. one training round through the CLI with ``PFPN_MEGASTEP_LINKS=1`` for
   ``deepmimic_dppo_gauss`` and ``deepmimic_dppo_dis`` on Walk and
   ``deepmimic_dppo_pfpn`` on MultiTask: finite losses, ``global_step``
   16, a checkpoint, 512 ``emit_links`` launches (1,536 for MultiTask) and
   no other;
16. ``python -m pfpn_torch`` without ``--train`` on phase 13's run: the
   trajectory npz in the JAX package's layout, its returns against
   ``PPO.evaluate``'s from the same start states (1e-4 relative), 600
   default-variant launches; then the checkpoint exported by
   ``pfpn_torch.tools.export_policy`` from a scratch working directory
   and played back against the checkpoint's play at the npz's fp16
   parameters (1e-4 relative);
17. MultiTask ``step_autoreset`` at B=8192, random actions in ±0.2, by
   CUDA events, beside Walk's of phase 5;
18. plays the shipped SAC + PFPN-35 Walk npz for 10 deterministic
   episodes of 600 steps from the JAX package's own start phases
   (``SAC_PLAY``) through ``export_policy.play``: the mean return within
   5% of JAX's CPU return, 600 default-variant launches and nothing else;
19. SAC training: ``cli.main([... "--setting", "deepmimic_sac_pfpn",
   "--env_multiplier", "16", "--max_rounds", "1", "--train"])`` with
   ``PFPN_MEGASTEP_LINKS=1`` (the shipped npz's run: 16 envs, 16 gradient
   steps per env step): 64 ``emit_links`` launches at B=16 and no other
   kernel, ``total_samples`` 1024, ``global_step`` 784, finite losses and
   alpha, online and target ``q1`` both moved and apart, the 1,000,000 x
   432 ring on the card, a checkpoint without the ring that restores the
   parameters, targets and Adam state; the round split into env steps and
   gradient steps (CUDA events); a ``torch.profiler`` window over 16
   gradient steps;
20. one round each of ``deepmimic_sac_gauss``, ``deepmimic_ddpg_pfpn`` and
   ``deepmimic_ddpg_gauss`` at ``--env_multiplier 8``: ``global_step`` 264,
   finite losses, a checkpoint, 64 ``emit_links`` launches and no other;
21. ``python -m pfpn_torch`` without ``--train`` on phase 19's checkpoint:
   its returns against ``SAC.evaluate``'s from the same start states (1e-4
   relative), 600 default-variant launches; then the checkpoint exported
   through ``export_policy`` and played back at the npz's fp16 parameters
   (1e-4 relative);
22. one round of each A3C and IMPALA preset through the CLI with
   ``PFPN_MEGASTEP_LINKS=1``: for A3C (A2C) 32 ``emit_links`` launches at
   B=16, ``global_step`` 1, ``total_samples`` 512; for IMPALA (V-trace) 64
   at B=32, ``global_step`` 8, ``total_samples`` 2,048; no other kernel;
   finite losses, every parameter moved, a checkpoint that restores the
   parameters, normalizer and Adam state; the round split into rollout and
   update;
23. the A2C and V-trace (PFPN-35) updates of phase 22's trajectory from
   the state after its round, each gradient step (A2C's one, V-trace's 8,
   one per group) on the card and, from the card's state before it, on the
   CPU: parameters within 1e-6, the normalizer within 1e-6 of max(1,
   |value|); V-trace's whole update (8 groups in one call) from that state
   on each device, within 2e-5 of the other device's and of its own chain
   of one-group calls, ``global_step`` +8 on both; the chained card-vs-CPU
   gap after each step, beside the CPU's chain from every parameter one
   ulp up (the rounding witness);
24. recurrent PPO: ``train(cfg)`` for one round of ``deepmimic_dppo_pfpn``
   with ``NetworkSettings(lstm=128)``: 512 ``emit_links`` launches at B=8
   and no other, ``global_step`` 8 (one 512-step stream a minibatch),
   ``total_samples`` 4,096, finite losses, moved parameters; on the card,
   ``sequence_outputs`` from the stored first carry reproduces the
   rollout's log-probs and values within 1e-4; the checkpoint restores the
   carry with the rest; ``RecurrentPPO.evaluate`` of 3 episodes launches
   only the default variant;
25. value normalization: one round of ``deepmimic_a3c_pfpn`` with
   ``normalize_value=True, clip_value=5.0``: the value normalizer moved,
   and the critic's raw outputs denormalize to the same values before and
   after its update (1e-5 relative); 32 ``emit_links`` launches at B=16.

26. ``EngineConfig.fast_dynamics`` (``sim/batched.py``): the batched FK, H
   and C against the recursion at B=8192 and B=1024 from perturbed states
   (body positions and ``v`` 1e-5, link velocities 1e-4, H 2e-3, C 2e-3
   of max(1, |C|) per env); ``Engine.substep`` with the flag and the
   megastep off against the recursion's at B=256 (2e-4 on positions,
   quaternions and ``q_rev``, 1e-3 on velocities, at most 1% of envs with
   a contact flag apart), one ``substep_lin`` launch; a torque-control
   step with the flag, 20 ``spd_inverse`` launches; ``Engine.substep`` at
   B=8192 and B=1024 with and without the flag, in turns (CUDA events);
27. the gym adapter (``envs/gym_adapter.py``): truncation at
   ``overtime=0.05``; the shipped Walk npz played through ``GymEnv`` for
   100 steps from t = 0.5 s against the batched play from the same start
   (return within 1e-4 relative), one default-variant launch per step and
   nothing else;
28. data-parallel training (``distributed/mesh.py``): one CLI round of
   ``deepmimic_dppo_pfpn`` in a process group of one rank over NCCL (512
   ``emit_links`` launches and no other, ``global_step`` 16,
   ``total_samples`` 4,096, parameters within 1e-6 of the same round
   without a process group), and an all-reduce of the gradients' size in
   that group of one (no traffic between cards); where gloo takes CUDA
   tensors, two gloo ranks on cuda:0 (second and third processes): the
   DPPO round at 4 envs each against the round without a group within
   1e-5, the gradient all-reduce timed between the two processes, and an
   IMPALA round at 16 envs each (replicated V-trace steps); rank 1's
   parameters equal to rank 0's after both rounds;
29. ``utils/profiling.py``: ``trace`` around one rollout step at B=8 writes
   a Chrome trace that holds the ``annotate`` region and the megastep
   kernel.

Phases run in the order 1-9, 11-13, 26, then 10 (second process) beside
14, 18, 15, 19, 20, 22-25, 16, 21 and 27-29, then 17.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

NPZ = "results/policies/DeepMimicWalk-v0_deepmimic_dppo_pfpn_particle35_34114_step58608.npz"
PLAY_OFF_STEPS = 600   # phase 10: the whole play; launch-bound, 0.6-0.9 s per step
PLAY_CHECK_STEP = 300  # phase 10: the step at which both plays' returns are compared
JAX_PLAY_RETURN = 578.53   # tools/export_policy.py --play, JAX on the CPU (PERF.md)
# phase 14: the JAX package's own deterministic play of each shipped npz from
# PRNGKey(0) split 10 ways (tools/export_policy.py --play), JAX on the CPU:
# each episode's start time and return, and the mean from PRNGKey(1) (JAX's
# spread over start states), printed by
#   JAX_PLATFORMS=cpu python tests/test_torch_eval.py --keys 0 1
TASK_PLAYS = {
    "DeepMimicPunch-v0": {
        "npz": ("results/policies/DeepMimicPunch-v0_deepmimic_dppo_pfpn_particle35_34114"
                "_step58608.npz"),
        "init_time": [1.7969350814819336, 0.015560135245323181, 1.925223708152771,
                      0.5695769786834717, 0.3277955949306488, 1.5745272636413574,
                      1.8723961114883423, 1.0134310722351074, 0.552929162979126,
                      1.1279739141464233],
        "jax_return": [538.1904296875, 527.925537109375, 538.9833374023438, 531.2174072265625,
                       538.6573486328125, 531.3416137695312, 530.8353881835938,
                       538.240966796875, 537.4513549804688, 537.3148193359375],
        "jax_return_mean_key1": 537.8265,
    },
    "DeepMimicKick-v0": {
        "npz": ("results/policies/DeepMimicKick-v0_deepmimic_dppo_pfpn_particle35_34114"
                "_step58608.npz"),
        "init_time": [1.2915470600128174, 0.011183847673237324, 1.3837546110153198,
                      0.40938347578048706, 0.23560309410095215, 1.1316914558410645,
                      1.3457846641540527, 0.7284035682678223, 0.3974178433418274,
                      0.8107312321662903],
        "jax_return": [494.5573425292969, 486.4681396484375, 489.6986999511719,
                       495.4397888183594, 479.3435974121094, 486.4698181152344,
                       492.2274169921875, 489.4569091796875, 491.1820373535156,
                       493.95355224609375],
        "jax_return_mean_key1": 444.5187,
    },
    "DeepMimicMultiTask-v0": {   # 4 Walk, 3 Punch, 3 Kick episodes
        "npz": ("results/policies/DeepMimicMultiTask-v0_deepmimic_dppo_pfpn_particle35_34114"
                "_step175792.npz"),
        "init_time": [1.0668885707855225, 0.009238469414412975, 1.1430569887161255,
                      0.33817312121391296, 0.3277955949306488, 1.5745272636413574,
                      1.8723961114883423, 0.7284035682678223, 0.3974178433418274,
                      0.8107312321662903],
        "jax_return": [584.1072387695312, 583.3591918945312, 583.8582763671875,
                       583.7221069335938, 549.2179565429688, 549.4478149414062,
                       546.4425048828125, 473.158935546875, 477.0616760253906,
                       481.340576171875],
        "jax_return_mean_key1": 541.1686,
    },
}
# phase 18: the JAX package's deterministic play of the shipped SAC + PFPN-35
# Walk npz from PRNGKey(0) split 10 ways, JAX on the CPU, printed by
#   JAX_PLATFORMS=cpu python tests/test_torch_eval.py --setting deepmimic_sac_pfpn --keys 0 1
SAC_PLAY = {
    "npz": ("results/policies/DeepMimicWalk-v0_deepmimic_sac_pfpn_particle35_34114"
            "_step11138592.npz"),
    "init_time": [1.0668885707855225, 0.009238469414412975, 1.1430569887161255,
                  0.33817312121391296, 0.1946210414171219, 0.9348390698432922,
                  1.1116917133331299, 0.6017012000083923, 0.32828885316848755,
                  0.6697083115577698],
    "jax_return": [580.3709106445312, 581.2010498046875, 581.3922729492188, 581.27392578125,
                   581.1026000976562, 580.7476806640625, 581.0772705078125, 580.3902587890625,
                   580.77734375, 580.9088745117188],
    "jax_return_mean_key1": 581.2579,
}
SAC_RING = (1_000_000, 432)   # the preset's ring: obs 197, next_obs 197, action 36, 2 scalars
SAC_PROFILE_STEPS = 16        # gradient steps in phase 19's profiler window
FP32_PEAK = 67e12      # H100 SXM fp32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12     # H100 SXM device memory, bytes/s
BIG_B = 8192
ASYNC_PRESETS = [f"deepmimic_{a}_{k}" for a in ("a3c", "impala") for k in ("pfpn", "gauss", "dis")]
THREADS = (64, 128, 256)   # the block sizes phase 5 times (one block per env)
PROFILE_STEPS = 16         # rollout steps in phase 13's profiler window


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, warm: int, reps: int) -> float:
    """Mean ms of fn() over reps calls, by CUDA events, after warm calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def cuda_ms_spread(fn, warm: int, reps: int, groups: int = 5):
    """(median, min, max) over ``groups`` of cuda_ms(fn, 0, reps), after
    warm calls."""
    times = sorted(cuda_ms(fn, warm if g == 0 else 0, reps) for g in range(groups))
    return times[len(times) // 2], times[0], times[-1]


def spread_text(t) -> str:
    return f"{t[0]:.3f} ms ({t[1]:.3f}-{t[2]:.3f})"


def in_turns(fns: dict, reps: int, groups: int = 5) -> dict:
    """{name: (median, min, max)} of ``groups`` groups of cuda_ms(fn, 0,
    reps) per function, the functions taken in turns within each group
    (each called once first)."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for _ in range(groups):
        for k, fn in fns.items():
            times[k].append(cuda_ms(fn, 0, reps))
    return {k: (sorted(v)[len(v) // 2], min(v), max(v)) for k, v in times.items()}


def ptxas_report(log: str) -> dict:
    """{kernel instantiation: {registers, smem_bytes, stack_bytes,
    spill_stores, spill_loads}} from nvcc's -Xptxas -v output."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[name]["smem_bytes"] = int(m.group(1))
    return out


def profile_summary(prof, steps: int) -> dict:
    """The device's busy share over a torch.profiler window (the union of
    the kernels' intervals over the span of every traced event), kernel
    launches per step, and the kernels by device time."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"device_time": False}
    busy, lo, hi = 0.0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            if hi is not None:
                busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    top = []
    for a in prof.key_averages():
        dev_us = getattr(a, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(a, "self_cuda_time_total", 0.0)
        if getattr(a, "device_type", None) == DeviceType.CUDA and dev_us > 0:
            top.append((dev_us, a.key, a.count))
    top.sort(reverse=True)
    return {"device_time": True, "window_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (t1 - t0), "kernels_per_step": len(spans) / steps,
            "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": n} for us, k, n in top[:8]]}


@contextlib.contextmanager
def megastep_links_on():
    """PFPN_MEGASTEP_LINKS=1, the JAX package's switch to the megastep's
    emit_links variant, while the block runs; engines read it when built."""
    old = os.environ.get("PFPN_MEGASTEP_LINKS")
    os.environ["PFPN_MEGASTEP_LINKS"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["PFPN_MEGASTEP_LINKS"]
        else:
            os.environ["PFPN_MEGASTEP_LINKS"] = old


class ReturnRecorder:
    """Wraps an env's ``step_batch`` and keeps each step's reward and done,
    so that ``PPO.evaluate``'s per-episode return can be read at any step."""

    def __init__(self, step_batch):
        self.step_batch, self.rewards, self.dones = step_batch, [], []

    def __call__(self, *args, **kwargs):
        res = self.step_batch(*args, **kwargs)
        self.rewards.append(res.reward.detach().cpu())
        self.dones.append(res.done.detach().cpu())
        return res

    def returns_at(self, steps: int):
        """Per-episode return after ``steps`` env steps, as evaluate adds
        rewards: a step counts while its episode was not done before it."""
        import torch

        ret = torch.zeros_like(self.rewards[0])
        done = torch.zeros_like(self.dones[0])
        for r, d in zip(self.rewards[:steps], self.dones[:steps]):
            ret = ret + torch.where(done, torch.zeros_like(r), r)
            done = done | d
        return ret


def megastep_off_play(rec_path: str, out_path: str):
    """Phase 10, run by ``main`` in a second process: the shipped Walk npz
    played for PLAY_OFF_STEPS steps with the env's engine built with
    ``EngineConfig(megastep=False)``; each episode's return at
    PLAY_CHECK_STEP against phase 4's megastep play from the same start
    states (its per-step rewards in ``rec_path``). Writes the numbers to
    ``out_path``; ``main`` checks them."""
    import torch

    import pfpn_torch
    from pfpn_torch.harness.build import build_algo
    from pfpn_torch.harness.settings import build
    from pfpn_torch.ops import linalg
    from pfpn_torch.ops import substep_lin as sl
    from pfpn_torch.sim.engine import Engine
    from pfpn_torch.tools.export_policy import load_policy, play

    dev = pfpn_torch.resolve_device("cuda")
    algo = build_algo(build("deepmimic_dppo_pfpn", particles=35), dev)
    load_policy(algo, NPZ)
    eng = algo.env.engine
    algo.env.engine = Engine(eng.tree, dataclasses.replace(eng.config, megastep=False),
                             eng.gains)
    rec_on = ReturnRecorder(None)
    saved = torch.load(rec_path)
    rec_on.rewards, rec_on.dones = saved["rewards"], saved["dones"]
    rec_off = ReturnRecorder(algo.env.step_batch)
    eng.mega.launches = eng.mega.launches_links = linalg.launches = sl.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    with mock.patch.object(algo.env, "step_batch", rec_off):
        res = play(NPZ, episodes=10, max_steps=PLAY_OFF_STEPS, seed=0, algo=algo)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {"megastep": eng.mega.launches, "megastep_emit_links": eng.mega.launches_links,
              "spd_inverse": linalg.launches, "substep_lin": sl.launches}
    rew = res["reward"].cpu()
    # both plays at PLAY_CHECK_STEP: the same start states (seed 0)
    on_mid, off_mid = rec_on.returns_at(PLAY_CHECK_STEP), rec_off.returns_at(PLAY_CHECK_STEP)
    gap = (off_mid - on_mid).abs()
    with open(out_path, "w") as fh:
        json.dump({"return_mean": float(rew.mean()), "return_min": float(rew.min()),
                   "return_max": float(rew.max()), "finite": bool(torch.isfinite(rew).all()),
                   "env_steps": int(res["frames"].max()), "launches": counts, "wall_s": wall,
                   "mid_off": float(off_mid.mean()), "mid_on": float(on_mid.mean()),
                   "mid_gap": float(gap.max()), "mid_rel": float((gap / on_mid.abs()).max())},
                  fh)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


DP_ARGV = ["--env", "DeepMimicWalk-v0", "--setting", "deepmimic_dppo_pfpn",
           "--particles", "35", "--seed", "34114", "--train", "--max_rounds", "1"]
DP_IMPALA_ARGV = ["--env", "DeepMimicWalk-v0", "--setting", "deepmimic_impala_pfpn",
                  "--particles", "35", "--seed", "34114", "--train", "--max_rounds", "1"]
DP_ALLREDUCE_REPS = 16   # phase 28: a round's minibatches


def phase_fast_dynamics(dev, card, env, perturbed_sim, identity_targets, reset_counts,
                        counts, in_turns_fn):
    """Phase 26: ``EngineConfig.fast_dynamics`` on the card. Returns its
    readings."""
    import torch

    from pfpn_torch.envs.deepmimic import make
    from pfpn_torch.math import quaternion as quat
    from pfpn_torch.sim import batched
    from pfpn_torch.sim.dynamics import crba, fk, pack_velocity, rnea
    from pfpn_torch.sim.engine import Engine
    from pfpn_torch.sim.types import zero_state

    t_phase = time.time()
    eng, tree = env.engine, env.tree
    S, NR = tree.n_sph, tree.n_rev
    pos = ("base_pos", "base_quat", "q_sph", "q_rev")
    vel = ("base_lin", "base_ang", "w_sph", "w_rev")
    out = {}

    # compute against the recursion at B=8192 and B=1024, tests/test_batched.py's states
    g = torch.Generator(device=dev).manual_seed(26)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    tb = batched.build_tables(tree)
    tol = {"body_pos": 1e-5, "v": 1e-5, "link_v": 1e-4, "H": 2e-3, "C_rel": 2e-3}
    for B in (BIG_B, 1024):
        sim = zero_state(tree, B, device=dev).replace(
            base_pos=torch.tensor([3.0, 1.2, -2.0], device=dev).expand(B, 3).clone(),
            base_quat=quat.quat_normalize(randn(B, 4)), base_lin=0.5 * randn(B, 3),
            base_ang=0.5 * randn(B, 3), q_sph=quat.quat_normalize(randn(B, S, 4)),
            w_sph=0.5 * randn(B, S, 3),
            q_rev=torch.tensor([-1.0, 0.5, -1.0, 0.5], device=dev).expand(B, NR).clone(),
            w_rev=0.5 * randn(B, NR))
        bd = batched.compute(tree, tb, sim, eng.config.gravity)
        fkr = fk(tree, sim)
        c_rec = rnea(tree, fkr, gravity=eng.config.gravity)
        err = {"body_pos": float((bd.fkr.body_pos - fkr.body_pos).abs().max()),
               "v": float((bd.v - pack_velocity(tree, sim, fkr)).abs().max()),
               "link_v": float((bd.fkr.v - fkr.v).abs().max()),
               "H": float((bd.h - crba(tree, fkr)).abs().max()),
               "C_rel": float(((bd.c - c_rec).abs().amax(1)
                               / c_rec.abs().amax(1).clamp(min=1.0)).max())}
        out[f"compute_vs_recursion_B{B}"] = err
        print(f"fast_dynamics: batched compute against the recursion, B={B}: "
              f"{json.dumps(err)}")
        for k, t in tol.items():
            check(err[k] <= t, f"fast_dynamics compute, B={B}: {k} error {err[k]:.3g} > {t:g}")
        del bd, fkr, c_rec, sim

    # one fused substep with the megastep off, with and without the flag
    e_fast = Engine(tree, dataclasses.replace(eng.config, megastep=False, fast_dynamics=True),
                    eng.gains)
    e_rec = Engine(tree, dataclasses.replace(eng.config, megastep=False), eng.gains)
    sim = perturbed_sim(256, 27)
    axis = torch.nn.functional.normalize(randn(256, S, 3), dim=-1)
    half = 0.25 * (torch.rand(256, S, 1, generator=g, device=dev) - 0.5)
    ts = torch.cat([axis * torch.sin(half), torch.cos(half)], -1)
    tr = torch.rand(256, NR, generator=g, device=dev) - 0.5
    reset_counts()
    got = e_fast.substep(sim, ts, tr)
    n_sub = counts()
    want = e_rec.substep(sim, ts, tr)
    torch.cuda.synchronize()
    check(n_sub == {"megastep": 0, "megastep_emit_links": 0, "spd_inverse": 0,
                    "substep_lin": 1},
          f"fast_dynamics Engine.substep: launches {n_sub}, want one substep_lin")
    err = {k: float((getattr(got[0], k) - getattr(want[0], k)).abs().max()) for k in pos + vel}
    err["flag_envs"] = float((got[1] != want[1]).any(1).float().mean())
    out["substep_vs_recursion_B256"] = err
    print(f"fast_dynamics: Engine.substep, megastep off, B=256, against the recursion's: "
          f"{json.dumps(err)}; launches {n_sub}")
    for k, v in err.items():
        t = 2e-4 if k in pos else 1e-3 if k in vel else 0.01
        check(v <= t, f"fast_dynamics Engine.substep: {k} {v:.3g} > {t:g}")

    # torque control with the flag: spd_inverse once a substep
    env_tq = make("DeepMimicWalk-v0", device=dev, control_mode="torque")
    env_tq.engine = Engine(tree, dataclasses.replace(env_tq.engine.config, fast_dynamics=True),
                           env_tq.engine.gains)
    st, _ = env_tq.reset_batch(256, g)
    a = torch.rand(256, env_tq.action_size, generator=g, device=dev) * 0.4 - 0.2
    reset_counts()
    res = env_tq.step(st, a)
    n_tq = counts()
    check(n_tq == {"megastep": 0, "megastep_emit_links": 0,
                   "spd_inverse": eng.config.frame_skip, "substep_lin": 0},
          f"fast_dynamics torque step: launches {n_tq}")
    check(bool(torch.isfinite(res.obs).all()), "fast_dynamics torque step: not finite")
    out["launches"] = {"substep": n_sub, "torque_step": n_tq}

    # Engine.substep at B=8192 and B=1024, both ways, in turns (CUDA events)
    for B in (BIG_B, 1024):
        sim = perturbed_sim(B, 16)
        ts, tr = identity_targets(B)
        t = in_turns_fn({"fast_dynamics": lambda: e_fast.substep(sim, ts, tr),
                         "recursion": lambda: e_rec.substep(sim, ts, tr),
                         "fast_dynamics_dynamics": lambda: e_fast._dynamics(sim),
                         "recursion_dynamics": lambda: e_rec._dynamics(sim)},
                        reps=3, groups=3)
        out[f"substep_ms_B{B}"] = t
        print(f"fast_dynamics: megastep-off Engine.substep B={B} [{card}]: "
              f"{spread_text(t['fast_dynamics'])} with the flag, "
              f"{spread_text(t['recursion'])} without; of which the dynamics "
              f"{spread_text(t['fast_dynamics_dynamics'])} and "
              f"{spread_text(t['recursion_dynamics'])} (in turns)")
    out["s"] = time.time() - t_phase
    print(f"fast_dynamics: phase 26 in {out['s']:.1f} s")
    return out


def phase_gym(dev, card, path_counts, zero_counts):
    """Phase 27: the gym adapter on the card. Returns its readings."""
    import numpy as np
    import torch

    from pfpn_torch.envs import GymEnv
    from pfpn_torch.envs.deepmimic import make
    from pfpn_torch.harness.build import build_algo
    from pfpn_torch.harness.settings import build
    from pfpn_torch.tools.export_policy import load_policy

    t_phase = time.time()
    genv = GymEnv(make("DeepMimicWalk-v0", device=dev, overtime=0.05,
                       random_init_pose=False), seed=3)
    genv.reset()
    done, info, n_trunc = False, {}, 0
    while not done and n_trunc < 5:
        _, _, done, info = genv.step(np.zeros(genv.action_size, np.float32))
        n_trunc += 1
    check(done and info["TimeLimit.truncated"] is True,
          f"GymEnv: no truncation at overtime=0.05 after {n_trunc} steps")

    algo = build_algo(build("deepmimic_dppo_pfpn", particles=35), dev)
    load_policy(algo, NPZ)
    genv = GymEnv(algo.env, seed=0)
    t0 = 0.5                        # seconds into the motion
    max_steps = 100
    zero_counts(algo.env)
    torch.cuda.synchronize()
    t_play = time.time()
    obs = genv.reset_at(t0)
    ret, n = 0.0, 0
    with torch.no_grad():
        while n < max_steps:
            a = algo._clip_action(algo.net.act_deterministic(
                torch.as_tensor(obs, device=dev)[None]))[0]
            obs, r, done, info = genv.step(a.cpu().numpy())
            ret += r
            n += 1
            if done:
                break
    play_s = time.time() - t_play
    gym_counts = path_counts(algo.env)
    zero_counts(algo.env)
    ref = algo.evaluate(num_episodes=1, max_steps=n,
                        init_time=torch.tensor([t0], device=dev))
    ref_ret = float(ref["reward"][0])
    rel = abs(ret - ref_ret) / max(abs(ref_ret), 1e-9)
    out = {"steps": n, "return": ret, "batched_return": ref_ret, "rel": rel,
           "launches": gym_counts, "ms_per_step": play_s * 1e3 / n,
           "host_copies_per_step": 2, "truncation_steps": n_trunc}
    print(f"GymEnv: the shipped Walk npz from t={t0} s for {n} steps [{card}]: return "
          f"{ret:.4f} against the batched play's {ref_ret:.4f} (rel {rel:.2e}); "
          f"{out['ms_per_step']:.2f} ms per step with two host copies a step (the action "
          f"in, one copy of obs, reward and flags out); launches {gym_counts}; truncated "
          f"at overtime=0.05 after {n_trunc} steps")
    check(rel <= 1e-4, f"GymEnv play: return {ret:.4f} vs {ref_ret:.4f}")
    check(gym_counts == {"megastep": n, "megastep_emit_links": 0, "spd_inverse": 0,
                         "substep_lin": 0}, f"GymEnv play: launches {gym_counts} for {n} steps")
    out["s"] = time.time() - t_phase
    return out


def dp_rank_main(rank: int, port: int, root: str, out_path: str):
    """Phase 28's gloo ranks on cuda:0, run by ``main`` in two processes:
    one round of the DPPO preset (the split update, gradients summed), the
    gradient all-reduce timed between the two processes, then one round of
    the IMPALA preset (replicated V-trace steps, gradients averaged), all
    through the CLI. Each rank writes its parameters and readings to
    ``out_path.rank<R>.pt`` (or why gloo refused CUDA tensors)."""
    import torch
    import torch.distributed as dist

    from pfpn_torch.distributed.mesh import init_distributed
    from pfpn_torch.harness import cli

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                      RANK=str(rank), LOCAL_RANK="0", PFPN_MEGASTEP_LINKS="1")
    init_distributed("cuda:0", backend="gloo")
    try:
        probe = torch.ones(4, device="cuda:0")
        dist.all_reduce(probe)
        parts = [torch.empty_like(probe) for _ in range(2)]
        dist.all_gather(parts, probe)
        gloo_cuda = {"all_reduce": True, "all_gather": True}
    except RuntimeError as exc:       # the backend's refusal, reported
        gloo_cuda = {"error": str(exc)[:300]}
    out = {"gloo_cuda": gloo_cuda}

    def one_round(argv, sub):
        t0 = time.time()
        algo, state = cli.main(argv + ["--root", os.path.join(root, sub),
                                       "--device", "cuda:0"])
        torch.cuda.synchronize()
        eng = algo.env.engine
        return algo, {"wall_s": time.time() - t0,
                      "counters": (state.global_step, state.total_samples),
                      "launches": {"megastep": eng.mega.launches,
                                   "megastep_emit_links": eng.mega.launches_links},
                      "net": {k: v.cpu() for k, v in algo.net.state_dict().items()}}

    try:
        if "error" not in gloo_cuda:
            algo, out["dppo"] = one_round(DP_ARGV, "dppo")
            # the all-reduce ClippedAdam.step runs once a minibatch, on a
            # buffer of every parameter's gradient, between the two processes
            grads = torch.cat([p.detach().reshape(-1) for p in algo.net.parameters()])
            for _ in range(3):
                dist.all_reduce(grads)
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(DP_ALLREDUCE_REPS):
                dist.all_reduce(grads)
            torch.cuda.synchronize()
            out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3 / DP_ALLREDUCE_REPS
            out["grad_elements"] = grads.numel()
            del algo, grads
            out["impala"] = one_round(DP_IMPALA_ARGV, "impala")[1]
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{out_path}.rank{rank}.pt")


def phase_data_parallel(dev, card, work_dir, counts, reset_counts, cuda_ms_fn):
    """Phase 28: data-parallel training through the CLI under a process
    group of one rank (NCCL), against a round without a process group, and
    two gloo ranks on cuda:0 against that round. Returns its readings."""
    import torch
    import torch.distributed as dist

    from pfpn_torch.distributed.mesh import init_distributed
    from pfpn_torch.harness import cli

    t_phase = time.time()
    port = free_port()
    gloo_out = os.path.join(work_dir, "dp_gloo_out")
    gloo_log = open(os.path.join(work_dir, "dp_gloo.log"), "w+")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r), str(port),
         os.path.join(work_dir, "dp_gloo"), gloo_out],
        stdout=gloo_log if r == 0 else subprocess.DEVNULL, stderr=subprocess.STDOUT)
        for r in (0, 1)]
    for p in procs:
        atexit.register(lambda p=p: p.poll() is None and p.kill())

    def one_round(root):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        with megastep_links_on():
            algo, state = cli.main(DP_ARGV + ["--root", os.path.join(work_dir, root)])
        torch.cuda.synchronize()
        eng = algo.env.engine
        n = counts()
        n.update(megastep=eng.mega.launches, megastep_emit_links=eng.mega.launches_links)
        return algo, state, n, time.time() - t0

    # the round without a process group
    algo_a, state_a, n_a, wall_a = one_round("dp_none")
    # the same round in a process group of one rank over NCCL
    env0 = {k: os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                                           "RANK", "LOCAL_RANK")}
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                      RANK="0", LOCAL_RANK="0")
    try:
        check(init_distributed(), "data parallel: no process group from the variables")
        backend = dist.get_backend()
        algo_b, state_b, n_b, wall_b = one_round("dp_nccl")
        # an all-reduce of a buffer of every parameter's gradient in this
        # group of one rank, outside the round (which calls none at world
        # size 1): NCCL's fixed cost on one card, no traffic between cards
        grads = torch.cat([p.detach().reshape(-1) for p in algo_b.net.parameters()])
        allreduce_ms = cuda_ms_fn(lambda: dist.all_reduce(grads), warm=3,
                                  reps=state_b.global_step)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    sa, sb = algo_a.net.state_dict(), algo_b.net.state_dict()
    err_b = max(float((sa[k] - sb[k]).abs().max()) for k in sa if sa[k].numel())
    out = {"backend": backend, "launches": n_b, "launches_no_group": n_a,
           "counters": (state_b.global_step, state_b.total_samples),
           "round_s": wall_b, "round_s_no_group": wall_a, "params_err_vs_no_group": err_b,
           "allreduce_ms_world1_self": allreduce_ms, "grad_elements": grads.numel()}
    print(f"data parallel: one round of deepmimic_dppo_pfpn through the CLI in a process "
          f"group of 1 rank ({backend}) [{card}]: {wall_b:.1f} s (without a group "
          f"{wall_a:.1f} s); launches {n_b}; global_step {state_b.global_step}, "
          f"total_samples {state_b.total_samples}; parameters against the round without a "
          f"group: max abs err {err_b:.3g}; an all-reduce of {grads.numel()} fp32 in the "
          f"group of one rank, outside the round (no traffic between cards) "
          f"{allreduce_ms:.4f} ms")
    check(n_b == {"megastep": 0, "megastep_emit_links": 512, "spd_inverse": 0,
                  "substep_lin": 0}, f"data parallel: launches {n_b}")
    check((state_b.global_step, state_b.total_samples) == (16, 4096),
          f"data parallel: global_step {state_b.global_step}, total_samples "
          f"{state_b.total_samples}")
    check(err_b <= 1e-6, f"data parallel: parameters {err_b:.3g} from the round without "
          f"a process group")

    # two gloo ranks on cuda:0: 4 DPPO envs each, then 16 IMPALA envs each
    rcs = [p.wait(timeout=900) for p in procs]
    gloo_log.seek(0)
    log = gloo_log.read()
    gloo_log.close()
    check(rcs == [0, 0], f"data parallel, gloo ranks: exit codes {rcs}\n{log[-3000:]}")
    g, g1 = (torch.load(f"{gloo_out}.rank{r}.pt") for r in (0, 1))
    out["gloo_cuda"] = g["gloo_cuda"]
    if "error" in g["gloo_cuda"]:
        print(f"data parallel: gloo refused CUDA tensors, so the two-rank run on cuda:0 did "
              f"not run: {g['gloo_cuda']['error']}")
    else:
        d = g["dppo"]
        err_g = max(float((sa[k].cpu() - d["net"][k]).abs().max()) for k in sa if sa[k].numel())
        # the replicas: rank 1 against rank 0, equal by construction
        rep = {run: max(float((g[run]["net"][k] - g1[run]["net"][k]).abs().max())
                        for k in g[run]["net"] if g[run]["net"][k].numel())
               for run in ("dppo", "impala")}
        imp = g["impala"]
        out.update(gloo_params_err_vs_no_group=err_g, gloo_round_s=d["wall_s"],
                   gloo_launches_rank0=d["launches"], gloo_counters=d["counters"],
                   gloo_allreduce_ms_two_ranks=g["allreduce_ms"],
                   gloo_rank1_vs_rank0=rep, gloo_impala_round_s=imp["wall_s"],
                   gloo_impala_counters=imp["counters"],
                   gloo_impala_launches_rank0=imp["launches"])
        print(f"data parallel: two gloo ranks on cuda:0, 4 envs each [{card}]: round "
              f"{d['wall_s']:.1f} s, rank 0 launches {d['launches']}, counters "
              f"{d['counters']}; parameters against the one-process round: max abs err "
              f"{err_g:.3g}; the all-reduce of the {g['grad_elements']} fp32 gradients "
              f"between the two processes (gloo, through host memory) "
              f"{g['allreduce_ms']:.3f} ms")
        print(f"data parallel: IMPALA on the two gloo ranks, 16 envs each [{card}]: round "
              f"{imp['wall_s']:.1f} s, rank 0 launches {imp['launches']}, counters "
              f"{imp['counters']}; rank 1's parameters against rank 0's: max abs diff "
              f"DPPO {rep['dppo']:.3g}, IMPALA {rep['impala']:.3g}")
        check(tuple(d["counters"]) == (16, 4096), f"gloo ranks: counters {d['counters']}")
        check(d["launches"] == {"megastep": 0, "megastep_emit_links": 512},
              f"gloo ranks: rank 0 launches {d['launches']}")
        check(err_g <= 1e-5, f"gloo ranks: parameters {err_g:.3g} from the one-process round")
        check(tuple(imp["counters"]) == (8, 2048) and tuple(g1["impala"]["counters"]) == (8, 2048),
              f"gloo ranks, IMPALA: counters {imp['counters']}, {g1['impala']['counters']}")
        check(imp["launches"] == {"megastep": 0, "megastep_emit_links": 64},
              f"gloo ranks, IMPALA: rank 0 launches {imp['launches']}")
        check(rep == {"dppo": 0.0, "impala": 0.0},
              f"gloo ranks: rank 1's parameters differ from rank 0's: {rep}")
    out["s"] = time.time() - t_phase
    return out


def phase_profiling(dev, card, work_dir):
    """Phase 29: ``trace`` around one rollout step of the DPPO preset (B=8,
    the emit_links variant) writes a Chrome trace with the ``annotate``
    region and the megastep kernel. Returns its readings."""
    import torch

    from pfpn_torch.algos.ppo import PPO
    from pfpn_torch.harness.build import build_algo
    from pfpn_torch.harness.settings import build
    from pfpn_torch.utils.profiling import annotate, trace

    cfg = build("deepmimic_dppo_pfpn", particles=35, seed=29)
    with megastep_links_on():
        algo = build_algo(cfg, dev)
    state = algo.init_state(torch.Generator(device=dev).manual_seed(29))
    one = PPO(algo.env, algo.net, dataclasses.replace(algo.cfg, unroll_length=1))
    state = one.rollout(state)[0]                 # warm-up
    torch.cuda.synchronize()
    logdir = os.path.join(work_dir, "trace")
    mega = algo.env.engine.mega
    mega.launches = mega.launches_links = 0
    with trace(logdir):
        with annotate("rollout_step"):
            one.rollout(state)
    with open(os.path.join(logdir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    names = [e.get("name", "") for e in events]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    out = {"events": len(events), "annotate_region": "rollout_step" in names,
           "kernel_events": len(kernels),
           "megastep_kernel": any("megastep" in k for k in kernels),
           "launches": {"megastep_emit_links": mega.launches_links, "megastep": mega.launches},
           "trace_bytes": os.path.getsize(os.path.join(logdir, "trace.json"))}
    print(f"profiling: trace() around one rollout step at B=8 [{card}]: {json.dumps(out)}")
    check(out["annotate_region"], "profiling: the trace holds no 'rollout_step' region")
    check(out["launches"] == {"megastep_emit_links": 1, "megastep": 0},
          f"profiling: launches {out['launches']}")
    check(out["megastep_kernel"], f"profiling: the trace's {len(kernels)} device kernels "
          f"hold no megastep")
    return out


def main():
    import torch

    run_t0 = time.time()

    # ---- 1. the card ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    import pfpn_torch
    from pfpn_torch.envs.deepmimic import make
    from pfpn_torch.harness.settings import build
    from pfpn_torch.ops import linalg
    from pfpn_torch.ops import megastep as ms
    from pfpn_torch.ops import substep_lin as sl
    from pfpn_torch.harness.build import build_algo
    from pfpn_torch.tools.export_policy import load_policy, play

    dev = pfpn_torch.resolve_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- 2. build ---------------------------------------------------------
    libraries = (ms.LIBRARY, linalg.LIBRARY, sl.LIBRARY)

    def timed_build(lib):
        t = time.time()
        path, log = lib.build()
        return path, log, time.time() - t

    t0 = time.time()
    with ThreadPoolExecutor(len(libraries)) as pool:
        built = list(pool.map(timed_build, libraries))
    print(f"build: {len(libraries)} kernels in {time.time() - t0:.1f} s")
    build_time = {}
    for lib, (path, log, secs) in zip(libraries, built):
        build_time[lib.name] = secs
        print(f"build: {path} in {secs:.1f} s")
        for line in log.splitlines():
            if ("ptxas" in line or "error" in line or "warning" in line
                    or "stack frame" in line):
                print(f"  {line.strip()}")
        lib.load()
    build_s = build_time["megastep"]
    # the megastep's two instantiations, megastep_kernel<false> (default)
    # and <true> (emit_links), as ptxas compiled them
    report = ptxas_report(built[0][1])
    ptxas = {variant: next((v for k, v in report.items() if f"megastep_kernelILb{flag}E" in k),
                           None)
             for variant, flag in (("default", 0), ("emit_links", 1))}
    mega_lib = ms.LIBRARY.load()
    default_threads = mega_lib.pfpn_megastep_default_threads()
    print(f"megastep ptxas, sm_90a: {json.dumps(ptxas)}; {default_threads} threads per "
          f"block by default")
    check(all(ptxas.values()) or not report,
          f"megastep: ptxas reported no instantiation of both variants: {sorted(report)}")
    # the redesigned kernels of the per-substep path, as ptxas compiled them
    ptxas_new = {}
    for (path, log, _), tag in ((built[1], "spd_inverse_warp_kernel"),
                                (built[2], "substep_lin_warps_kernel")):
        found = ptxas_report(log)
        ptxas_new[tag] = next((v for k, v in found.items() if tag in k), None)
        check(ptxas_new[tag] is not None or not found,
              f"{tag}: ptxas reported no such kernel: {sorted(found)}")
    print(f"spd_inverse and substep_lin ptxas, sm_90a: {json.dumps(ptxas_new)}")

    def reset_counts():
        for wrapper in counted:
            wrapper.launches = 0
        counted[0].launches_links = 0

    def counts():
        out = {name: wrapper.launches for name, wrapper in zip(
            ("megastep", "spd_inverse", "substep_lin"), counted)}
        out["megastep_emit_links"] = counted[0].launches_links
        return out

    def env_megasteps(env):
        """The megastep of each engine of an env: a wrapped env's, or each
        task's of the multi-task env."""
        base = getattr(env, "env", env)
        return [e.engine.mega for e in getattr(base, "envs", [base])]

    def zero_counts(env):
        """Every launch count of an env's path set to 0."""
        for m in env_megasteps(env):
            m.launches = m.launches_links = 0
        linalg.launches = sl.launches = 0

    def path_counts(env) -> dict:
        megas = env_megasteps(env)
        return {"megastep": sum(m.launches for m in megas),
                "megastep_emit_links": sum(m.launches_links for m in megas),
                "spd_inverse": linalg.launches, "substep_lin": sl.launches}

    # ---- 3. kernel vs plain -----------------------------------------------
    env = make("DeepMimicWalk-v0", device=dev)
    mega, meta = env.engine.mega, env.engine.meta
    S, NR = meta.n_sph, meta.n_rev
    groups = {   # name -> rows of the packed state
        "base_quat": slice(0, 4), "base_pos": slice(4, 7),
        "base_ang": slice(7, 10), "base_lin": slice(10, 13),
        "q_sph": slice(13, 13 + 4 * S), "w_sph": slice(13 + 4 * S, 13 + 7 * S),
        "q_rev": slice(13 + 7 * S, 13 + 7 * S + NR),
        "w_rev": slice(13 + 7 * S + NR, 13 + 7 * S + 2 * NR),
    }

    def perturbed(B: int, seed: int):
        """Reset states with velocities perturbed so contacts and limits
        engage (tests/test_megastep.py:108-118), and identity targets."""
        g = torch.Generator(device=dev).manual_seed(seed)
        state, _ = env.reset_batch(B, g)
        sim = state.sim
        sim = sim.replace(
            base_lin=sim.base_lin + torch.tensor([0.1, -0.4, 0.0], device=dev),
            w_sph=sim.w_sph + 0.3 * torch.randn(sim.w_sph.shape, generator=g, device=dev),
            w_rev=sim.w_rev + 0.3 * torch.randn(sim.w_rev.shape, generator=g, device=dev))
        st = ms.pack_state(meta, sim).contiguous()
        ts = torch.zeros(B, S, 4, device=dev)
        ts[..., 3] = 1.0
        return st, ts.reshape(B, -1), torch.zeros(B, NR, device=dev)

    def errors(got, want):
        """Per-env max abs error of each state group, the history, and
        per-env flag mismatches."""
        e = {k: (got[0][:, sl] - want[0][:, sl]).abs().amax(1) for k, sl in groups.items()}
        e["hist"] = (got[2] - want[2]).abs().amax((1, 2))
        e["flags"] = (got[1] != want[1]).sum(1).float()
        return e

    def summary(e):
        return {k: float(v.max()) for k, v in e.items()}

    max_err = {}
    # one substep, B=256: 1e-5 on positions, quaternions and q_rev, 1e-4 on
    # velocities, exact contact flags
    st, ts, tr = perturbed(256, 1)
    got = mega.kernel(st, ts, tr, substeps=1)
    want = mega.plain(st, ts, tr, substeps=1)
    torch.cuda.synchronize()
    e1 = summary(errors(got, want))
    max_err["substep_B256"] = e1
    print("one substep, B=256, max abs err:", json.dumps(e1))
    tol1 = {"base_quat": 1e-5, "base_pos": 1e-5, "q_sph": 1e-5, "q_rev": 1e-5,
            "hist": 1e-5, "base_ang": 1e-4, "base_lin": 1e-4, "w_sph": 1e-4,
            "w_rev": 1e-4, "flags": 0.0}
    for k, tol in tol1.items():
        check(e1[k] <= tol, f"one substep: {k} error {e1[k]:.3g} > {tol:g}")

    # one control step (20 substeps), B=16: the bounds of
    # tests/test_megastep.py:139-152
    tol20 = {"base_pos": 2e-4, "base_quat": 2e-4, "q_sph": 2e-4, "q_rev": 2e-4,
             "hist": 2e-4, "w_sph": 5e-3, "flags": 0.0}
    st, ts, tr = perturbed(16, 2)
    got = mega.kernel(st, ts, tr)
    want = mega.plain(st, ts, tr)
    torch.cuda.synchronize()
    e20 = summary(errors(got, want))
    max_err["control_step_B16"] = e20
    print("control step, B=16, max abs err:", json.dumps(e20))
    check(bool(want[1].any()), "control step: no contact engaged")
    for k, tol in tol20.items():
        check(e20[k] <= tol, f"control step: {k} error {e20[k]:.3g} > {tol:g}")

    # one control step at B=1, the off-policy presets' one env (a single
    # block): both variants against their plain version at the same bounds
    st, ts, tr = perturbed(1, 22)
    for links in (False, True):
        variant = "emit_links" if links else "default"
        got = mega.kernel(st, ts, tr, links=links)
        want = mega.plain(st, ts, tr, links=links)
        torch.cuda.synchronize()
        e_b1 = summary(errors(got, want))
        max_err[f"control_step_B1_{variant}"] = e_b1
        print(f"control step, B=1, {variant}, max abs err ({int(want[1].sum())} contacts "
              f"active): {json.dumps(e_b1)}")
        for k, tol in tol20.items():
            check(e_b1[k] <= tol, f"control step B=1 {variant}: {k} error {e_b1[k]:.3g} > "
                                  f"{tol:g}")

    # one control step, B=1024: chaos over 20 contact-rich substeps may flip
    # a knife-edge contact (tests/test_megastep.py:183-192); at most 2% of
    # the envs may leave the bounds, none may be NaN
    st, ts, tr = perturbed(1024, 3)
    got = mega.kernel(st, ts, tr)
    want = mega.plain(st, ts, tr)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got[0]).all() and torch.isfinite(got[2]).all()),
          "control step B=1024: kernel output not finite")
    check(bool(torch.isfinite(want[0]).all()), "control step B=1024: plain output not finite")
    e = errors(got, want)
    out = torch.zeros(1024, dtype=torch.bool, device=dev)
    for k, tol in tol20.items():
        out |= e[k] > tol
    share = float(out.float().mean())
    max_err["control_step_B1024_share_out"] = share
    print(f"control step, B=1024: {share:.2%} of envs beyond the bounds")
    check(share <= 0.02, f"control step B=1024: {share:.2%} of envs beyond the bounds")

    # one env step through the kernel against the plain path on the CPU:
    # observation, reward and done of the whole step (gross-error gate:
    # 20 substeps apart, the state bounds above carry into the observation)
    g = torch.Generator(device=dev).manual_seed(4)
    state, obs = env.reset_batch(8, g)
    act = 0.1 * torch.randn(8, env.action_size, generator=g, device=dev)
    res_k = env.step(state, act)
    env_cpu = make("DeepMimicWalk-v0", device="cpu")
    to_cpu = lambda x: x.cpu()  # noqa: E731
    from pfpn_torch.sim.types import tree_map
    res_p = env_cpu.step(tree_map(to_cpu, state), act.cpu())
    e_obs = float((res_k.obs.cpu() - res_p.obs).abs().max())
    e_rew = float((res_k.reward.cpu() - res_p.reward).abs().max())
    max_err["env_step_B8"] = {"obs": e_obs, "reward": e_rew}
    print(f"env step, B=8, kernel vs plain on the CPU: obs {e_obs:.3g}, reward {e_rew:.3g}")
    check(e_obs <= 5e-2 and e_rew <= 1e-2, "env step: kernel path far from the plain path")
    check(bool((res_k.done.cpu() == res_p.done).all()), "env step: done differs")

    # ---- 4. the acting path -------------------------------------------------
    algo = build_algo(build("deepmimic_dppo_pfpn", particles=35), dev)
    load_policy(algo, NPZ)
    main_mega = algo.env.engine.mega
    counted = (main_mega, linalg, sl)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    rec_on = ReturnRecorder(algo.env.step_batch)
    with mock.patch.object(algo.env, "step_batch", rec_on):
        res = play(NPZ, episodes=10, max_steps=600, seed=0, algo=algo)
    torch.cuda.synchronize()
    play_s = time.time() - t0
    work = tempfile.TemporaryDirectory()      # phase 10's input and output, phase 13's run
    rec_path = os.path.join(work.name, "play_megastep.pt")
    torch.save({"rewards": rec_on.rewards, "dones": rec_on.dones}, rec_path)
    launches = main_mega.launches
    acting_counts = counts()
    rew = res["reward"].cpu()
    frames = res["frames"].cpu()
    steps = int(frames.max())
    print(f"play: 10 deterministic Walk episodes in {play_s:.1f} s: return mean "
          f"{float(rew.mean()):.2f} min {float(rew.min()):.2f} max {float(rew.max()):.2f}, "
          f"frames mean {float(frames.float().mean()):.1f}; {steps} env steps, "
          f"{launches} kernel launches")
    check(bool(torch.isfinite(rew).all()), "play: return not finite")
    check(steps >= 1 and launches == steps,
          f"play: {launches} kernel launches for {steps} env steps")
    check(acting_counts["spd_inverse"] == 0 and acting_counts["substep_lin"] == 0
          and acting_counts["megastep_emit_links"] == 0,
          f"play: other kernels launched on the megastep path: {acting_counts}")

    # ---- 5. times -------------------------------------------------------------
    # both variants at both batch sizes for each block size, in turns
    sweep = {}
    for B, reps in ((8, 20), (BIG_B, 2)):   # the training batch; the bench batch
        st, ts, tr = perturbed(B, 5)
        fns = {(links, th): (lambda links=links, th=th: mega.kernel(
                   st, ts, tr, links=links, threads=th))
               for links in (False, True) for th in THREADS}
        for (links, th), t in in_turns(fns, reps).items():
            sweep[(B, "emit_links" if links else "default", th)] = t
    for (B, variant, th), t in sorted(sweep.items()):
        print(f"megastep B={B} {variant}, {th} threads per block [{card}], median (min-max) "
              f"of 5 groups in turns: {spread_text(t)}")
    kernel_ms = sweep[(BIG_B, "default", default_threads)][0]
    st, ts, tr = perturbed(BIG_B, 5)
    plain_ms = cuda_ms(lambda: mega.plain(st, ts, tr), warm=1, reps=2)
    flops = ms.megastep_flops(meta) * BIG_B
    nbytes = ms.megastep_bytes(meta, BIG_B)
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"megastep B={BIG_B} [{card}]: kernel {kernel_ms:.3f} ms ({default_threads} threads), "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms by {bound_by} "
          f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.2f} MB)")

    g = torch.Generator(device=dev).manual_seed(6)
    n_steps = 15
    state = {"s": env.reset_batch(BIG_B, g)[0]}

    def rand_step():
        a = torch.rand(BIG_B, env.action_size, generator=g, device=dev) * 0.4 - 0.2
        state["s"] = env.step_autoreset(state["s"], a, g)[0]

    step_ms = cuda_ms(rand_step, warm=2, reps=n_steps)
    sps = BIG_B / (step_ms / 1e3)
    print(f"step_autoreset B={BIG_B}, random actions in +-0.2 [{card}]: "
          f"{sps:.0f} env steps/s ({step_ms:.2f} ms per step)")

    penv, net = algo.env, algo.net
    pst, pobs = penv.reset_batch(BIG_B, g)
    pstate = {"s": pst, "o": pobs}

    @torch.no_grad()
    def policy_step():
        a = algo._clip_action(net.act_deterministic(pstate["o"]))
        pstate["s"], pstate["o"], _ = penv.step_autoreset(pstate["s"], a, g)

    pol_ms = cuda_ms(policy_step, warm=2, reps=n_steps)
    psps = BIG_B / (pol_ms / 1e3)
    print(f"step_autoreset B={BIG_B}, PFPN-35 act_deterministic in the loop "
          f"[{card}]: {psps:.0f} env steps/s ({pol_ms:.2f} ms per step)")
    clocks = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"after timing: clocks.sm, power.draw, temperature: {clocks}")

    # ---- inputs of the per-substep phases ----------------------------------------
    from pfpn_torch.control.spd import spd_errors
    from pfpn_torch.sim import contact as contact_mod
    from pfpn_torch.sim.engine import Engine
    from pfpn_torch.sim.types import tree_map, zero_state

    eng, tree = env.engine, env.tree
    n_dof = tree.ndof
    kd_t = torch.tensor(eng.gains.kd, dtype=torch.float32, device=dev)
    kp_t = torch.tensor(eng.gains.kp, dtype=torch.float32, device=dev)

    def perturbed_sim(B: int, seed: int):
        return ms.unpack_state(meta, perturbed(B, seed)[0], zero_state(tree, B, device=dev))

    def drop_sim(B: int, seed: int):
        """Falling states touching the ground (tests/test_fused.py:26-40)."""
        g = torch.Generator(device=dev).manual_seed(seed)
        sim = zero_state(tree, B, device=dev)
        sim.base_pos[:] = torch.tensor([0.0, 0.878, 0.0], device=dev)
        sim.base_lin[:] = torch.tensor([0.1, -0.5, 0.05], device=dev)
        return sim.replace(
            base_ang=0.1 * torch.randn(B, 3, generator=g, device=dev),
            w_sph=0.2 * torch.randn(sim.w_sph.shape, generator=g, device=dev),
            w_rev=0.2 * torch.randn(sim.w_rev.shape, generator=g, device=dev))

    def mixed_sim(B: int, seed: int):
        return tree_map(lambda a, b: torch.cat([a, b]), perturbed_sim(B // 2, seed),
                        drop_sim(B - B // 2, seed + 1))

    def identity_targets(B: int):
        ts = torch.zeros(B, S, 4, device=dev)
        ts[..., 3] = 1.0
        return ts, torch.zeros(B, NR, device=dev)

    def h_pairs(sim):
        """(H + diag(kd dt) + eps, H + eps) (B, 2, n, n), as Engine.substep
        forms them."""
        h = eng._dynamics(sim)[1]
        eye = torch.eye(n_dof, device=dev)
        return torch.stack([h + torch.diag(kd_t * eng.config.dt) + 1e-8 * eye,
                            h + 1e-8 * eye], 1)

    def core_inputs(sim):
        """substep_core inputs under identity targets (tests/test_fused.py:100-118)."""
        fkr, h, c, v = eng._dynamics(sim)
        ts, tr = identity_targets(h.shape[0])
        e_p, e_dp = spd_errors(tree, eng.gains, sim, ts, tr, eng.config.dt)
        kpe = kp_t * e_p + kd_t * e_dp
        rs = contact_mod.assemble_rows(tree, eng.contact_set, eng.config.contact,
                                       fkr, sim.q_rev, eng.config.dt)
        return (h, kpe - c, kpe, v, rs.rows, rs.target, rs.act_n, rs.act_l)

    def bound(flops: float, nbytes: float):
        t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    # ---- 6. spd_inverse ---------------------------------------------------------
    pairs = torch.cat([h_pairs(perturbed_sim(512, 7)), h_pairs(drop_sim(512, 8))])
    x_k = linalg.spd_inverse_kernel(pairs)
    x_p = linalg.spd_inverse_reference(pairs)
    torch.cuda.synchronize()
    eye64 = torch.eye(n_dof, dtype=torch.float64, device=dev)
    resid_k = float((pairs.double() @ x_k.double() - eye64).abs().max())
    resid_p = float((pairs.double() @ x_p.double() - eye64).abs().max())
    spd_abs = float((x_k - x_p).abs().max())
    spd_rel = spd_abs / float(x_p.abs().max())
    max_err["spd_inverse_B1024"] = {"resid_kernel": resid_k, "resid_plain": resid_p,
                                    "rel": spd_rel, "abs": spd_abs}
    print(f"spd_inverse_pair, B=1024: max |A X - I| kernel {resid_k:.3g}, plain "
          f"{resid_p:.3g}; max |X_k - X_p| / max |X_p| {spd_rel:.3g}")
    check(bool(torch.isfinite(x_k).all()), "spd_inverse: kernel output not finite")
    check(spd_rel <= 1e-5, f"spd_inverse: relative error {spd_rel:.3g} > 1e-5")
    check(resid_k <= 5e-4, f"spd_inverse: kernel residual {resid_k:.3g} > 5e-4")

    pairs = h_pairs(perturbed_sim(BIG_B, 9))
    # the yardstick factors with cholesky_ex: cholesky's info check would
    # synchronize with the host inside the timed window
    spd_t = cuda_ms_spread(lambda: linalg.spd_inverse_kernel(pairs), warm=3, reps=20)
    single = pairs[:, 1].contiguous()
    spd1_t = cuda_ms_spread(lambda: linalg.spd_inverse_kernel(single), warm=3, reps=20)
    del single
    spd_plain_t = cuda_ms_spread(lambda: linalg.spd_inverse_reference(pairs),
                                 warm=2, reps=10)
    spd_lib_t = cuda_ms_spread(
        lambda: torch.cholesky_inverse(torch.linalg.cholesky_ex(pairs)[0]), warm=2, reps=10)
    spd_ms, spd_plain_ms, spd_lib_ms = spd_t[0], spd_plain_t[0], spd_lib_t[0]
    n_mat = 2 * BIG_B
    # an SPD inverse needs n^3 operations at least: Cholesky, the inverse of
    # the factor and L^-T L^-1, n^3/3 each
    spd_bound_ms, spd_bound_by = bound(n_mat * float(n_dof ** 3),
                                       n_mat * 2 * 4 * n_dof * n_dof)
    spd_group = linalg.group_threads(n_dof)
    print(f"spd_inverse_pair B={BIG_B} ({n_mat} matrices) [{card}], median (min-max) "
          f"of 5 groups: kernel {spread_text(spd_t)} ({spd_group} threads per matrix), "
          f"plain {spread_text(spd_plain_t)}, "
          f"cholesky_ex + cholesky_inverse {spread_text(spd_lib_t)}, "
          f"bound {spd_bound_ms:.4f} ms by {spd_bound_by}, "
          f"{spd_bound_ms / spd_ms:.1%} of the bound; spd_inverse on {BIG_B} matrices "
          f"{spread_text(spd1_t)}")
    del pairs, x_k, x_p

    # ---- 7. substep_core --------------------------------------------------------
    smeta = eng.substep_meta
    args = core_inputs(drop_sim(256, 10))
    v_k = sl.substep_core_kernel(smeta, *args)
    v_p = sl.substep_core_reference(smeta, *args)
    torch.cuda.synchronize()
    core_abs = float((v_k - v_p).abs().max())
    core_excess = float(((v_k - v_p).abs() - (2e-4 + 2e-4 * v_p.abs())).max())
    max_err["substep_core_B256"] = {"abs": core_abs}
    print(f"substep_core, B=256 drop states: max abs err {core_abs:.3g}, "
          f"{int(args[6].sum())} active contacts")
    check(bool(args[6].sum() > 0), "substep_core: no contact active")
    check(core_excess <= 0, "substep_core: kernel beyond rtol = atol = 2e-4 of plain")

    args = core_inputs(drop_sim(BIG_B, 11))
    core_t = cuda_ms_spread(lambda: sl.substep_core_kernel(smeta, *args), warm=3, reps=20)
    core_plain_t = cuda_ms_spread(lambda: sl.substep_core_reference(smeta, *args),
                                  warm=2, reps=5)
    core_ms, core_plain_ms = core_t[0], core_plain_t[0]
    R, K, L = smeta.n_rows, smeta.n_contacts, smeta.n_limits
    core_bound_ms, core_bound_by = bound(
        float(sl.substep_flops(smeta)) * BIG_B,
        4 * BIG_B * (n_dof * n_dof + 4 * n_dof + R * n_dof + R + K + max(L, 1)))
    core_threads = sl.block_threads(smeta)
    print(f"substep_core B={BIG_B} [{card}], median (min-max) of 5 groups: kernel "
          f"{spread_text(core_t)} ({core_threads} threads per env), plain "
          f"{spread_text(core_plain_t)}, bound {core_bound_ms:.4f} ms by {core_bound_by}, "
          f"{core_bound_ms / core_ms:.1%} of the bound")
    del args

    # ---- 8. Engine.substep, kernel path against plain path ---------------------------
    pos = ("base_pos", "base_quat", "q_sph", "q_rev")
    vel = ("base_lin", "base_ang", "w_sph", "w_rev")
    g = torch.Generator(device=dev).manual_seed(12)
    sim = mixed_sim(256, 12)
    axis = torch.nn.functional.normalize(torch.randn(256, S, 3, generator=g, device=dev), dim=-1)
    half = 0.25 * (torch.rand(256, S, 1, generator=g, device=dev) - 0.5)
    ts = torch.cat([axis * torch.sin(half), torch.cos(half)], -1)
    tr = torch.rand(256, NR, generator=g, device=dev) - 0.5
    torques = []
    for m, b in enumerate(tree.motor_bodies):
        k = int(tree.dof_count[b])
        torques.append(0.6 * float(tree.motor_torque_limit[m])
                       * (2 * torch.rand(256, k, generator=g, device=dev) - 1))
    expect = {"fused": "substep_lin", "unfused": "spd_inverse",
              "torque": "spd_inverse", "position": "spd_inverse"}
    for mode, kernel_name in expect.items():
        cfg = dataclasses.replace(
            eng.config, control_mode=mode if mode in ("torque", "position") else "spd",
            fused=mode != "unfused", megastep=False)
        e = Engine(tree, cfg, eng.gains)
        call = dict(torque_motors=torques if mode == "torque" else None,
                    return_torque=mode == "unfused")
        reset_counts()
        got = e.substep(sim, ts, tr, **call)
        n_kernel = counts()
        with mock.patch.object(sl, "substep_core", sl.substep_core_reference), \
                mock.patch.object(linalg, "spd_inverse", linalg.spd_inverse_reference):
            want = e.substep(sim, ts, tr, **call)
        torch.cuda.synchronize()
        check(counts() == n_kernel, f"Engine.substep {mode}: the plain path launched a kernel")
        check(n_kernel[kernel_name] == 1 and sum(n_kernel.values()) == 1,
              f"Engine.substep {mode}: kernel launches {n_kernel}")
        err = {k: float((getattr(got[0], k) - getattr(want[0], k)).abs().max())
               for k in pos + vel}
        err["flags"] = float((got[1] != want[1]).sum())
        if mode == "unfused":
            err["tau"] = float((got[2] - want[2]).abs().max())
        max_err[f"engine_substep_{mode}_B256"] = err
        print(f"Engine.substep {mode}, B=256, kernel vs plain path: {json.dumps(err)}")
        for k, v in err.items():
            tol = 1e-5 if k in pos else 1e-4 if k in vel else 2e-3 if k == "tau" else 0.0
            check(v <= tol, f"Engine.substep {mode}: {k} error {v:.3g} > {tol:g}")
        check(bool(want[1].any()), f"Engine.substep {mode}: no contact engaged")

    # ---- 9. control step, megastep off against the megastep kernel ------------------
    e_off = Engine(tree, dataclasses.replace(eng.config, megastep=False), eng.gains)
    st, ts, tr = perturbed(1024, 14)
    sim = ms.unpack_state(meta, st, zero_state(tree, 1024, device=dev))
    reset_counts()
    got_sim, got_lc = e_off.control_step(sim, ts.reshape(1024, S, 4), tr)
    n_off = counts()
    want = mega.kernel(st, ts, tr)
    torch.cuda.synchronize()
    check(n_off["substep_lin"] == meta.frame_skip and n_off["megastep"] == 0,
          f"control step, megastep off: launches {n_off}")
    got_st = ms.pack_state(meta, got_sim)
    out = eng.link_contact_from_active(want[1]) != got_lc
    out = out.any(1)
    e9 = {"flags": float(out.float().mean())}
    for k, tol in tol20.items():
        if k in groups:
            ek = (got_st[:, groups[k]] - want[0][:, groups[k]]).abs().amax(1)
            e9[k] = float(ek.max())
            out |= ek > tol
    share_off = float(out.float().mean())
    max_err["control_step_off_vs_megastep_B1024"] = {**e9, "share_out": share_off}
    print(f"control step, B=1024, megastep off vs megastep kernel: {share_off:.2%} of envs "
          f"beyond the bounds; max errors {json.dumps(e9)}")
    check(bool(torch.isfinite(got_st).all()), "control step, megastep off: not finite")
    check(share_off <= 0.02, f"control step, megastep off: {share_off:.2%} of envs "
          "beyond the bounds")

    # ---- 11. the spd_inverse paths at B=8192 -----------------------------------------
    g = torch.Generator(device=dev).manual_seed(15)
    log_state, _ = env.reset_batch(BIG_B, g)
    log_act = torch.rand(BIG_B, env.action_size, generator=g, device=dev) * 0.4 - 0.2
    reset_counts()
    log_res, tau_hist = env.step_log(log_state, log_act)
    check(bool(torch.isfinite(tau_hist).all() and torch.isfinite(log_res.obs).all()),
          "step_log: not finite")
    log_ms = cuda_ms(lambda: env.step_log(log_state, log_act), warm=0, reps=2)
    log_counts = counts()
    check(log_counts == {"megastep": 0, "megastep_emit_links": 0,
                         "spd_inverse": 3 * meta.frame_skip, "substep_lin": 0},
          f"step_log: launches {log_counts} for 3 steps")
    print(f"step_log B={BIG_B} [{card}]: {log_ms:.2f} ms per env step; launches "
          f"{log_counts} for 3 env steps")

    env_tq = make("DeepMimicWalk-v0", device=dev, control_mode="torque")
    tq_state = {"s": env_tq.reset_batch(BIG_B, g)[0]}

    def torque_step():
        a = torch.rand(BIG_B, env_tq.action_size, generator=g, device=dev) * 0.4 - 0.2
        tq_state["s"] = env_tq.step_autoreset(tq_state["s"], a, g)[0]

    reset_counts()
    tq_ms = cuda_ms(torque_step, warm=1, reps=2)
    tq_counts = counts()
    tq_sim = tq_state["s"].sim
    check(all(bool(torch.isfinite(getattr(tq_sim, k)).all()) for k in pos + vel),
          "torque control: state not finite")
    check(tq_counts == {"megastep": 0, "megastep_emit_links": 0,
                        "spd_inverse": 3 * meta.frame_skip, "substep_lin": 0},
          f"torque control: launches {tq_counts} for 3 steps")
    tq_sps = BIG_B / (tq_ms / 1e3)
    print(f"step_autoreset B={BIG_B}, torque control, random normalized torques in "
          f"+-0.2 [{card}]: {tq_sps:.0f} env steps/s ({tq_ms:.2f} ms per step); "
          f"launches {tq_counts} for 3 steps")

    # where a megastep-off substep's time goes: the plain dynamics (FK, H, C,
    # velocities) against the rest and the kernel
    split = {}
    for B in (10, BIG_B):
        sim = perturbed_sim(B, 16)
        ts, tr = identity_targets(B)
        split[B] = {"substep_ms": cuda_ms(lambda: e_off.substep(sim, ts, tr), warm=1, reps=5),
                    "dynamics_ms": cuda_ms(lambda: eng._dynamics(sim), warm=1, reps=5)}
        print(f"megastep-off Engine.substep B={B} [{card}]: {split[B]['substep_ms']:.3f} ms, "
              f"of which the plain dynamics {split[B]['dynamics_ms']:.3f} ms "
              f"(substep_lin kernel at B={BIG_B}: {core_ms:.3f} ms)")
    clocks = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"after the per-substep phases: clocks.sm, power.draw, temperature: {clocks}")

    # ---- 12. the megastep's emit_links variant ---------------------------------------
    from pfpn_torch.sim.dynamics import fk, link_states

    with megastep_links_on():
        env_l = make("DeepMimicWalk-v0", device=dev)
    mega_l = env_l.engine.mega
    check(env_l.engine.megastep_links, "PFPN_MEGASTEP_LINKS=1: the engine's switch is off")
    st, ts, tr = perturbed(1024, 17)
    got_l = mega_l.kernel(st, ts, tr, links=True)
    got_d = mega.kernel(st, ts, tr)
    torch.cuda.synchronize()
    check(all(bool(torch.equal(a, b)) for a, b in zip(got_d, got_l[:3])),
          "emit_links: state, flags or history differ from the default variant's")
    def link_errors(out, tag):
        """The kernel's link rows against plain link_states(fk(.)) of its own
        final state: one FK in fp32 on each side, the kernel's with FMA
        contraction; quaternions up to sign."""
        final = ms.unpack_state(meta, out[0], zero_state(tree, out[0].shape[0], device=dev))
        links_got = ms.links_to_states(meta, out[3])
        links_want = link_states(tree, fk(tree, final))
        e = {}
        for k in links_got._fields:
            a, b = getattr(links_got, k), getattr(links_want, k)
            if "quat" in k:
                a = a * torch.sign((a * b).sum(-1, keepdim=True))
            e[k] = float((a - b).abs().max())
        for k, v in e.items():
            tol = 5e-5 if "vel" in k else 1e-5
            check(v <= tol, f"emit_links {tag}: {k} error {v:.3g} > {tol:g}")
        return e

    e12 = link_errors(got_l, "B=1024")
    max_err["emit_links_B1024"] = e12
    print(f"emit_links, B=1024, one control step: state, flags and history bit-equal to "
          f"the default variant; link rows vs plain link_states(fk(.)): {json.dumps(e12)}")

    g = torch.Generator(device=dev).manual_seed(18)
    state, _ = env.reset_batch(64, g)
    act = 0.1 * torch.randn(64, env.action_size, generator=g, device=dev)
    n_def = mega.launches
    res_off = env.step(state, act)
    res_on = env_l.step(state, act)
    torch.cuda.synchronize()
    check(mega.launches == n_def + 1 and mega_l.launches_links == 2
          and mega_l.launches == 0,
          "env step: the links switch did not route the step through emit_links")
    e_obs = float((res_on.obs - res_off.obs).abs().max())
    e_rew = float((res_on.reward - res_off.reward).abs().max())
    max_err["env_step_links_vs_default_B64"] = {"obs": e_obs, "reward": e_rew}
    print(f"env step, B=64, megastep_links on vs off: obs {e_obs:.3g}, reward {e_rew:.3g}")
    # the same state; only the link states' arithmetic differs (bounds above)
    check(e_obs <= 1e-4 and e_rew <= 1e-5, "env step: megastep_links on far from off")
    check(bool((res_on.done == res_off.done).all()), "env step: done differs with links")

    # the training batch, B=8 (one partly filled block): the variant against
    # its plain version, the state to phase 3's control-step bounds, flags
    # exact, and its link rows as at B=1024
    st, ts, tr = perturbed(8, 20)
    got8 = mega_l.kernel(st, ts, tr, links=True)
    want8 = mega_l.plain(st, ts, tr, links=True)
    torch.cuda.synchronize()
    e8 = summary(errors(got8, want8))
    e8_links = link_errors(got8, "B=8")
    max_err["emit_links_B8"] = {**e8, "links": e8_links}
    print(f"emit_links, B=8, one control step vs its plain version: {json.dumps(e8)}; "
          f"link rows vs plain link_states(fk(.)): {json.dumps(e8_links)}")
    check(bool(want8[1].any()), "emit_links B=8: no contact engaged")
    for k, tol in tol20.items():
        check(e8[k] <= tol, f"emit_links B=8: {k} error {e8[k]:.3g} > {tol:g}")

    variant_t = {}
    for B, reps in ((BIG_B, 2), (8, 20)):   # the bench batch; the training batch
        st, ts, tr = perturbed(B, 19)
        final = ms.unpack_state(meta, st, zero_state(tree, B, device=dev))
        variant_t[B] = in_turns({       # default, links, default, links, ...
            "default": lambda: mega.kernel(st, ts, tr),
            "emit_links": lambda: mega.kernel(st, ts, tr, links=True)}, reps)
        variant_t[B]["plain_epilogue"] = cuda_ms_spread(
            lambda: link_states(tree, fk(tree, final)), warm=2, reps=10)
        del st, ts, tr, final
    def_t, links_t, epi_t = (variant_t[BIG_B][k] for k in ("default", "emit_links",
                                                            "plain_epilogue"))
    links_bound_ms, links_bound_by = bound(
        float(ms.megastep_flops(meta, emit_links=True)) * BIG_B,
        ms.megastep_bytes(meta, BIG_B, emit_links=True))
    for B, t in variant_t.items():
        print(f"megastep B={B} [{card}], median (min-max) of 5 groups in turns: default "
              f"{spread_text(t['default'])}, emit_links {spread_text(t['emit_links'])}; "
              f"the plain epilogue it replaces, link_states(fk(.)): "
              f"{spread_text(t['plain_epilogue'])}")
    print(f"emit_links bound at B={BIG_B}: {links_bound_ms:.4f} ms by {links_bound_by}")

    # ---- 13. training ------------------------------------------------------------------
    from pfpn_torch.algos.ppo import PPO, PPOState
    from pfpn_torch.harness import cli
    from pfpn_torch.harness.build import build_net
    from pfpn_torch.harness.checkpoint import CheckpointManager

    seed = 34114
    cfg = build("deepmimic_dppo_pfpn", particles=35, seed=seed)
    with megastep_links_on():
        algo0 = build_algo(cfg, dev)
    state0 = algo0.init_state(torch.Generator(device=dev).manual_seed(seed))
    params0 = {k: v.detach().clone() for k, v in state0.net.named_parameters()}
    del algo0, state0

    timing = {"rollout_s": [], "update_s": [], "kernel_events": []}
    last = {}
    rollout0, update0, kernel0 = PPO.rollout, PPO.update, ms.Megastep.kernel

    def timed_rollout(self, state):
        torch.cuda.synchronize()
        t = time.time()
        out = rollout0(self, state)
        torch.cuda.synchronize()
        timing["rollout_s"].append(time.time() - t)
        last["traj"] = out[1]
        return out

    def timed_update(self, state, traj):
        torch.cuda.synchronize()
        t = time.time()
        out = update0(self, state, traj)
        torch.cuda.synchronize()
        timing["update_s"].append(time.time() - t)
        return out

    def timed_kernel(self, *args, **kwargs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = kernel0(self, *args, **kwargs)
        e1.record()
        timing["kernel_events"].append((e0, e1))
        return out

    n_spd, n_sl = linalg.launches, sl.launches
    root = os.path.join(work.name, "train")     # phase 16 evaluates its checkpoint
    with megastep_links_on(), \
            mock.patch.object(PPO, "rollout", timed_rollout), \
            mock.patch.object(PPO, "update", timed_update), \
            mock.patch.object(ms.Megastep, "kernel", timed_kernel):
        t0 = time.time()
        algo_t, state_t = cli.main(
            ["--env", "DeepMimicWalk-v0", "--setting", "deepmimic_dppo_pfpn",
             "--particles", "35", "--seed", str(seed), "--train", "--max_rounds", "2",
             "--root", root])
        torch.cuda.synchronize()
        train_s = time.time() - t0
        eng_t = algo_t.env.engine
        train_counts = {"megastep": eng_t.mega.launches,
                        "megastep_emit_links": eng_t.mega.launches_links,
                        "spd_inverse": linalg.launches - n_spd,
                        "substep_lin": sl.launches - n_sl}
        with open(os.path.join(cfg.log_dir(root), "metrics.jsonl")) as fh:
            records = [json.loads(line) for line in fh]
        losses = {k: [r[k] for r in records if k in r] for k in (
            "train/loss", "train/policy_loss", "train/value_loss", "train/entropy",
            "train/episode_reward")}
        ckpt = CheckpointManager(cfg.checkpoint_dir(root))
        ckpt_steps = ckpt.steps()
        fresh = build_algo(cfg, dev)
        restored = ckpt.restore_latest(fresh.init_state(torch.Generator(device=dev).manual_seed(1)))
    rounds = len(timing["rollout_s"])
    n_env_steps = rounds * algo_t.cfg.unroll_length
    n_minibatches = state_t.global_step
    mega_train_ms = sum(e0.elapsed_time(e1) for e0, e1 in timing["kernel_events"])
    rollout_s, update_s = sum(timing["rollout_s"]), sum(timing["update_s"])
    train_stats = {
        "train_s": train_s, "rounds": rounds,
        "round_s": (rollout_s + update_s) / rounds,
        "rollout_ms_per_env_step": rollout_s * 1e3 / n_env_steps,
        "megastep_ms_per_env_step": mega_train_ms / len(timing["kernel_events"]),
        "update_ms_per_minibatch": update_s * 1e3 / n_minibatches,
        "samples_per_s": state_t.total_samples / (rollout_s + update_s),
        "global_step": state_t.global_step, "total_samples": state_t.total_samples,
        "losses": losses, "launches": train_counts, "checkpoint_steps": ckpt_steps,
    }
    print(f"training, 2 rounds of 8 envs x 512 steps through the CLI [{card}]: "
          f"{train_s:.1f} s; round {train_stats['round_s']:.2f} s = rollout "
          f"{train_stats['rollout_ms_per_env_step']:.2f} ms per env step (of which the "
          f"megastep {train_stats['megastep_ms_per_env_step']:.2f} ms) + update "
          f"{train_stats['update_ms_per_minibatch']:.2f} ms per minibatch; "
          f"{train_stats['samples_per_s']:.1f} samples/s; launches {train_counts}; "
          f"global_step {state_t.global_step}, total_samples {state_t.total_samples}")
    print(f"training losses: {json.dumps(losses)}")

    # a profiler window over rollout steps at the training batch (B=8),
    # through the emit_links variant as the training run took them
    from torch.profiler import ProfilerActivity, profile

    prof_ppo = PPO(algo_t.env, algo_t.net,
                   dataclasses.replace(algo_t.cfg, unroll_length=PROFILE_STEPS))
    with torch.no_grad():
        prof_state = prof_ppo.rollout(state_t)[0]          # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_ppo.rollout(prof_state)
            torch.cuda.synchronize()
    train_profile = profile_summary(prof, PROFILE_STEPS)
    if train_profile["device_time"]:
        print(f"training rollout, {PROFILE_STEPS} steps at B=8 under torch.profiler [{card}]: "
              f"window {train_profile['window_ms']:.2f} ms, device busy "
              f"{train_profile['busy_ms']:.2f} ms ({train_profile['busy_share']:.1%}), "
              f"{train_profile['kernels_per_step']:.0f} kernel launches per env step")
        for row in train_profile["top"]:
            print(f"  {row['ms']:9.3f} ms  {row['calls']:6d} calls  {row['kernel']}")
    else:
        print("training rollout under torch.profiler: the trace shows no device time; "
              "the CUDA-event split above stands")
    check(train_counts == {"megastep": 0, "megastep_emit_links": 2 * 512,
                           "spd_inverse": 0, "substep_lin": 0},
          f"training: launches {train_counts}, want 1024 of emit_links and nothing else")
    check(state_t.global_step == 32 and state_t.total_samples == 8192,
          f"training: global_step {state_t.global_step}, total_samples "
          f"{state_t.total_samples}")
    check(all(len(v) == 2 and all(math.isfinite(x) for x in v) for v in losses.values()),
          f"training: losses not finite or not logged: {losses}")
    moved = {k: bool((p.detach() != params0[k]).any())
             for k, p in algo_t.net.named_parameters()}
    check(all(moved.values()), f"training: parameters that did not move: "
          f"{[k for k, v in moved.items() if not v]}")
    check(ckpt_steps == [32] and restored is not None, f"training: checkpoints {ckpt_steps}")
    same = all(torch.equal(a, b) for a, b in zip(algo_t.net.state_dict().values(),
                                                  fresh.net.state_dict().values()))
    opt_a, opt_b = algo_t.opt.state_dict()["state"], fresh.opt.state_dict()["state"]
    same_opt = opt_a.keys() == opt_b.keys() and all(
        torch.equal(opt_a[i][k].cpu(), opt_b[i][k].cpu())
        for i in opt_a for k in ("step", "exp_avg", "exp_avg_sq"))
    check(same and same_opt, "training: the checkpoint does not restore the same "
          "parameters and Adam state")
    print("training: checkpoint at step 32 restores the same parameters, normalizer and "
          "Adam state")

    # one update from an identical state and trajectory on the card and on the CPU:
    # the first 32 steps of the last rollout are one minibatch of 256, so the
    # shuffle, which draws differently on the two devices, cannot matter
    traj = {k: v[:32] for k, v in last["traj"].items()}
    start = {k: v.detach().cpu() for k, v in algo_t.net.state_dict().items()}
    opt_start = algo_t.opt.state_dict()
    one = dataclasses.replace(algo_t.cfg, unroll_length=32)
    after = {}
    for d in (dev, torch.device("cpu")):
        net_d = build_net(cfg, algo_t.env).to(d)
        net_d.load_state_dict(start)
        ppo_d = PPO(None, net_d, one)
        # a copy each: load_state_dict keeps tensors already on the device, and
        # the update writes the Adam moments in place
        ppo_d.opt.load_state_dict(copy.deepcopy(opt_start))
        st_d = PPOState(net=net_d, opt=ppo_d.opt, env_state=None, obs=None,
                        head_stats={k: v.to(d) if torch.is_tensor(v) else v
                                    for k, v in state_t.head_stats.items()},
                        generator=torch.Generator(device=d).manual_seed(0),
                        global_step=state_t.global_step)
        ppo_d.update(st_d, {k: v.to(d) for k, v in traj.items()})
        after[d.type] = {k: v.detach().cpu() for k, v in net_d.state_dict().items()}
    upd_err = max(float((after["cuda"][k] - after["cpu"][k]).abs().max()) for k in start)
    max_err["update_card_vs_cpu"] = upd_err
    print(f"one update (256 samples, Adam step 33), card vs CPU: post-update parameters "
          f"and normalizer max abs err {upd_err:.3g}")
    # a hundredth of a step (lr 1e-4): sums in another order on each device
    check(upd_err <= 1e-6, f"update card vs CPU: {upd_err:.3g} > 1e-6")
    clocks = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"after training: clocks.sm, power.draw, temperature: {clocks}")

    # ---- 26. fast_dynamics on the card -----------------------------------------------
    fast_dyn = phase_fast_dynamics(dev, card, env, perturbed_sim, identity_targets,
                                   reset_counts, counts, in_turns)

    # ---- 10. the megastep-off path: play, in a second process ---------------------------
    # launch-bound on the host like phases 14-16, 18-25 and 27-29, so they run side
    # by side (the card is idle most of the time in all); kernel timings stay alone
    off_path = os.path.join(work.name, "play_megastep_off.json")
    off_log = open(os.path.join(work.name, "play_megastep_off.log"), "w+")
    off_proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--megastep-off-play", rec_path, off_path],
        stdout=off_log, stderr=subprocess.STDOUT)
    atexit.register(lambda: off_proc.poll() is None and off_proc.kill())
    t_side = time.time()

    # ---- 14. play the shipped Punch, Kick and MultiTask policies ----------------------
    import numpy as np

    task_plays, play_faults = {}, []
    for env_name, ref in TASK_PLAYS.items():
        algo_p = build_algo(build("deepmimic_dppo_pfpn", particles=35, env=env_name), dev)
        load_policy(algo_p, ref["npz"])
        n_tasks = len(env_megasteps(algo_p.env))
        init_time = torch.tensor(ref["init_time"], device=dev)
        zero_counts(algo_p.env)
        torch.cuda.synchronize()
        t0 = time.time()
        out_p = play(ref["npz"], episodes=len(ref["init_time"]), max_steps=600, algo=algo_p,
                   init_time=init_time)
        torch.cuda.synchronize()
        wall = time.time() - t0
        c = path_counts(algo_p.env)
        rew_p = out_p["reward"].cpu().numpy()
        frames_p = out_p["frames"].cpu().numpy()
        steps_p = int(frames_p.max())
        jax_ret = np.asarray(ref["jax_return"])
        mean, jax_mean = float(rew_p.mean()), float(jax_ret.mean())
        rel = abs(mean - jax_mean) / jax_mean
        row = {"return_mean": mean, "jax_return_mean": jax_mean, "rel": rel,
               "jax_return_mean_key1": ref["jax_return_mean_key1"],
               "returns": rew_p.tolist(), "frames": frames_p.tolist(), "wall_s": wall,
               "launches": c, "env_steps": steps_p}
        text = ""
        if n_tasks > 1:
            ids = algo_p.env.task_ids(len(rew_p))
            row["per_task"] = {m: float(rew_p[ids == k].mean())
                               for k, m in enumerate(algo_p.env.motions)}
            row["jax_per_task"] = {m: float(jax_ret[ids == k].mean())
                                   for k, m in enumerate(algo_p.env.motions)}
            text = (f"; per task {json.dumps(row['per_task'])} (JAX "
                    f"{json.dumps(row['jax_per_task'])})")
        task_plays[env_name] = row
        print(f"play {env_name}: 10 deterministic episodes from JAX's PRNGKey(0) start times "
              f"in {wall:.1f} s [{card}]: return mean {mean:.2f} against JAX's {jax_mean:.2f} "
              f"on the CPU ({rel:.2%}; JAX from PRNGKey(1): {ref['jax_return_mean_key1']:.2f})"
              f"{text}; per episode {[round(float(x), 2) for x in rew_p]}, frames "
              f"{frames_p.tolist()}; {steps_p} env steps, launches {c}")
        check(bool(np.isfinite(rew_p).all()), f"play {env_name}: return not finite")
        check(steps_p == 600 and c == {"megastep": 600 * n_tasks, "megastep_emit_links": 0,
                                     "spd_inverse": 0, "substep_lin": 0},
              f"play {env_name}: launches {c} for {steps_p} env steps of {n_tasks} task(s)")
        if rel > 0.05:
            play_faults.append(f"play {env_name}: return {mean:.2f}, {rel:.2%} from JAX's "
                               f"{jax_mean:.2f}, more than 5%")
        del algo_p
    check(not play_faults, "; ".join(play_faults))

    # ---- 18. play the shipped SAC + PFPN-35 Walk policy -------------------------------
    algo_s = build_algo(build("deepmimic_sac_pfpn", particles=35), dev)
    load_policy(algo_s, SAC_PLAY["npz"])
    zero_counts(algo_s.env)
    linalg.launches = sl.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    out_s = play(SAC_PLAY["npz"], episodes=len(SAC_PLAY["init_time"]), max_steps=600,
                 algo=algo_s, init_time=torch.tensor(SAC_PLAY["init_time"], device=dev))
    torch.cuda.synchronize()
    sac_play_s = time.time() - t0
    sac_play_counts = path_counts(algo_s.env)
    rew_s = out_s["reward"].cpu().numpy()
    frames_s = out_s["frames"].cpu().numpy()
    jax_mean = float(np.mean(SAC_PLAY["jax_return"]))
    sac_rel = abs(float(rew_s.mean()) - jax_mean) / jax_mean
    sac_play = {"return_mean": float(rew_s.mean()), "jax_return_mean": jax_mean, "rel": sac_rel,
                "jax_return_mean_key1": SAC_PLAY["jax_return_mean_key1"],
                "returns": rew_s.tolist(), "frames": frames_s.tolist(), "wall_s": sac_play_s,
                "launches": sac_play_counts}
    print(f"play of the shipped SAC + PFPN-35 Walk npz: 10 deterministic episodes from JAX's "
          f"PRNGKey(0) start times in {sac_play_s:.1f} s [{card}]: return mean "
          f"{rew_s.mean():.2f} against JAX's {jax_mean:.2f} on the CPU ({sac_rel:.2%}; JAX from "
          f"PRNGKey(1): {SAC_PLAY['jax_return_mean_key1']:.2f}); per episode "
          f"{[round(float(x), 2) for x in rew_s]}, frames {frames_s.tolist()}; launches "
          f"{sac_play_counts}")
    check(bool(np.isfinite(rew_s).all()), "SAC play: return not finite")
    check(int(frames_s.max()) == 600 and sac_play_counts == {
        "megastep": 600, "megastep_emit_links": 0, "spd_inverse": 0, "substep_lin": 0},
          f"SAC play: launches {sac_play_counts} for {int(frames_s.max())} env steps")
    check(sac_rel <= 0.05, f"SAC play: return {rew_s.mean():.2f}, {sac_rel:.2%} from JAX's "
                           f"{jax_mean:.2f}, more than 5%")
    del algo_s

    # ---- 15. one training round of each new preset through the CLI ------------------
    new_rounds = {}
    for setting, env_name in (("deepmimic_dppo_gauss", "DeepMimicWalk-v0"),
                              ("deepmimic_dppo_dis", "DeepMimicWalk-v0"),
                              ("deepmimic_dppo_pfpn", "DeepMimicMultiTask-v0")):
        timing["rollout_s"].clear()
        timing["update_s"].clear()
        linalg.launches = sl.launches = 0
        with megastep_links_on(), tempfile.TemporaryDirectory() as root_n, \
                mock.patch.object(PPO, "rollout", timed_rollout), \
                mock.patch.object(PPO, "update", timed_update):
            t0 = time.time()
            algo_n, state_n = cli.main(
                ["--env", env_name, "--setting", setting, "--particles", "35", "--seed",
                 str(seed), "--train", "--max_rounds", "1", "--root", root_n])
            torch.cuda.synchronize()
            wall = time.time() - t0
            cfg_n = build(setting, particles=35, env=env_name, seed=seed)
            with open(os.path.join(cfg_n.log_dir(root_n), "metrics.jsonl")) as fh:
                recs = [json.loads(line) for line in fh]
            ckpt_n = CheckpointManager(cfg_n.checkpoint_dir(root_n)).steps()
        c = path_counts(algo_n.env)
        n_tasks = len(env_megasteps(algo_n.env))
        round_s = sum(timing["rollout_s"]) + sum(timing["update_s"])
        losses_n = {k: [r[k] for r in recs if k in r] for k in (
            "train/loss", "train/policy_loss", "train/value_loss", "train/episode_reward")}
        new_rounds[f"{setting}@{env_name}"] = {
            "wall_s": wall, "round_s": round_s, "rollout_s": sum(timing["rollout_s"]),
            "update_s": sum(timing["update_s"]),
            "samples_per_s": state_n.total_samples / round_s, "launches": c,
            "global_step": state_n.global_step, "losses": losses_n, "checkpoints": ckpt_n}
        print(f"training {setting} on {env_name}, 1 round of 8 envs x 512 steps through the "
              f"CLI [{card}]: {wall:.1f} s; round {round_s:.2f} s (rollout "
              f"{sum(timing['rollout_s']):.2f} s, update {sum(timing['update_s']):.2f} s), "
              f"{state_n.total_samples / round_s:.1f} samples/s; launches {c}; global_step "
              f"{state_n.global_step}; losses {json.dumps(losses_n)}")
        check(c == {"megastep": 0, "megastep_emit_links": 512 * n_tasks, "spd_inverse": 0,
                    "substep_lin": 0},
              f"training {setting} on {env_name}: launches {c}, want {512 * n_tasks} of "
              f"emit_links and nothing else")
        check(state_n.global_step == 16 and state_n.total_samples == 4096,
              f"training {setting}: global_step {state_n.global_step}, total_samples "
              f"{state_n.total_samples}")
        check(all(len(v) == 1 and all(math.isfinite(x) for x in v) for v in losses_n.values()),
              f"training {setting}: losses not finite or not logged: {losses_n}")
        check(ckpt_n == [16], f"training {setting}: checkpoints {ckpt_n}")
        del algo_n, state_n

    # ---- 19. SAC training at the shipped run's configuration ---------------------------
    from pfpn_torch.algos.sac import SAC

    sac_cfg = build("deepmimic_sac_pfpn", particles=35, seed=seed, env_multiplier=16)
    # the run's initial q1 (online and target alike): init_state's first draws
    net0 = build_net(sac_cfg, env).to(dev)
    net0.init_parameters(torch.Generator(device=dev).manual_seed(seed))
    q1_init = {k: v.clone() for k, v in net0.q1.state_dict().items()}
    del net0
    upd0, round0 = SAC._update_step, SAC.train_round
    sac_t = {"update": [], "round_s": []}
    kernel_calls = []

    def timed_update_step(self, *args, **kwargs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = upd0(self, *args, **kwargs)
        e1.record()
        sac_t["update"].append((e0, e1))
        return out

    def timed_round(self, state):
        torch.cuda.synchronize()
        t = time.time()
        out = round0(self, state)
        torch.cuda.synchronize()
        sac_t["round_s"].append(time.time() - t)
        return out

    def recording_kernel(self, st, *args, **kwargs):
        kernel_calls.append((int(st.shape[0]), bool(kwargs.get("links", False))))
        return kernel0(self, st, *args, **kwargs)

    def sac_round(setting, mult, root_s):
        """One round of an off-policy preset through the CLI; its numbers."""
        sac_t["update"].clear()
        sac_t["round_s"].clear()
        kernel_calls.clear()
        linalg.launches = sl.launches = 0
        with megastep_links_on(), \
                mock.patch.object(SAC, "_update_step", timed_update_step), \
                mock.patch.object(SAC, "train_round", timed_round), \
                mock.patch.object(ms.Megastep, "kernel", recording_kernel):
            t0 = time.time()
            algo_r, state_r = cli.main(
                ["--env", "DeepMimicWalk-v0", "--setting", setting, "--particles", "35",
                 "--seed", str(seed), "--env_multiplier", str(mult), "--train", "--max_rounds",
                 "1", "--root", root_s])
            torch.cuda.synchronize()
            wall = time.time() - t0
        cfg_r = build(setting, particles=35, seed=seed, env_multiplier=mult)
        with open(os.path.join(cfg_r.log_dir(root_s), "metrics.jsonl")) as fh:
            recs = [json.loads(line) for line in fh]
        keys = ["train/loss", "train/critic_loss", "train/actor_loss", "train/episode_reward"]
        keys += ["train/alpha"] if algo_r.cfg.algo == "sac" else []
        upd_ms = [e0.elapsed_time(e1) for e0, e1 in sac_t["update"]]
        round_s = sum(sac_t["round_s"])
        ckpt_r = CheckpointManager(cfg_r.checkpoint_dir(root_s))
        row = {"wall_s": wall, "round_s": round_s, "grad_steps": len(upd_ms),
               "ms_per_grad_step": sum(upd_ms) / max(len(upd_ms), 1),
               "grad_steps_s": sum(upd_ms) / 1e3, "env_part_s": round_s - sum(upd_ms) / 1e3,
               "samples_per_s": state_r.total_samples / round_s,
               "launches": path_counts(algo_r.env),
               "kernel_batches": sorted(set(kernel_calls)),
               "global_step": state_r.global_step, "total_samples": state_r.total_samples,
               "losses": {k: [r[k] for r in recs if k in r] for k in keys},
               "checkpoints": ckpt_r.steps()}
        row["env_ms_per_step"] = row["env_part_s"] * 1e3 / algo_r.cfg.steps_per_round
        print(f"training {setting}, 1 round of {algo_r.cfg.num_envs} envs x "
              f"{algo_r.cfg.steps_per_round} steps, {algo_r.cfg.updates_per_step} gradient steps "
              f"per env step, through the CLI [{card}]: {wall:.1f} s; round {round_s:.2f} s = "
              f"{len(upd_ms)} gradient steps {row['grad_steps_s']:.2f} s "
              f"({row['ms_per_grad_step']:.2f} ms each) + env steps and inserts "
              f"{row['env_part_s']:.2f} s ({row['env_ms_per_step']:.2f} ms per env step); "
              f"{row['samples_per_s']:.1f} samples/s; launches {row['launches']} at batch "
              f"{row['kernel_batches']}; global_step {state_r.global_step}, total_samples "
              f"{state_r.total_samples}; losses {json.dumps(row['losses'])}")
        check(row["launches"] == {"megastep": 0, "megastep_emit_links": 64, "spd_inverse": 0,
                                  "substep_lin": 0}
              and row["kernel_batches"] == [(algo_r.cfg.num_envs, True)],
              f"training {setting}: launches {row['launches']} at {row['kernel_batches']}, "
              f"want 64 of emit_links at B={algo_r.cfg.num_envs} and nothing else")
        want_steps = (64 - 256 // algo_r.cfg.num_envs + 1) * algo_r.cfg.num_envs
        check(state_r.global_step == want_steps and state_r.total_samples == 64 * mult,
              f"training {setting}: global_step {state_r.global_step} (want {want_steps}), "
              f"total_samples {state_r.total_samples}")
        check(all(len(v) == 1 and all(math.isfinite(x) for x in v)
                  for v in row["losses"].values()),
              f"training {setting}: losses not finite or not logged: {row['losses']}")
        check(row["checkpoints"] == [want_steps], f"training {setting}: checkpoints "
                                                  f"{row['checkpoints']}")
        return algo_r, state_r, cfg_r, row

    sac_root = os.path.join(work.name, "train_sac")      # phase 21 evaluates its checkpoint
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    algo_s, state_s, _, sac_train = sac_round("deepmimic_sac_pfpn", 16, sac_root)
    sac_train["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    sac_train["memory_before_gb"] = mem0 / 1e9
    ring = state_s.buffer
    ring_gb = ring.data.numel() * ring.data.element_size() / 1e9
    q1_now = algo_s.net.q1.state_dict()
    q1_tgt = algo_s.target["q1"].state_dict()
    moved = {k: (not torch.equal(q1_now[k], q1_init[k]), not torch.equal(q1_tgt[k], q1_init[k]),
                 not torch.equal(q1_now[k], q1_tgt[k])) for k in q1_init}
    ckpt_s = CheckpointManager(sac_cfg.checkpoint_dir(sac_root))
    ck_path = ckpt_s.path(state_s.global_step)
    ck_mb = os.path.getsize(ck_path) / 1e6
    ck_fields = sorted(torch.load(ck_path, map_location="cpu", weights_only=True))
    fresh_s = build_algo(sac_cfg, dev)
    restored_s = ckpt_s.restore_latest(
        fresh_s.init_state(torch.Generator(device=dev).manual_seed(1)))
    same_s = all(torch.equal(a, b) for m_a, m_b in ((algo_s.net, fresh_s.net),
                                                     (algo_s.target, fresh_s.target))
                 for a, b in zip(m_a.state_dict().values(), m_b.state_dict().values()))
    opt_a, opt_b = algo_s.opt.state_dict()["state"], fresh_s.opt.state_dict()["state"]
    same_opt_s = opt_a.keys() == opt_b.keys() and all(
        torch.equal(opt_a[i][k].cpu(), opt_b[i][k].cpu())
        for i in opt_a for k in ("step", "exp_avg", "exp_avg_sq"))
    restored_ring = restored_s.buffer.size
    del fresh_s, restored_s
    sac_train.update(ring_shape=list(ring.data.shape), ring_gb=ring_gb,
                     ring_device=str(ring.data.device), ring_size=ring.size,
                     checkpoint_mb=ck_mb, checkpoint_fields=ck_fields)
    print(f"SAC ring on the card: {tuple(ring.data.shape)} float32 on {ring.data.device}, "
          f"{ring_gb:.3f} GB, {ring.size} transitions held; torch.cuda.max_memory_allocated "
          f"over the round {sac_train['max_memory_allocated_gb']:.3f} GB, of which "
          f"{sac_train['memory_before_gb']:.3f} GB held before it [{card}]; checkpoint "
          f"{ck_mb:.2f} MB, fields {ck_fields}; restored with an empty ring ({restored_ring})")
    check(tuple(ring.data.shape) == SAC_RING and ring.data.is_cuda and ring.size == 1024,
          f"SAC ring: {tuple(ring.data.shape)} on {ring.data.device}, size {ring.size}")
    check(all(all(v) for v in moved.values()),
          f"SAC training: q1 online moved / target moved / apart: {moved}")
    check("buffer" not in ck_fields and ck_mb < 100 and restored_ring == 0,
          f"SAC checkpoint: fields {ck_fields}, {ck_mb:.1f} MB, restored ring {restored_ring}")
    check(same_s and same_opt_s, "SAC checkpoint: does not restore the same parameters, "
          "targets and Adam state")

    # a profiler window over gradient steps on the filled ring
    from torch.profiler import ProfilerActivity, profile

    def grad_steps(n):
        gstep, stats = state_s.global_step, state_s.head_stats
        for _ in range(n):
            batch = ring.sample(256, state_s.generator)
            gstep, stats, _ = algo_s._update_step(batch, algo_s.update_draws(
                256, state_s.generator), gstep, stats, state_s.generator)

    grad_steps(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        grad_steps(SAC_PROFILE_STEPS)
        torch.cuda.synchronize()
    sac_profile = profile_summary(prof, SAC_PROFILE_STEPS)
    sac_train["profile"] = sac_profile
    if sac_profile["device_time"]:
        print(f"SAC gradient steps, {SAC_PROFILE_STEPS} at batch 256 under torch.profiler "
              f"[{card}]: window {sac_profile['window_ms']:.2f} ms, device busy "
              f"{sac_profile['busy_ms']:.2f} ms ({sac_profile['busy_share']:.1%}), "
              f"{sac_profile['kernels_per_step']:.0f} kernel launches per gradient step")
        for row in sac_profile["top"]:
            print(f"  {row['ms']:9.3f} ms  {row['calls']:6d} calls  {row['kernel']}")
    else:
        print("SAC gradient steps under torch.profiler: the trace shows no device time")
    del algo_s, state_s, ring
    torch.cuda.empty_cache()

    # ---- 20. one round of each other off-policy preset ----------------------------------
    other_rounds = {}
    for setting in ("deepmimic_sac_gauss", "deepmimic_ddpg_pfpn", "deepmimic_ddpg_gauss"):
        with tempfile.TemporaryDirectory() as root_o:
            algo_o, state_o, _, other_rounds[setting] = sac_round(setting, 8, root_o)
        del algo_o, state_o
        torch.cuda.empty_cache()

    # ---- 22. one round of each A3C and IMPALA preset through the CLI --------------------
    from pfpn_torch.algos.a2c import A2C
    from pfpn_torch.algos.recurrent import RecurrentPPO
    from pfpn_torch.algos.vtrace import VTrace
    from pfpn_torch.harness.train import train
    from pfpn_torch.networks import value_norm as vnorm_mod

    def wrapped(cls, name, key, keep=None):
        """``cls.name`` timed into ``timing[key]`` (synchronized); ``keep(self,
        args, out)`` sees each call."""
        orig = getattr(cls, name)

        def wrapper(self, *args):
            torch.cuda.synchronize()
            t = time.time()
            out = orig(self, *args)
            torch.cuda.synchronize()
            timing[key].append(time.time() - t)
            if keep is not None:
                keep(self, args, out)
            return out

        return mock.patch.object(cls, name, wrapper)

    def keep_traj(self, args, out):
        last["traj"] = out[1]

    def same_state(a, b):
        """The same parameters, normalizer (and any other buffer) and Adam state."""
        same = all(torch.equal(x, y) for x, y in zip(a.net.state_dict().values(),
                                                     b.net.state_dict().values()))
        sa, sb = a.opt.state_dict()["state"], b.opt.state_dict()["state"]
        return same and sa.keys() == sb.keys() and all(
            torch.equal(sa[i][k].cpu(), sb[i][k].cpu())
            for i in sa for k in ("step", "exp_avg", "exp_avg_sq"))

    def round_losses(cfg_x, root_x):
        with open(os.path.join(cfg_x.log_dir(root_x), "metrics.jsonl")) as fh:
            recs = [json.loads(line) for line in fh]
        return {k: [r[k] for r in recs if k in r] for k in (
            "train/loss", "train/policy_loss", "train/value_loss", "train/entropy",
            "train/episode_reward")}

    def initial_params(cfg_x):
        """The parameters a run of ``cfg_x`` starts from (init_state's draws)."""
        with megastep_links_on():
            a0 = build_algo(cfg_x, dev)
        p0 = {k: v.detach().clone() for k, v in a0.init_state(
            torch.Generator(device=dev).manual_seed(seed)).net.named_parameters()}
        del a0
        return p0

    async_rounds, kept = {}, {}
    for setting in ASYNC_PRESETS:
        a3c = "a3c" in setting
        cfg_a = build(setting, particles=35, seed=seed)
        params0 = initial_params(cfg_a)
        for k in ("rollout_s", "update_s"):
            timing[k].clear()
        kernel_calls.clear()
        linalg.launches = sl.launches = 0
        with megastep_links_on(), tempfile.TemporaryDirectory() as root_a, \
                wrapped(PPO, "rollout", "rollout_s", keep_traj), \
                wrapped(PPO, "update", "update_s"), wrapped(VTrace, "update", "update_s"), \
                mock.patch.object(ms.Megastep, "kernel", recording_kernel):
            t0 = time.time()
            algo_a, state_a = cli.main(
                ["--env", "DeepMimicWalk-v0", "--setting", setting, "--particles", "35",
                 "--seed", str(seed), "--train", "--max_rounds", "1", "--root", root_a])
            torch.cuda.synchronize()
            wall = time.time() - t0
            losses_a = round_losses(cfg_a, root_a)
            ckpt_a = CheckpointManager(cfg_a.checkpoint_dir(root_a))
            ckpt_steps_a = ckpt_a.steps()
            fresh = build_algo(cfg_a, dev)
            restored = ckpt_a.restore_latest(
                fresh.init_state(torch.Generator(device=dev).manual_seed(1)))
        c = path_counts(algo_a.env)
        batches = sorted(set(kernel_calls))
        rollout_s, update_s = sum(timing["rollout_s"]), sum(timing["update_s"])
        moved = [k for k, p in algo_a.net.named_parameters()
                 if torch.equal(p.detach(), params0[k])]
        row = {"algo": type(algo_a).__name__, "wall_s": wall, "round_s": rollout_s + update_s,
               "rollout_s": rollout_s, "update_s": update_s,
               "rollout_ms_per_env_step": rollout_s * 1e3 / algo_a.cfg.unroll_length,
               "update_ms_per_step": update_s * 1e3 / state_a.global_step,
               "samples_per_s": state_a.total_samples / (rollout_s + update_s),
               "launches": c, "kernel_batches": batches, "global_step": state_a.global_step,
               "total_samples": state_a.total_samples, "losses": losses_a,
               "checkpoints": ckpt_steps_a}
        async_rounds[setting] = row
        print(f"training {setting} ({row['algo']}), 1 round of {algo_a.cfg.num_envs} envs x "
              f"{algo_a.cfg.unroll_length} steps through the CLI [{card}]: {wall:.1f} s; round "
              f"{row['round_s']:.2f} s = rollout {rollout_s:.2f} s "
              f"({row['rollout_ms_per_env_step']:.2f} ms per env step) + update {update_s:.2f} s "
              f"({state_a.global_step} gradient steps, {row['update_ms_per_step']:.2f} ms each); "
              f"{row['samples_per_s']:.1f} samples/s; launches {c} at {batches}; global_step "
              f"{state_a.global_step}, total_samples {state_a.total_samples}; losses "
              f"{json.dumps(losses_a)}")
        want_b, want_n = (16, 32) if a3c else (32, 64)
        want_steps, want_samples = (1, 512) if a3c else (8, 2048)
        check(c == {"megastep": 0, "megastep_emit_links": want_n, "spd_inverse": 0,
                    "substep_lin": 0} and batches == [(want_b, True)],
              f"training {setting}: launches {c} at {batches}, want {want_n} of emit_links at "
              f"B={want_b} and nothing else")
        check(state_a.global_step == want_steps and state_a.total_samples == want_samples,
              f"training {setting}: global_step {state_a.global_step}, total_samples "
              f"{state_a.total_samples}")
        check(all(len(v) == 1 and all(math.isfinite(x) for x in v) for v in losses_a.values()),
              f"training {setting}: losses not finite or not logged: {losses_a}")
        check(not moved, f"training {setting}: parameters that did not move: {moved}")
        check(ckpt_steps_a == [want_steps] and restored is not None
              and same_state(algo_a, fresh),
              f"training {setting}: checkpoints {ckpt_steps_a}, or the checkpoint does not "
              "restore the same parameters, normalizer and Adam state")
        if setting.endswith("_pfpn"):
            kept[setting] = (cfg_a, algo_a, state_a, last["traj"])
        del fresh, restored

    # ---- 23. A2C's and V-trace's gradient steps, card against CPU -------------------------
    # from the state after phase 22's round and its trajectory (A2C's 512
    # samples are one minibatch, V-trace's groups are fixed, so no shuffle can
    # differ): each gradient step of the update runs on the card and, from the
    # card's state before it, on the CPU, one step from an identical state as
    # in phase 13. V-trace's whole update (its 8 groups in one call) also runs
    # on each device from the first state, bound by 2e-5 (a fifth of one Adam
    # step at lr 1e-4, so a group skipped or repeated on either device fails)
    # and held against each device's chain of one-group calls. Chained, the
    # devices' rounding differences grow from step to step: the CPU's chain
    # from the first state with every parameter one ulp up is the witness of
    # that growth, reported after each step beside the card's (PERF.md)
    def update_on(cfg_a, algo_a, algo_cfg, d, start, traj):
        """One ``update`` of ``traj`` on device ``d`` from ``start`` (a state
        dict, Adam's state, head statistics, step); returns the next start."""
        sd, opt_sd, stats, gstep = start
        net_d = build_net(cfg_a, algo_a.env).to(d)
        net_d.load_state_dict(sd)
        algo_d = type(algo_a)(None, net_d, algo_cfg)
        # a copy: load_state_dict keeps tensors already on the device, and
        # the update writes the Adam moments in place
        algo_d.opt.load_state_dict(copy.deepcopy(opt_sd))
        st_d = PPOState(net=net_d, opt=algo_d.opt, env_state=None, obs=None,
                        head_stats={k: v.to(d) if torch.is_tensor(v) else v
                                    for k, v in stats.items()},
                        generator=torch.Generator(device=d).manual_seed(0), global_step=gstep)
        st_d, _ = algo_d.update(st_d, {k: v.to(d) for k, v in traj.items()})
        return ({k: v.detach().cpu() for k, v in net_d.state_dict().items()},
                algo_d.opt.state_dict(), st_d.head_stats, st_d.global_step)

    def state_gap(a, b):
        """(parameters' max abs err, normalizer's max abs err over max(1, |value|))."""
        par = max(float((a[k] - b[k]).abs().max()) for k in a if not k.startswith("norm."))
        nrm = max(float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp(min=1.0))
                  for k in a if k.startswith("norm."))
        return par, nrm

    def nudged(start):
        """``start`` with every parameter one ulp up."""
        sd = {k: torch.nextafter(v, torch.full_like(v, math.inf)) if k in param_keys else v
              for k, v in start[0].items()}
        return (sd,) + start[1:]

    def errs(gaps):
        return [float(f"{x:.3g}") for x in gaps]

    cpu = torch.device("cpu")
    card_vs_cpu = {}
    for setting, (cfg_a, algo_a, state_a, traj) in kept.items():
        vt = isinstance(algo_a, VTrace)
        g = algo_a.vcfg.queue_batch if vt else algo_a.cfg.num_envs
        one = dataclasses.replace(algo_a.vcfg, num_envs=g) if vt else algo_a.cfg
        param_keys = {k for k, _ in algo_a.net.named_parameters()}
        first = ({k: v.detach().cpu() for k, v in algo_a.net.state_dict().items()},
                 algo_a.opt.state_dict(), state_a.head_stats, state_a.global_step)
        start, cpu_chain, ulp_chain = first, first, nudged(first)
        steps, chained, ulp = [], [], []
        for i in range(algo_a.cfg.num_envs // g):
            sub = {k: v[:, i * g:(i + 1) * g] for k, v in traj.items()}
            card_next = update_on(cfg_a, algo_a, one, dev, start, sub)
            cpu_next = update_on(cfg_a, algo_a, one, cpu, start, sub)
            steps.append(state_gap(card_next[0], cpu_next[0]))
            if vt:
                cpu_chain = update_on(cfg_a, algo_a, one, cpu, cpu_chain, sub)
                ulp_chain = update_on(cfg_a, algo_a, one, cpu, ulp_chain, sub)
                chained.append(state_gap(card_next[0], cpu_chain[0]))
                ulp.append(state_gap(ulp_chain[0], cpu_chain[0]))
            start = card_next
        row = {"steps": len(steps), "adam_step_first": state_a.global_step + 1,
               "param_err_per_step": [p for p, _ in steps],
               "norm_rel_err_per_step": [n for _, n in steps]}
        par, nrm = max(row["param_err_per_step"]), max(row["norm_rel_err_per_step"])
        max_err[f"update_step_card_vs_cpu_{setting}"] = {"params": par, "normalizer_rel": nrm}
        print(f"{type(algo_a).__name__} update of phase 22's trajectory ({traj['reward'].numel()} "
              f"samples), each of its {len(steps)} gradient steps (from Adam step "
              f"{state_a.global_step + 1}) from an identical state, card vs CPU [{card}]: "
              f"parameters max abs err {errs(p for p, _ in steps)}, normalizer "
              f"(of max(1, |value|)) {errs(n for _, n in steps)}")
        # a hundredth of a step (lr 1e-4): sums in another order on each device
        check(par <= 1e-6 and nrm <= 1e-6,
              f"{setting} gradient steps card vs CPU: parameters {par:.3g}, normalizer "
              f"{nrm:.3g}, more than 1e-6")
        if vt:
            whole_card = update_on(cfg_a, algo_a, algo_a.vcfg, dev, first, traj)
            whole_cpu = update_on(cfg_a, algo_a, algo_a.vcfg, cpu, first, traj)
            whole = {"card_vs_cpu": state_gap(whole_card[0], whole_cpu[0]),
                     "card_vs_card_chain": state_gap(whole_card[0], start[0]),
                     "cpu_vs_cpu_chain": state_gap(whole_cpu[0], cpu_chain[0])}
            n_groups = algo_a.cfg.num_envs // g
            row.update({
                "chained_param_err_per_step": [p for p, _ in chained],
                "chained_norm_rel_err_per_step": [n for _, n in chained],
                "ulp_chain_param_err_per_step": [p for p, _ in ulp],
                "ulp_chain_norm_rel_err_per_step": [n for _, n in ulp],
                "whole_update": {k: {"params": p, "normalizer_rel": n}
                                 for k, (p, n) in whole.items()},
                "whole_update_global_step": [whole_card[3], whole_cpu[3]]})
            max_err[f"update_whole_card_vs_cpu_{setting}"] = row["whole_update"]["card_vs_cpu"]
            print(f"{type(algo_a).__name__} update, each device's one-group calls chained, gap "
                  f"after each step: card vs CPU: parameters {errs(p for p, _ in chained)}, "
                  f"normalizer {errs(n for _, n in chained)}; CPU from every parameter one ulp "
                  f"up vs CPU: parameters {errs(p for p, _ in ulp)}, normalizer "
                  f"{errs(n for _, n in ulp)}")
            print(f"{type(algo_a).__name__} whole update ({n_groups} groups in one call) "
                  f"[{card}]: " + "; ".join(f"{k} parameters {p:.3g}, normalizer {n:.3g}"
                                             for k, (p, n) in whole.items())
                  + f"; global_step {whole_card[3]} / {whole_cpu[3]}")
            # a fifth of one Adam step at lr 1e-4: a group skipped or repeated fails
            check(all(p <= 2e-5 and n <= 2e-5 for p, n in whole.values())
                  and whole_card[3] == whole_cpu[3] == first[3] + n_groups,
                  f"{setting} whole update: {whole}, global_step {whole_card[3]} / "
                  f"{whole_cpu[3]}, want within 2e-5 and {first[3] + n_groups}")
        card_vs_cpu[setting] = row
    del kept, algo_a, state_a, traj

    # ---- 24. recurrent PPO: the LSTM trunk at the DPPO preset ----------------------------
    cfg_r = build("deepmimic_dppo_pfpn", particles=35, seed=seed)
    cfg_r = dataclasses.replace(cfg_r, network=dataclasses.replace(cfg_r.network, lstm=128))
    params0 = initial_params(cfg_r)

    def keep_rollout(self, args, out):
        last["traj"] = out[1]
        last["net"] = {k: v.clone() for k, v in self.net.state_dict().items()}

    for k in ("rollout_s", "update_s"):
        timing[k].clear()
    kernel_calls.clear()
    linalg.launches = sl.launches = 0
    rec_root = os.path.join(work.name, "train_lstm")
    with megastep_links_on(), wrapped(RecurrentPPO, "rollout", "rollout_s", keep_rollout), \
            wrapped(RecurrentPPO, "update", "update_s"), \
            mock.patch.object(ms.Megastep, "kernel", recording_kernel):
        t0 = time.time()
        algo_r, state_r = train(cfg_r, root=rec_root, max_rounds=1, device=dev)
        torch.cuda.synchronize()
        rec_wall = time.time() - t0
    rec_counts, rec_batches = path_counts(algo_r.env), sorted(set(kernel_calls))
    rec_losses = round_losses(cfg_r, rec_root)
    rollout_s, update_s = sum(timing["rollout_s"]), sum(timing["update_s"])
    moved = [k for k, p in algo_r.net.named_parameters() if torch.equal(p.detach(), params0[k])]
    # the update's recomputation from the stored first carry, with the
    # parameters and normalizer the rollout acted with
    traj = last["traj"]
    net_s = build_net(cfg_r, algo_r.env).to(dev)
    net_s.load_state_dict(last["net"])
    done = traj["done"]
    reset = torch.cat([torch.zeros_like(done[:1]), done[:-1]], 0)
    with torch.no_grad():
        lp_s, v_s, _ = net_s.sequence_outputs(traj["obs"], traj["action"], traj["carry0"], reset)
    rec_err = {"log_prob": float((lp_s - traj["log_prob"]).abs().max()),
               "value": float((v_s - traj["value"]).abs().max())}
    max_err["recurrent_recompute"] = rec_err
    ckpt_r = CheckpointManager(cfg_r.checkpoint_dir(rec_root))
    fresh = build_algo(cfg_r, dev)            # PFPN_MEGASTEP_LINKS off: the default variant
    restored = ckpt_r.restore_latest(fresh.init_state(torch.Generator(device=dev).manual_seed(1)))
    same_carry = restored is not None and all(
        torch.equal(a, b) for a, b in zip(restored.carry, state_r.carry))
    zero_counts(fresh.env)
    linalg.launches = sl.launches = 0
    t0 = time.time()
    out_r = fresh.evaluate(num_episodes=3, max_steps=600,
                           generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    rec_eval_s = time.time() - t0
    rec_eval_counts = path_counts(fresh.env)
    rec_frames = out_r["frames"].cpu().tolist()
    recurrent = {"wall_s": rec_wall, "round_s": rollout_s + update_s, "rollout_s": rollout_s,
                 "update_s": update_s, "rollout_ms_per_env_step": rollout_s * 1e3 / 512,
                 "update_ms_per_minibatch": update_s * 1e3 / max(state_r.global_step, 1),
                 "samples_per_s": state_r.total_samples / (rollout_s + update_s),
                 "launches": rec_counts, "kernel_batches": rec_batches,
                 "global_step": state_r.global_step, "total_samples": state_r.total_samples,
                 "losses": rec_losses, "recompute_err": rec_err, "eval_s": rec_eval_s,
                 "eval_returns": out_r["reward"].cpu().tolist(), "eval_frames": rec_frames,
                 "eval_launches": rec_eval_counts, "episode_ends": int(done.sum())}
    print(f"training recurrent PPO (deepmimic_dppo_pfpn, LSTM 128), 1 round of 8 envs x 512 "
          f"steps through train() [{card}]: {rec_wall:.1f} s; round {recurrent['round_s']:.2f} s "
          f"= rollout {rollout_s:.2f} s ({recurrent['rollout_ms_per_env_step']:.2f} ms per env "
          f"step) + update {update_s:.2f} s ({state_r.global_step} minibatches of one 512-step "
          f"stream, {recurrent['update_ms_per_minibatch']:.1f} ms each); "
          f"{recurrent['samples_per_s']:.1f} samples/s; launches {rec_counts} at {rec_batches}; "
          f"global_step {state_r.global_step}, total_samples {state_r.total_samples}; losses "
          f"{json.dumps(rec_losses)}")
    print(f"recurrent PPO: the recomputation from the stored first carry against the rollout "
          f"({int(done.sum())} episode ends): {json.dumps(rec_err)}; evaluation of the "
          f"restored checkpoint, 3 episodes in {rec_eval_s:.1f} s: returns "
          f"{[round(x, 2) for x in recurrent['eval_returns']]}, frames {rec_frames}, launches "
          f"{rec_eval_counts}")
    check(rec_counts == {"megastep": 0, "megastep_emit_links": 512, "spd_inverse": 0,
                         "substep_lin": 0} and rec_batches == [(8, True)],
          f"recurrent training: launches {rec_counts} at {rec_batches}, want 512 of emit_links "
          "at B=8 and nothing else")
    check(state_r.global_step == 8 and state_r.total_samples == 4096,
          f"recurrent training: global_step {state_r.global_step}, total_samples "
          f"{state_r.total_samples}")
    check(all(len(v) == 1 and all(math.isfinite(x) for x in v) for v in rec_losses.values()),
          f"recurrent training: losses not finite or not logged: {rec_losses}")
    check(not moved, f"recurrent training: parameters that did not move: {moved}")
    check(max(rec_err.values()) <= 1e-4,
          f"recurrent training: recomputation from carry0 {rec_err}, more than 1e-4")
    check(same_carry and same_state(algo_r, fresh),
          "recurrent training: the checkpoint does not restore the carry, parameters, "
          "normalizer and Adam state")
    check(bool(torch.isfinite(out_r["reward"]).all())
          and rec_eval_counts == {"megastep": max(rec_frames), "megastep_emit_links": 0,
                                  "spd_inverse": 0, "substep_lin": 0},
          f"recurrent evaluation: launches {rec_eval_counts} for frames {rec_frames}")
    del algo_r, state_r, fresh, restored, net_s, traj

    # ---- 25. value normalization on the A3C preset ----------------------------------------
    cfg_v = build("deepmimic_a3c_pfpn", particles=35, seed=seed)
    cfg_v = dataclasses.replace(cfg_v, network=dataclasses.replace(
        cfg_v.network, normalize_value=True, clip_value=5.0))

    def keep_vnorm(self, args, out):
        last["vnorm"] = (args[0].vnorm, out[0].vnorm)

    for k in ("rollout_s", "update_s"):
        timing[k].clear()
    kernel_calls.clear()
    linalg.launches = sl.launches = 0
    with megastep_links_on(), tempfile.TemporaryDirectory() as root_v, \
            wrapped(PPO, "rollout", "rollout_s"), wrapped(PPO, "update", "update_s", keep_vnorm), \
            mock.patch.object(ms.Megastep, "kernel", recording_kernel):
        algo_v, state_v = train(cfg_v, root=root_v, max_rounds=1, device=dev)
        torch.cuda.synchronize()
        vn_losses = round_losses(cfg_v, root_v)
    vn_counts, vn_batches = path_counts(algo_v.env), sorted(set(kernel_calls))
    vn_before, vn_after = last["vnorm"]
    with torch.no_grad():
        raw = algo_v.net.raw_value(state_v.obs)      # a fixed raw critic output
    v_before = vnorm_mod.denormalize(vn_before, raw)
    v_after = vnorm_mod.denormalize(vn_after, raw)
    vn_rel = float((v_after - v_before).abs().max() / v_before.abs().max().clamp(min=1.0))
    max_err["value_norm_invariant"] = vn_rel
    value_norm = {"launches": vn_counts, "kernel_batches": vn_batches,
                  "round_s": sum(timing["rollout_s"]) + sum(timing["update_s"]),
                  "global_step": state_v.global_step, "losses": vn_losses,
                  "vnorm": {k: float(v) for k, v in vn_after._asdict().items()},
                  "invariant_rel": vn_rel}
    print(f"value normalization (deepmimic_a3c_pfpn, normalize_value, clip_value 5), 1 round "
          f"[{card}]: {value_norm['round_s']:.2f} s; value normalizer after it "
          f"{json.dumps(value_norm['vnorm'])}; the raw critic outputs of the last observations "
          f"denormalize before and after its update to within {vn_rel:.3g} (relative); "
          f"launches {vn_counts} at {vn_batches}; losses {json.dumps(vn_losses)}")
    check(vn_counts == {"megastep": 0, "megastep_emit_links": 32, "spd_inverse": 0,
                        "substep_lin": 0} and vn_batches == [(16, True)],
          f"value normalization: launches {vn_counts} at {vn_batches}")
    check(state_v.global_step == 1 and all(
        len(v) == 1 and all(math.isfinite(x) for x in v) for v in vn_losses.values()),
          f"value normalization: global_step {state_v.global_step}, losses {vn_losses}")
    check(float(vn_after.mean) != 0.0 and float(vn_after.std) != 1.0,
          f"value normalization: the normalizer did not move: {value_norm['vnorm']}")
    check(vn_rel <= 1e-5, f"value normalization: denormalized outputs moved by {vn_rel:.3g} "
                          "across the update, more than 1e-5")
    del algo_v, state_v
    torch.cuda.empty_cache()

    # ---- 16. evaluation through the CLI, and the export --------------------------------
    from pfpn_torch.harness import eval as eval_mod
    from pfpn_torch.tools import export_policy

    eval_algos = []

    def capturing_build_algo(*args, **kwargs):
        eval_algos.append(build_algo(*args, **kwargs))
        zero_counts(eval_algos[-1].env)
        return eval_algos[-1]

    linalg.launches = sl.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    with mock.patch.object(eval_mod, "build_algo", capturing_build_algo):
        traj_path, traj_ret = cli.main(
            ["--env", "DeepMimicWalk-v0", "--setting", "deepmimic_dppo_pfpn", "--particles", "35",
             "--seed", str(seed), "--root", root])
    torch.cuda.synchronize()
    eval_s = time.time() - t0
    eval_counts = path_counts(eval_algos[0].env)
    with np.load(traj_path) as z:
        shapes = {k: list(z[k].shape) for k in z.files}
        traj_finite = bool(np.isfinite(z["link_pos"]).all() and np.isfinite(z["link_quat"]).all())
    algo_c = build_algo(cfg, dev)
    ckpt.restore_latest(algo_c.init_state(torch.Generator(device=dev).manual_seed(seed)))

    def eval3(a):
        out = a.evaluate(num_episodes=3, max_steps=600,
                         generator=torch.Generator(device=dev).manual_seed(seed))
        return out["reward"].cpu().numpy()

    ev_ret = eval3(algo_c)
    eval_rel = float(np.max(np.abs(traj_ret - ev_ret) / np.abs(ev_ret)))
    print(f"evaluation through the CLI (no --train) of phase 13's checkpoint [{card}]: "
          f"{eval_s:.1f} s; trajectory {json.dumps(shapes)}; returns {traj_ret.tolist()}, "
          f"PPO.evaluate from the same start states {ev_ret.tolist()} (largest relative gap "
          f"{eval_rel:.3g}); launches {eval_counts}")
    check(shapes.get("link_pos") == [600, 3, 15, 3] and shapes.get("link_quat") == [600, 3, 15, 4]
          and shapes.get("done") == [600, 3] and "link_names" in shapes and traj_finite,
          f"evaluation: trajectory {shapes}, finite {traj_finite}")
    check(eval_rel <= 1e-4, f"evaluation: returns {eval_rel:.3g} from evaluate's, more than 1e-4")
    check(eval_counts == {"megastep": 600, "megastep_emit_links": 0, "spd_inverse": 0,
                          "substep_lin": 0}, f"evaluation: launches {eval_counts}")

    # the same checkpoint exported from a scratch working directory, played back
    # against the checkpoint's own play with its parameters at the npz's fp16
    policies = sorted(os.listdir("results/policies"))
    with tempfile.TemporaryDirectory() as cwd_tmp, contextlib.chdir(cwd_tmp):
        npz_path = os.path.abspath(export_policy.main(
            ["--env", "DeepMimicWalk-v0", "--setting", "deepmimic_dppo_pfpn", "--particles",
             "35", "--seed", str(seed), "--root", root]))
        check(npz_path.endswith(f"results/policies/DeepMimicWalk-v0_deepmimic_dppo_pfpn"
                                f"_particle35_{seed}_step32.npz"), f"export: {npz_path}")
        algo_x = build_algo(cfg, dev)
        load_policy(algo_x, npz_path)
        x_ret = eval3(algo_x)
    check(sorted(os.listdir("results/policies")) == policies,
          "export: the repository's results/policies/ changed")
    with torch.no_grad():
        for p in algo_c.net.parameters():
            p.copy_(p.half().float())
    same_npz = all(torch.equal(a, b) for a, b in zip(algo_c.net.state_dict().values(),
                                                     algo_x.net.state_dict().values()))
    c16_ret = eval3(algo_c)
    export_rel = float(np.max(np.abs(x_ret - c16_ret) / np.abs(c16_ret)))
    print(f"export of the checkpoint, {os.path.basename(npz_path)}, played back: returns "
          f"{x_ret.tolist()} against "
          f"the checkpoint's play at the npz's fp16 parameters {c16_ret.tolist()} (largest "
          f"relative gap {export_rel:.3g}) and at its own fp32 ones {ev_ret.tolist()}")
    check(same_npz, "export: the npz does not load the checkpoint's fp16 parameters")
    check(export_rel <= 1e-4, f"export: returns {export_rel:.3g} from the checkpoint's play")
    del algo_c, algo_x, eval_algos

    # ---- 21. evaluation through the CLI of the SAC checkpoint, and its export -----------
    eval_algos = []
    linalg.launches = sl.launches = 0
    sac_args = ["--env", "DeepMimicWalk-v0", "--setting", "deepmimic_sac_pfpn", "--particles",
                "35", "--seed", str(seed), "--env_multiplier", "16", "--root", sac_root]
    torch.cuda.synchronize()
    t0 = time.time()
    with mock.patch.object(eval_mod, "build_algo", capturing_build_algo):
        _, sac_traj_ret = cli.main(sac_args)
    torch.cuda.synchronize()
    sac_eval_s = time.time() - t0
    sac_eval_counts = path_counts(eval_algos[0].env)
    algo_c = build_algo(sac_cfg, dev)
    ckpt_s.restore_latest(algo_c.init_state(torch.Generator(device=dev).manual_seed(seed)))
    sac_ev_ret = eval3(algo_c)
    sac_eval_rel = float(np.max(np.abs(sac_traj_ret - sac_ev_ret) / np.abs(sac_ev_ret)))
    print(f"evaluation through the CLI (no --train) of phase 19's SAC checkpoint [{card}]: "
          f"{sac_eval_s:.1f} s; returns {sac_traj_ret.tolist()}, SAC.evaluate from the same "
          f"start states {sac_ev_ret.tolist()} (largest relative gap {sac_eval_rel:.3g}); "
          f"launches {sac_eval_counts}")
    check(sac_eval_rel <= 1e-4, f"SAC evaluation: returns {sac_eval_rel:.3g} from evaluate's")
    check(sac_eval_counts == {"megastep": 600, "megastep_emit_links": 0, "spd_inverse": 0,
                              "substep_lin": 0}, f"SAC evaluation: launches {sac_eval_counts}")
    with tempfile.TemporaryDirectory() as cwd_tmp, contextlib.chdir(cwd_tmp):
        npz_path = os.path.abspath(export_policy.main(sac_args))
        with np.load(npz_path) as z:
            tops = sorted({k.split("/")[1] for k in z.files if k.startswith("params/")})
        check(tops == ["actor_trunk", "head", "log_alpha", "q1", "q2"],
              f"SAC export: params {tops}")
        algo_x = build_algo(sac_cfg, dev)
        load_policy(algo_x, npz_path)
        x_ret = eval3(algo_x)
    check(sorted(os.listdir("results/policies")) == policies,
          "SAC export: the repository's results/policies/ changed")
    with torch.no_grad():
        for p in algo_c.net.parameters():
            p.copy_(p.half().float())
    same_npz = all(torch.equal(a, b) for a, b in zip(algo_c.net.state_dict().values(),
                                                     algo_x.net.state_dict().values()))
    c16_ret = eval3(algo_c)
    sac_export_rel = float(np.max(np.abs(x_ret - c16_ret) / np.abs(c16_ret)))
    print(f"export of the SAC checkpoint, {os.path.basename(npz_path)} (params {tops}), played "
          f"back: returns {x_ret.tolist()} against the checkpoint's play at the npz's fp16 "
          f"parameters {c16_ret.tolist()} (largest relative gap {sac_export_rel:.3g})")
    check(same_npz, "SAC export: the npz does not load the checkpoint's fp16 parameters")
    check(sac_export_rel <= 1e-4, f"SAC export: returns {sac_export_rel:.3g} from the "
                                  "checkpoint's play")
    del algo_c, algo_x, eval_algos

    # ---- 27. the gym adapter on the card -------------------------------------------------
    gym = phase_gym(dev, card, path_counts, zero_counts)

    # ---- 28. data-parallel training --------------------------------------------------------
    data_parallel = phase_data_parallel(dev, card, work.name, counts, reset_counts, cuda_ms)

    # ---- 29. profiling ----------------------------------------------------------------------
    profiling = phase_profiling(dev, card, work.name)

    # ---- 10, joined ----------------------------------------------------------------------
    side_s = time.time() - t_side
    off_rc = off_proc.wait(timeout=1500)
    off_log.seek(0)
    print(off_log.read(), end="")
    off_log.close()
    check(off_rc == 0, f"play, megastep off: the second process exited with {off_rc}")
    with open(off_path) as fh:
        off = json.load(fh)
    ret_off, off_counts, play_off_s = off["return_mean"], off["launches"], off["wall_s"]
    steps_off, mid_rel = off["env_steps"], off["mid_rel"]
    print(f"play, megastep off: 10 deterministic Walk episodes of {PLAY_OFF_STEPS} steps in "
          f"{play_off_s:.1f} s, in a second process beside phases 14-16, 18-25 and 27-29 "
          f"({side_s:.1f} s): "
          f"return mean {ret_off:.2f} min {off['return_min']:.2f} max {off['return_max']:.2f} "
          f"(JAX {JAX_PLAY_RETURN}); at step {PLAY_CHECK_STEP} mean {off['mid_off']:.2f} against "
          f"the megastep play's {off['mid_on']:.2f}, largest per-episode gap "
          f"{off['mid_gap']:.3f} ({mid_rel:.3%} of that episode's); {steps_off} env steps, "
          f"launches {off_counts}")
    check(off["finite"], "play, megastep off: return not finite")
    check(off_counts == {"megastep": 0, "megastep_emit_links": 0, "spd_inverse": 0,
                         "substep_lin": meta.frame_skip * steps_off},
          f"play, megastep off: launches {off_counts} for {steps_off} env steps")
    check(steps_off == PLAY_OFF_STEPS, f"play, megastep off: {steps_off} env steps")
    # control steps of the two paths agree to 2e-4 in positions (phase 9): over
    # 300 steps the returns, ~290, agree to a few hundredths
    check(mid_rel <= 0.01,
          f"play, megastep off: an episode's return at step {PLAY_CHECK_STEP} is "
          f"{mid_rel:.3%} from the megastep play's, more than 1%")
    check(abs(ret_off - JAX_PLAY_RETURN) <= 0.05 * JAX_PLAY_RETURN,
          f"play, megastep off: return {ret_off:.2f}, more than 5% from {JAX_PLAY_RETURN}")
    work.cleanup()

    # ---- 17. MultiTask throughput at B=8192 ----------------------------------------------
    mt = make("DeepMimicMultiTask-v0", device=dev)
    g = torch.Generator(device=dev).manual_seed(21)
    mstate = {"s": mt.reset_batch(BIG_B, g)[0]}

    def mt_step():
        a = torch.rand(BIG_B, mt.action_size, generator=g, device=dev) * 0.4 - 0.2
        mstate["s"] = mt.step_autoreset(mstate["s"], a, g)[0]

    zero_counts(mt)
    mt_ms = cuda_ms(mt_step, warm=2, reps=n_steps)
    mt_counts = path_counts(mt)
    timing["kernel_events"].clear()
    with mock.patch.object(ms.Megastep, "kernel", timed_kernel):
        mt_step()
    torch.cuda.synchronize()
    mt_kernel_ms = [e0.elapsed_time(e1) for e0, e1 in timing["kernel_events"]]
    mt_sps = BIG_B / (mt_ms / 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            mt_step()
        torch.cuda.synchronize()
    mt_profile = profile_summary(prof, 2)
    if mt_profile["device_time"]:
        print(f"MultiTask step_autoreset, 2 steps at B={BIG_B} under torch.profiler [{card}]: "
              f"window {mt_profile['window_ms']:.2f} ms, device busy "
              f"{mt_profile['busy_ms']:.2f} ms ({mt_profile['busy_share']:.1%}), "
              f"{mt_profile['kernels_per_step']:.0f} kernel launches per env step")
        for row in mt_profile["top"]:
            print(f"  {row['ms']:9.3f} ms  {row['calls']:6d} calls  {row['kernel']}")
    print(f"step_autoreset MultiTask B={BIG_B} (slices {mt._sizes(BIG_B)}), random actions in "
          f"+-0.2 [{card}]: {mt_sps:.0f} env steps/s ({mt_ms:.2f} ms per step; the three "
          f"megastep launches {[round(x, 3) for x in mt_kernel_ms]} ms) against Walk's "
          f"{sps:.0f} ({step_ms:.2f} ms, megastep {kernel_ms:.3f} ms) in phase 5; launches "
          f"{mt_counts} for {2 + n_steps} steps")
    check(mt_counts == {"megastep": 3 * (2 + n_steps), "megastep_emit_links": 0,
                        "spd_inverse": 0, "substep_lin": 0}, f"MultiTask: launches {mt_counts}")
    check(all(bool(torch.isfinite(getattr(mstate["s"].sim, k)).all()) for k in pos + vel),
          "MultiTask step_autoreset: state not finite")
    del mt, mstate
    clocks = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"after the task phases: clocks.sm, power.draw, temperature: {clocks}")

    # ---- report -------------------------------------------------------------
    kernels = [{
        "name": "megastep",
        "route": "cuda",
        "source": "pfpn_torch/csrc/megastep.cu",
        "replaces": "pfpn_tpu/ops/megastep.py:278",
        "tpu_kernel": "pfpn_tpu/ops/megastep.py:_make_kernel",
        "launches": (launches + train_counts["megastep_emit_links"]
                     + sum(r["launches"]["megastep"] for r in task_plays.values())
                     + sum(r["launches"]["megastep_emit_links"] for r in new_rounds.values())
                     + eval_counts["megastep"] + sac_play_counts["megastep"]
                     + sac_train["launches"]["megastep_emit_links"]
                     + sum(r["launches"]["megastep_emit_links"] for r in other_rounds.values())
                     + sac_eval_counts["megastep"]
                     + sum(r["launches"]["megastep_emit_links"] for r in async_rounds.values())
                     + recurrent["launches"]["megastep_emit_links"]
                     + recurrent["eval_launches"]["megastep"]
                     + value_norm["launches"]["megastep_emit_links"]
                     + gym["launches"]["megastep"]
                     + data_parallel["launches"]["megastep_emit_links"]
                     + profiling["launches"]["megastep_emit_links"]),
        "launches_by_variant": {
            "default": {"play": launches, "eval_cli": eval_counts["megastep"],
                        **{f"play_{k}": r["launches"]["megastep"]
                           for k, r in task_plays.items()},
                        "play_sac": sac_play_counts["megastep"],
                        "eval_cli_sac": sac_eval_counts["megastep"],
                        "eval_recurrent_lstm128": recurrent["eval_launches"]["megastep"],
                        "gym_adapter_play": gym["launches"]["megastep"]},
            "emit_links": {"train": train_counts["megastep_emit_links"],
                           **{f"train_{k}": r["launches"]["megastep_emit_links"]
                              for k, r in new_rounds.items()},
                           "train_deepmimic_sac_pfpn_mult16":
                               sac_train["launches"]["megastep_emit_links"],
                           **{f"train_{k}_mult8": r["launches"]["megastep_emit_links"]
                              for k, r in other_rounds.items()},
                           **{f"train_{k}": r["launches"]["megastep_emit_links"]
                              for k, r in async_rounds.items()},
                           "train_recurrent_lstm128":
                               recurrent["launches"]["megastep_emit_links"],
                           "train_deepmimic_a3c_pfpn_normalize_value":
                               value_norm["launches"]["megastep_emit_links"],
                           "train_data_parallel_nccl_world1":
                               data_parallel["launches"]["megastep_emit_links"],
                           "profiling_rollout_step":
                               profiling["launches"]["megastep_emit_links"]}},
        "max_abs_err": max(v for k, v in e1.items() if k != "flags"),
        "max_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "default_ms_in_turns": def_t[0], "default_ms_in_turns_spread": def_t[1:],
        "links_ms": links_t[0], "links_ms_spread": links_t[1:],
        "links_plain_ms": epi_t[0], "links_plain_ms_spread": epi_t[1:],
        "links_plain": "link_states(fk(.)), the epilogue the variant replaces",
        "links_bound_ms": links_bound_ms, "links_bound_by": links_bound_by,
        "variants_at_training_batch": variant_t[8],
        "default_threads": default_threads,
        "threads_sweep_ms": {f"B{B}_{variant}_{th}": t for (B, variant, th), t in sweep.items()},
        "ptxas": ptxas,
        "train_profile": train_profile,
        "links_max_abs_err": max(e12.values()),
        "links_max_abs_err_training_batch": max(e8_links.values()),
        "train": train_stats,
        "batch": BIG_B,
        "build_s": build_s,
        "env_steps_per_s": sps,
        "policy_env_steps_per_s": psps,
        "play_return_mean": float(rew.mean()),
        "task_plays": task_plays,
        "train_new_presets": new_rounds,
        "eval_cli": {"s": eval_s, "returns": traj_ret.tolist(), "evaluate": ev_ret.tolist(),
                     "rel": eval_rel, "export_rel": export_rel},
        "multitask_env_steps_per_s": mt_sps, "multitask_step_ms": mt_ms,
        "multitask_megastep_ms": mt_kernel_ms, "multitask_profile": mt_profile,
        "sac_play": sac_play, "sac_train_mult16": sac_train,
        "off_policy_rounds_mult8": other_rounds,
        "sac_eval_cli": {"s": sac_eval_s, "returns": sac_traj_ret.tolist(),
                         "evaluate": sac_ev_ret.tolist(), "rel": sac_eval_rel,
                         "export_rel": sac_export_rel},
        "a3c_impala_rounds": async_rounds, "update_steps_card_vs_cpu": card_vs_cpu,
        "recurrent_lstm128": recurrent,
        "value_norm": value_norm,
        "gym_adapter": gym,
        "data_parallel": data_parallel,
        "profiling": profiling,
    }, {
        "name": "spd_inverse",
        "route": "cuda",
        "source": "pfpn_torch/csrc/spd_inverse.cu",
        "replaces": "pfpn_tpu/ops/linalg.py:32",
        "tpu_kernel": "pfpn_tpu/ops/linalg.py:_spd_inverse_kernel",
        "launches": (log_counts["spd_inverse"] + tq_counts["spd_inverse"]
                     + fast_dyn["launches"]["torque_step"]["spd_inverse"]),
        "launches_by_path": {"step_log": log_counts["spd_inverse"],
                             "torque_step_autoreset": tq_counts["spd_inverse"],
                             "torque_step_fast_dynamics":
                                 fast_dyn["launches"]["torque_step"]["spd_inverse"]},
        "max_abs_err": spd_abs,
        "ms": spd_ms,
        "plain_ms": spd_plain_ms,
        "bound_ms": spd_bound_ms,
        "bound_by": spd_bound_by,
        "library_ms": spd_lib_ms,
        "library": "torch.linalg.cholesky_ex + torch.cholesky_inverse",
        "ms_spread": spd_t[1:], "plain_ms_spread": spd_plain_t[1:],
        "library_ms_spread": spd_lib_t[1:],
        "single_ms": spd1_t[0], "single_ms_spread": spd1_t[1:], "single_matrices": BIG_B,
        "threads_per_matrix": spd_group,
        "ptxas": ptxas_new["spd_inverse_warp_kernel"],
        "batch": BIG_B,
        "matrices": n_mat,
        "build_s": build_time["spd_inverse"],
        "step_log_ms": log_ms,
        "torque_env_steps_per_s": tq_sps,
    }, {
        "name": "substep_lin",
        "route": "cuda",
        "source": "pfpn_torch/csrc/substep_lin.cu",
        "replaces": "pfpn_tpu/ops/substep_lin.py:136",
        "tpu_kernel": "pfpn_tpu/ops/substep_lin.py:_make_kernel",
        "launches": off_counts["substep_lin"] + fast_dyn["launches"]["substep"]["substep_lin"],
        "launches_by_path": {"play_megastep_off": off_counts["substep_lin"],
                             "substep_fast_dynamics":
                                 fast_dyn["launches"]["substep"]["substep_lin"]},
        "max_abs_err": core_abs,
        "ms": core_ms,
        "plain_ms": core_plain_ms,
        "bound_ms": core_bound_ms,
        "bound_by": core_bound_by,
        "library_ms": None,
        "ms_spread": core_t[1:], "plain_ms_spread": core_plain_t[1:],
        "threads_per_env": core_threads,
        "ptxas": ptxas_new["substep_lin_warps_kernel"],
        "batch": BIG_B,
        "build_s": build_time["substep_lin"],
        "play_megastep_off_return_mean": ret_off,
        "play_megastep_off_steps": PLAY_OFF_STEPS,
        "play_at_check_step": {"step": PLAY_CHECK_STEP, "megastep_off": off["mid_off"],
                               "megastep": off["mid_on"], "largest_rel_gap": mid_rel},
        "play_megastep_off_s": play_off_s,
        "play_megastep_off_beside": "phases 14-16, 18-25 and 27-29, in a second process",
        "megastep_off_substep_split": split,
        "fast_dynamics": fast_dyn,
    }]
    print(f"chip_smoke: {time.time() - run_t0:.1f} s in all, of which the megastep-off "
          f"play {play_off_s:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--megastep-off-play"]:
        megastep_off_play(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--dp-rank"]:
        dp_rank_main(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6])
    else:
        main()
