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
   (B=16), and the share of envs past the bounds at B=1024; then one env
   step through the kernel against the plain path on the CPU;
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
   steps within 5% of the JAX package's 578.53;
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
   an identical state and trajectory on the card and on the CPU.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

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
PLAY_OFF_STEPS = 600   # phase 10: the whole play; launch-bound, ~0.7 s per step
PLAY_CHECK_STEP = 300  # phase 10: the step at which both plays' returns are compared
JAX_PLAY_RETURN = 578.53   # tools/export_policy.py --play, JAX on the CPU (PERF.md)
FP32_PEAK = 67e12      # H100 SXM fp32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12     # H100 SXM device memory, bytes/s
BIG_B = 8192
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

    # ---- 10. the megastep-off path: play ---------------------------------------------
    acting_engine = algo.env.engine
    algo.env.engine = Engine(tree, dataclasses.replace(acting_engine.config, megastep=False),
                             acting_engine.gains)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    rec_off = ReturnRecorder(algo.env.step_batch)
    with mock.patch.object(algo.env, "step_batch", rec_off):
        res_off = play(NPZ, episodes=10, max_steps=PLAY_OFF_STEPS, seed=0, algo=algo)
    torch.cuda.synchronize()
    play_off_s = time.time() - t0
    off_counts = counts()
    algo.env.engine = acting_engine
    rew_off = res_off["reward"].cpu()
    steps_off = int(res_off["frames"].max())
    ret_off = float(rew_off.mean())
    # both plays at PLAY_CHECK_STEP: the same start states (seed 0), phase 4's
    # megastep play and this one
    on_mid, off_mid = rec_on.returns_at(PLAY_CHECK_STEP), rec_off.returns_at(PLAY_CHECK_STEP)
    mid_gap = (off_mid - on_mid).abs()
    mid_rel = float((mid_gap / on_mid.abs()).max())
    print(f"play, megastep off: 10 deterministic Walk episodes of {PLAY_OFF_STEPS} steps in "
          f"{play_off_s:.1f} s: return mean {ret_off:.2f} min {float(rew_off.min()):.2f} max "
          f"{float(rew_off.max()):.2f} (JAX {JAX_PLAY_RETURN}); at step {PLAY_CHECK_STEP} "
          f"mean {float(off_mid.mean()):.2f} against the megastep play's "
          f"{float(on_mid.mean()):.2f}, largest per-episode gap {float(mid_gap.max()):.3f} "
          f"({mid_rel:.3%} of that episode's); {steps_off} env steps, launches {off_counts}")
    check(bool(torch.isfinite(rew_off).all()), "play, megastep off: return not finite")
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
    with megastep_links_on(), tempfile.TemporaryDirectory() as root, \
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

    # ---- report -------------------------------------------------------------
    kernels = [{
        "name": "megastep",
        "route": "cuda",
        "source": "pfpn_torch/csrc/megastep.cu",
        "replaces": "pfpn_tpu/ops/megastep.py:278",
        "tpu_kernel": "pfpn_tpu/ops/megastep.py:_make_kernel",
        "launches": launches + train_counts["megastep_emit_links"],
        "launches_by_variant": {"default": {"play": launches},
                                "emit_links": {"train": train_counts["megastep_emit_links"]}},
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
    }, {
        "name": "spd_inverse",
        "route": "cuda",
        "source": "pfpn_torch/csrc/spd_inverse.cu",
        "replaces": "pfpn_tpu/ops/linalg.py:32",
        "tpu_kernel": "pfpn_tpu/ops/linalg.py:_spd_inverse_kernel",
        "launches": log_counts["spd_inverse"] + tq_counts["spd_inverse"],
        "launches_by_path": {"step_log": log_counts["spd_inverse"],
                             "torque_step_autoreset": tq_counts["spd_inverse"]},
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
        "launches": off_counts["substep_lin"],
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
        "play_at_check_step": {"step": PLAY_CHECK_STEP, "megastep_off": float(off_mid.mean()),
                               "megastep": float(on_mid.mean()), "largest_rel_gap": mid_rel},
        "play_megastep_off_s": play_off_s,
        "megastep_off_substep_split": split,
    }]
    print(f"chip_smoke: {time.time() - run_t0:.1f} s in all, of which the megastep-off "
          f"play {play_off_s:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    main()
