#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``pfpn_torch``) on one card.

Phases, in order; any failure exits non-zero:

1. a CUDA card is required; prints its name and power limit;
2. builds ``pfpn_torch/csrc/megastep.cu`` with nvcc for sm_90a;
3. holds the megastep kernel against its plain PyTorch version on the card,
   from perturbed reset states: one substep (B=256), one control step
   (B=16), and the share of envs past the bounds at B=1024; then one env
   step through the kernel against the plain path on the CPU;
4. the main path: plays the shipped DPPO + PFPN-35 Walk policy for 10
   deterministic episodes through ``pfpn_torch.tools.export_policy.play``
   and checks that every env step launched the kernel;
5. times the kernel and its plain version at B=8192 and the env step rate
   with random actions and with the policy in the loop (CUDA events).

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

NPZ = "results/policies/DeepMimicWalk-v0_deepmimic_dppo_pfpn_particle35_34114_step58608.npz"
FP32_PEAK = 67e12      # H100 SXM fp32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12     # H100 SXM device memory, bytes/s
BIG_B = 8192


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


def main():
    import torch

    # ---- 1. the card ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    import pfpn_torch
    from pfpn_torch.envs.deepmimic import make
    from pfpn_torch.harness.settings import build
    from pfpn_torch.ops import megastep as ms
    from pfpn_torch.tools.export_policy import build_algo, load_policy, play

    dev = pfpn_torch.resolve_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.time()
    path, log = ms.build_library()
    build_s = time.time() - t0
    print(f"build: {path} in {build_s:.1f} s")
    for line in log.splitlines():
        if "ptxas" in line or "error" in line or "warning" in line:
            print(f"  {line.strip()}")
    ms.load_library()

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

    # ---- 4. the main path ---------------------------------------------------
    algo = build_algo(build("deepmimic_dppo_pfpn", particles=35), dev)
    load_policy(algo, NPZ)
    main_mega = algo.env.engine.mega
    main_mega.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    res = play(NPZ, episodes=10, max_steps=600, seed=0, algo=algo)
    torch.cuda.synchronize()
    play_s = time.time() - t0
    launches = main_mega.launches
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

    # ---- 5. times -------------------------------------------------------------
    st, ts, tr = perturbed(BIG_B, 5)
    kernel_ms = cuda_ms(lambda: mega.kernel(st, ts, tr), warm=2, reps=10)
    plain_ms = cuda_ms(lambda: mega.plain(st, ts, tr), warm=1, reps=2)
    flops = ms.megastep_flops(meta) * BIG_B
    nbytes = 4 * BIG_B * (meta.rows_state + 4 * S + NR            # in
                          + meta.rows_state + meta.n_cand + 3 * meta.frame_skip)
    nbytes += ctypes.sizeof(ms.MegaTables)
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"megastep B={BIG_B} [{card}]: kernel {kernel_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms by {bound_by} "
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

    # ---- report -------------------------------------------------------------
    kernels = [{
        "name": "megastep",
        "route": "cuda",
        "source": "pfpn_torch/csrc/megastep.cu",
        "replaces": "pfpn_tpu/ops/megastep.py:278",
        "tpu_kernel": "pfpn_tpu/ops/megastep.py:_make_kernel",
        "launches": launches,
        "max_abs_err": max(v for k, v in e1.items() if k != "flags"),
        "max_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "batch": BIG_B,
        "build_s": build_s,
        "env_steps_per_s": sps,
        "policy_env_steps_per_s": psps,
        "play_return_mean": float(rew.mean()),
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    main()
