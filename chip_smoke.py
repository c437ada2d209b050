#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``pfpn_torch``) on one card.

Phases, in order; any failure exits non-zero:

1. a CUDA card is required; prints its name and power limit;
2. builds the three kernels (``pfpn_torch/csrc/megastep.cu``,
   ``spd_inverse.cu``, ``substep_lin.cu``) with nvcc for sm_90a, one nvcc
   per source, all started together;
3. holds the megastep kernel against its plain PyTorch version on the card,
   from perturbed reset states: one substep (B=256), one control step
   (B=16), and the share of envs past the bounds at B=1024; then one env
   step through the kernel against the plain path on the CPU;
4. the acting path: plays the shipped DPPO + PFPN-35 Walk policy for 10
   deterministic episodes through ``pfpn_torch.tools.export_policy.play``
   and checks that every env step launched the megastep and nothing else;
5. times the megastep and its plain version at B=8192 and the env step rate
   with random actions and with the policy in the loop (CUDA events);
6. ``spd_inverse_pair`` against its plain version at B=1024, on H from
   perturbed and drop states; times it, the plain version and the library
   yardstick (``torch.linalg.cholesky_ex`` + ``torch.cholesky_inverse``) at
   B=8192, each as the median of five groups of calls, with their spread;
7. ``substep_core`` against its plain version at B=256 on the inputs of
   ``tests/test_fused.py:100-118``; times both at B=8192 as phase 6 does;
8. ``Engine.substep``, kernel path against plain path on the card at B=256,
   in four modes: fused SPD with the megastep off, unfused SPD with
   ``return_torque``, torque and position control;
9. one control step at B=1024, ``Engine.control_step`` with the megastep off
   against the megastep kernel;
10. the megastep-off path: plays the shipped Walk npz with the env's engine
   built with ``EngineConfig(megastep=False)``, 20 ``substep_lin`` launches
   and no megastep launch per env step;
11. the ``spd_inverse`` paths at B=8192: ``step_log`` (20
   ``spd_inverse_pair`` launches per env step) and torque-control
   ``step_autoreset`` under random normalized torques (20 ``spd_inverse``
   launches per step).

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

NPZ = "results/policies/DeepMimicWalk-v0_deepmimic_dppo_pfpn_particle35_34114_step58608.npz"
JAX_PLAY_RETURN = 578.53   # tools/export_policy.py --play, JAX on the CPU (PERF.md)
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


def cuda_ms_spread(fn, warm: int, reps: int, groups: int = 5):
    """(median, min, max) over ``groups`` of cuda_ms(fn, 0, reps), after
    warm calls."""
    times = sorted(cuda_ms(fn, warm if g == 0 else 0, reps) for g in range(groups))
    return times[len(times) // 2], times[0], times[-1]


def spread_text(t) -> str:
    return f"{t[0]:.3f} ms ({t[1]:.3f}-{t[2]:.3f})"


def main():
    import torch

    # ---- 1. the card ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    import pfpn_torch
    from pfpn_torch.envs.deepmimic import make
    from pfpn_torch.harness.settings import build
    from pfpn_torch.ops import linalg
    from pfpn_torch.ops import megastep as ms
    from pfpn_torch.ops import substep_lin as sl
    from pfpn_torch.tools.export_policy import build_algo, load_policy, play

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
            if "ptxas" in line or "error" in line or "warning" in line:
                print(f"  {line.strip()}")
        lib.load()
    build_s = build_time["megastep"]

    def reset_counts():
        for wrapper in counted:
            wrapper.launches = 0

    def counts():
        return {name: wrapper.launches for name, wrapper in zip(
            ("megastep", "spd_inverse", "substep_lin"), counted)}

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
    check(acting_counts["spd_inverse"] == 0 and acting_counts["substep_lin"] == 0,
          f"play: other kernels launched on the megastep path: {acting_counts}")

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
    print(f"spd_inverse_pair B={BIG_B} ({n_mat} matrices) [{card}], median (min-max) "
          f"of 5 groups: kernel {spread_text(spd_t)}, plain {spread_text(spd_plain_t)}, "
          f"cholesky_ex + cholesky_inverse {spread_text(spd_lib_t)}, "
          f"bound {spd_bound_ms:.4f} ms by {spd_bound_by}")
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
    print(f"substep_core B={BIG_B} [{card}], median (min-max) of 5 groups: kernel "
          f"{spread_text(core_t)}, plain {spread_text(core_plain_t)}, "
          f"bound {core_bound_ms:.4f} ms by {core_bound_by}")
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
    res_off = play(NPZ, episodes=10, max_steps=600, seed=0, algo=algo)
    torch.cuda.synchronize()
    play_off_s = time.time() - t0
    off_counts = counts()
    algo.env.engine = acting_engine
    rew_off = res_off["reward"].cpu()
    steps_off = int(res_off["frames"].max())
    ret_off = float(rew_off.mean())
    print(f"play, megastep off: 10 deterministic Walk episodes in {play_off_s:.1f} s: "
          f"return mean {ret_off:.2f} min {float(rew_off.min()):.2f} max "
          f"{float(rew_off.max()):.2f}; {steps_off} env steps, launches {off_counts}")
    check(bool(torch.isfinite(rew_off).all()), "play, megastep off: return not finite")
    check(off_counts == {"megastep": 0, "spd_inverse": 0,
                         "substep_lin": meta.frame_skip * steps_off},
          f"play, megastep off: launches {off_counts} for {steps_off} env steps")
    check(abs(ret_off - JAX_PLAY_RETURN) <= 0.05 * JAX_PLAY_RETURN,
          f"play, megastep off: return {ret_off:.2f} not within 5% of {JAX_PLAY_RETURN}")

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
    check(log_counts == {"megastep": 0, "spd_inverse": 3 * meta.frame_skip,
                         "substep_lin": 0}, f"step_log: launches {log_counts} for 3 steps")
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
    check(tq_counts == {"megastep": 0, "spd_inverse": 3 * meta.frame_skip,
                        "substep_lin": 0}, f"torque control: launches {tq_counts} for 3 steps")
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
        "batch": BIG_B,
        "build_s": build_time["substep_lin"],
        "play_megastep_off_return_mean": ret_off,
        "play_megastep_off_s": play_off_s,
        "megastep_off_substep_split": split,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    main()
