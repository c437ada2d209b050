"""The acting loop: a closed loop over a batch of envs, policy in the loop.

Each step calls the port's ``ActorCritic.act`` (a PFPN sample, its
log-prob and the value, drawn from a device generator seeded by
``--seed``), clips the action to the env's bounds, then calls
``DeepMimicEnv.step_autoreset``: ``bench.py:95-133``'s ``measure_policy``
of the JAX package, written against the port. The window's end-to-end
numbers: env steps per second over the window, ended by a synchronize, and
the 95th percentile of the interval between consecutive steps' ends, read
from CUDA events recorded on the stream after each step.
"""

from __future__ import annotations

import contextlib
import time

from .. import judge, stats
from ..counts import physics, policy


def run(r):
    import torch

    from .. import program
    from ..reference import env as ref_env_mod

    cfg, tr, dev = r.config, r.traffic, r.device
    B = int(tr["num_envs"])
    r.mark("the port imported")
    env, net = program.build_act(cfg, tr, dev)
    r.mark("env and net built, weights loaded")
    r.hook("built", env=env, net=net)
    gen = torch.Generator(device=dev)
    gen.manual_seed(r.seed)
    pick = torch.Generator()
    pick.manual_seed(r.seed)
    check_at = set(torch.randperm(int(tr["check_step_range"]), generator=pick)
                   [:int(tr["check_steps"])].tolist())
    low = torch.as_tensor(env.action_low, device=dev)
    high = torch.as_tensor(env.action_high, device=dev)

    def step(state, obs, region: bool = False):
        ctx = (torch.profiler.record_function("portbench.act") if region
               else contextlib.nullcontext())
        with ctx:
            a, lp, v, _ = net.act(obs, gen)
        ac = torch.clamp(a, low, high)
        new_state, new_obs, res = env.step_autoreset(state, ac, gen)
        return (state, obs, a, ac, lp, v, res, new_state, new_obs)

    sync = (torch.cuda.synchronize if dev.type == "cuda" else (lambda: None))
    timed = dev.type == "cuda"
    kept = {}
    with torch.no_grad():
        state, obs = env.reset_batch(B, gen)
        r.mark("envs reset")
        for _ in range(int(tr["warmup_steps"])):
            out = step(state, obs)
            state, obs = out[7], out[8]
        sync()
        r.setup_done()

        ends = []
        if timed:
            start_ev = torch.cuda.Event(enable_timing=True)
            start_ev.record()
        t0 = time.perf_counter()
        n, last = 0, None
        while True:
            last = step(state, obs)
            if n in check_at:
                kept[n] = last
            if timed:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                ends.append(ev)
            else:       # the CPU (the tests): every operation has ended here
                ends.append((time.perf_counter() - t0) * 1e3)
            state, obs = last[7], last[8]
            n += 1
            if time.perf_counter() - t0 >= r.seconds:
                break
        sync()
        seconds = time.perf_counter() - t0
        kept[n - 1] = last

        trace = None
        if r.trace:
            from .. import trace as trace_mod

            acts = torch.profiler.ProfilerActivity
            kinds = [acts.CPU, acts.CUDA] if dev.type == "cuda" else [acts.CPU]
            launches0 = env.engine.mega.launches
            k = int(tr["trace_steps"])
            with torch.profiler.profile(activities=kinds) as prof:
                for _ in range(k):
                    out = step(state, obs, region=True)
                    state, obs = out[7], out[8]
                sync()
            trace = trace_mod.from_profiler(prof, k)
            r.note(f"megastep launches counted by the port over the traced "
                   f"stretch: {env.engine.mega.launches - launches0}, kernels "
                   f"in the trace: {len(trace.kernels_named('megastep_kernel'))}")

    cum = [start_ev.elapsed_time(e) for e in ends] if timed else ends
    intervals = stats.intervals(cum)
    r.note(f"steps in the window: {n}, seconds {seconds:.4f}")

    records = []
    for i in sorted(kept):
        pre, pobs, a, ac, lp, v, res, ns, no = kept[i]
        rows = judge.check_rows(B, int(tr["check_rows"]), res.done, pick)
        records.append((None, judge.record(rows, pre, pobs, a, ac, lp, v, res, ns, no)))
    del kept, last, state, obs, env, net, out

    meta = physics.meta_of(ref_env_mod.make(cfg["env"]))
    phys = physics.flops_per_env(meta)
    pol = policy.act_flops(cfg)
    window = {"steps": n, "seconds": seconds, "flops": n * B * (phys + pol)}
    e2e = {"env_steps_per_s": B * n / seconds,
           "step_ms_p95": stats.percentile(intervals, 95)}
    counts = {"megastep_flops_per_launch": phys * B,
              "megastep_bytes_per_launch": physics.bytes_per_launch(meta, B),
              "policy_flops_per_env_step": pol}
    return dict(e2e=e2e, window=window, trace=trace, spans={}, counts=counts,
                records=records, updates=None)
