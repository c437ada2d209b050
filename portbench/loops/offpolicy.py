"""The off-policy loop: rounds of env steps, each followed by its gradient
steps on a replay ring (SAC's ``train_round``), one round after another.

The configuration's ``algorithm`` names the module (``algos/<name>.py``)
that builds the port's algorithm, checks it against the configuration and
says what each judged gradient step leaves for the reference. Set-up
builds it and its state (``init_state``: the envs reset, an empty ring at
its full capacity), gives it the configuration's ``.npz`` weights through
the port's loader, sets the targets to the loaded critics
(``sync_target``: ``init_state`` set them to the random initialization),
and drives its first rounds through the same ``train_round`` the window
calls. Of those rounds the check keeps every env transition (by the ring
slot it goes to), the checked env steps (half of them before the first
gradient step, whose weights both sides share exactly, judged as one
record; the other half after it, a second record whose policy is not
compared), and what the module's watch leaves of the judged gradient
steps. The window then runs whole rounds and ends at the first round end
at or after ``--seconds``; its gradient steps are read from the program's
counter (``SAC.grad_steps``). With ``--trace 1`` a stretch of
``trace_env_steps`` env steps (a ``train_round`` of that many steps, each
with its gradient steps) is profiled after the window, each gradient step
inside the benchmark's ``record_function("portbench.update_step")``; the
device ms of each such region, its backward's kernels included, is the
span ``update_step_device``.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

from .. import judge
from ..counts import physics
from ..trace import REGION_PREFIX


def _device_ms_by_region(prof, name: str):
    """Device ms of each ``record_function`` region ``name``: the device
    operations launched inside the region's time span, on any thread. A
    device operation's launch is the CUDA API call with its correlation id
    (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaGraphLaunch``, a
    copy), else the host operator it is linked to. ``trace.from_profiler``'s
    ``regions`` follow the linked operator on the region's own thread
    only, which misses a backward on autograd's thread and a CUDA graph's
    replay."""
    from torch.autograd import DeviceType

    marks, launched, op_start, device_ops = [], {}, {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not (e.name().startswith(REGION_PREFIX) or e.is_user_annotation()):
                device_ops.append((e.correlation_id(), e.linked_correlation_id(),
                                   (e.end_ns() - e.start_ns()) / 1e3))
            continue
        if e.name() == name:
            marks.append((e.start_ns(), e.end_ns()))
        if e.name().startswith("cu"):           # the CUDA API's calls
            launched[e.correlation_id()] = e.start_ns()
        elif e.linked_correlation_id() == 0 and not e.is_async():
            op_start[e.correlation_id()] = e.start_ns()
    marks.sort()
    starts = [a for a, _ in marks]
    out = [0.0] * len(marks)
    for cid, link, us in device_ops:
        t = launched.get(cid, op_start.get(link))
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= marks[i][1]:
            out[i] += us / 1e3
    return out


def run(r):
    import torch

    from .. import algos, program
    from ..reference import env as ref_env_mod

    cfg, tr, dev = r.config, r.traffic, r.device
    mod = algos.load(cfg["algorithm"])
    links = bool(cfg.get("megastep_links", False))
    r.mark("the port imported")
    algo = mod.build(cfg, tr, dev)
    r.mark("algorithm built")
    c = algo.cfg
    B, T = c.num_envs, c.steps_per_round
    n_setup = int(tr["setup_rounds"])
    sync = (torch.cuda.synchronize if dev.type == "cuda" else (lambda: None))
    if c.buffer_capacity < n_setup * T * B:
        raise ValueError("the ring wraps in the set-up rounds; the check maps a slot to the "
                         "one transition it holds")

    w0 = {k: v.detach().clone() for k, v in mod.reference_net(cfg, dev).state_dict().items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(r.seed)
    state = algo.init_state(gen)
    program.load_weights(algo.net, cfg, dev, w0)
    algo.sync_target()
    r.mark("weights loaded, envs reset")
    r.hook("built", algo=algo)

    # the set-up rounds' gradient steps, by the ring's gate
    gated = [t for t in range(n_setup * T) if B * (t + 1) >= c.batch_size + c.warmup]
    first = gated[0] if gated else n_setup * T
    n_updates = len(gated) * c.updates_per_step
    judged = set(range(min(mod.JUDGED, n_updates))) | set(
        range(max(0, n_updates - mod.JUDGED), n_updates))

    # checked env steps: half where the weights are the first ones (up to and
    # including the env step after which the first gradient step runs)
    pick = torch.Generator()
    pick.manual_seed(r.seed)
    n_check = int(tr["check_steps"])
    pre = torch.randperm(min(first + 1, n_setup * T), generator=pick)[:n_check // 2]
    rest = n_setup * T - first - 1
    post = first + 1 + torch.randperm(max(rest, 0), generator=pick)[:n_check - len(pre)]
    check_at = set(pre.tolist()) | set(post.tolist())

    cap = {"on": True, "step": 0, "obs": state.obs, "explore": False, "transitions": [],
           "full": {}}
    rec = mod.watch(algo, state.buffer, lambda: cap["on"], judged)
    env = algo.env
    orig_step, orig_explore, orig_sample = env.step_autoreset, algo._explore_action, algo._sample

    def sample(obs, draws):
        out = orig_sample(obs, draws)
        if cap["explore"]:
            cap["drawn"] = out
        return out

    def explore(obs, ou, generator):
        if not cap["on"]:
            return orig_explore(obs, ou, generator)
        cap["explore"] = True
        try:
            out = orig_explore(obs, ou, generator)
        finally:
            cap["explore"] = False
        if cap["step"] in check_at:
            cap["policy"] = mod.checked_policy(algo, obs, cap["drawn"])
        return out

    def step_autoreset(states, actions, generator=None):
        out = orig_step(states, actions, generator)
        if cap["on"]:
            _, next_obs, res = out
            cap["transitions"].append({
                "obs": cap["obs"].clone(), "action": actions.clone(),
                "reward": res.reward.clone(), "not_terminal": 1.0 - res.terminated.float(),
                "next_obs": res.obs.clone()})
            if cap["step"] in check_at:
                cap["full"][cap["step"]] = (states, cap["obs"], actions, cap.pop("policy"), out)
            cap["obs"] = next_obs
            cap["step"] += 1
        return out

    env.step_autoreset, algo._explore_action, algo._sample = step_autoreset, explore, sample

    for k in range(n_setup):
        state, out = algo.train_round(state)
        r.mark(f"set-up round {k + 1} done")
    cap["on"] = False
    setup_grad_steps = algo.grad_steps
    sync()
    r.setup_done()

    g0, e0 = algo.grad_steps, algo.env_steps
    t0 = time.perf_counter()
    rounds = 0
    while True:
        state, out = algo.train_round(state)
        rounds += 1
        if time.perf_counter() - t0 >= r.seconds:
            break
    sync()
    seconds = time.perf_counter() - t0
    grad_steps, env_steps = algo.grad_steps - g0, algo.env_steps - e0
    r.note(f"rounds in the window: {rounds}, seconds {seconds:.4f}, env steps {env_steps}, "
           f"gradient steps {grad_steps}, last loss {out['loss']}")

    mega = env.engine.mega
    counter = "launches_links" if links else "launches"
    trace, spans = None, {}
    if r.trace:
        from .. import trace as trace_mod

        acts = torch.profiler.ProfilerActivity
        kinds = [acts.CPU, acts.CUDA] if dev.type == "cuda" else [acts.CPU]
        n_tr = int(tr["trace_env_steps"])
        launches0, grad0 = getattr(mega, counter), algo.grad_steps
        full_cfg, update_step = algo.cfg, algo._update_step

        def marked(*args):
            with torch.profiler.record_function("portbench.update_step"):
                return update_step(*args)

        algo.cfg, algo._update_step = dataclasses.replace(full_cfg, steps_per_round=n_tr), marked
        try:
            with torch.profiler.profile(activities=kinds) as prof:
                state, out = algo.train_round(state)
                sync()
        finally:
            algo.cfg, algo._update_step = full_cfg, update_step
        t_read = time.perf_counter()
        trace = trace_mod.from_profiler(prof, n_tr)
        spans["update_step_device"] = _device_ms_by_region(prof, "portbench.update_step")
        r.note(f"{'emit_links' if links else 'default'} launches counted by the port over "
               f"the traced stretch: {getattr(mega, counter) - launches0}, kernels in the "
               f"trace: {len(trace.kernels_named('megastep_kernel'))}; gradient steps "
               f"{algo.grad_steps - grad0}; trace read in {time.perf_counter() - t_read:.1f} s")

    # what the check keeps: the checked env steps, the transitions by slot,
    # the judged gradient steps
    by_key = {}
    for s in sorted(cap["full"]):
        pre_state, obs, clipped, (action, log_prob, value), (ns, no, res) = cap["full"][s]
        rows = judge.check_rows(B, int(tr["check_rows"]), res.done, pick)
        by_key.setdefault(int(s > first), []).append(judge.record(
            rows, pre_state, obs, action, clipped, log_prob, value, res, ns, no))
    records = [(k, judge.concat(recs)) for k, recs in sorted(by_key.items())]
    ring = {k: torch.cat([t[k] for t in cap["transitions"]]).cpu()
            for k in cap["transitions"][0]}
    trail = rec["trail"]
    lead = [e for j, e in enumerate(trail[:mod.STEPS]) if e["gstep"] == j]
    names = [k for k, _ in algo.net.named_parameters()]
    updates = {"w0": w0, "names": names, "trail": trail, "transitions": ring,
               "judged": sorted(judged), "grad_steps": setup_grad_steps,
               "expected_grad_steps": n_updates,
               "losses": [e["loss"] for e in lead],
               "grad1": lead[0]["grad"] if lead else {n: torch.zeros_like(w0[n]) for n in names},
               "params": ({n: lead[-1]["after"]["state"][n] for n in names}
                          if len(lead) == mod.STEPS else None)}
    del cap, state, algo, env, mega, orig_step, orig_explore, orig_sample, out, rec

    meta = physics.meta_of(ref_env_mod.make(cfg["env"]))
    phys = physics.flops_per_env(meta, emit_links=links)
    flops = (env_steps * B * (phys + mod.behaviour_flops(cfg))
             + grad_steps * mod.update_flops(cfg, c))
    window = {"rounds": rounds, "seconds": seconds, "env_steps": env_steps,
              "grad_steps": grad_steps, "flops": flops}
    counts = {"megastep_flops_per_launch": phys * B,
              "megastep_bytes_per_launch": physics.bytes_per_launch(meta, B, emit_links=links)}
    e2e = {"samples_per_s": rounds * B * T / seconds}
    return dict(e2e=e2e, window=window, trace=trace, spans=spans, counts=counts,
                records=records, updates=updates)
