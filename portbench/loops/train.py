"""The training loop: rounds of the port's algorithm, one after another.

The configuration's ``algorithm`` names the module (``algos/<name>.py``)
that builds the port's algorithm and checks it against the configuration,
and says what each set-up update leaves for the reference. Any algorithm
whose rounds are ``train_round = rollout + update`` runs here (A2C, PPO).
Set-up builds it and its state (``init_state``), gives it the
configuration's weights (``"seeded"``: the reference's initialization,
drawn on the card from the seed; else the ``.npz``, through the port's
loader), and drives its first rounds through the same ``train_round`` the
window calls; their rollouts, each optimizer step's loss, the Adam state
after the first step, the parameters after the module's compared steps and
(where the module judges each step) its trail are kept for the check; the
checked env steps of one round are judged as one record. The window then runs whole rounds (rollout of
``unroll_length`` steps, the update, metrics read to the host) and ends at
the first round end at or after ``--seconds``. With ``--trace 1`` the
rollout and the update are timed by spans around the instance's bound
methods, each ending in a synchronize, and one more round is profiled after
the window. The megastep's variant, its counts and its launch counter are
the configuration's (``megastep_links``).
"""

from __future__ import annotations

import time

from .. import judge
from ..counts import physics, policy


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
    B, T = algo.cfg.num_envs, algo.cfg.unroll_length
    update_flops = mod.update_flops(cfg, algo.cfg)
    n_setup = int(tr["setup_rounds"])
    sync = (torch.cuda.synchronize if dev.type == "cuda" else (lambda: None))

    # weights: the reference's, as the configuration states them
    w0 = {k: v.detach().clone()
          for k, v in mod.reference_net(cfg, dev, seed=r.seed).state_dict().items()}

    gen = torch.Generator(device=dev)
    gen.manual_seed(r.seed)
    state = algo.init_state(gen)
    program.load_weights(algo.net, cfg, dev, w0)
    r.mark("weights loaded, envs reset")
    r.hook("built", algo=algo)

    # checked steps: one of the first round, whose weights both sides share
    # exactly (the policy is compared there), the others from later rounds;
    # with one set-up round, all from it
    pick = torch.Generator()
    pick.manual_seed(r.seed)
    n_check = int(tr["check_steps"])
    if n_setup == 1:
        check_at = {(0, t) for t in torch.randperm(T, generator=pick)[:n_check].tolist()}
    else:
        first = int(torch.randint(T, (1,), generator=pick))
        later = torch.randperm((n_setup - 1) * T, generator=pick)[:n_check - 1]
        check_at = {(0, first)} | {(1 + i // T, i % T) for i in later.tolist()}

    cap = {"on": True, "round": 0, "step": 0, "next_obs": [], "full": {}, "trajs": []}
    spans = {"rollout": [], "update": []}
    span_on = {"on": False}
    rec = mod.watch(algo, lambda: cap["on"])
    env = algo.env
    orig_step, orig_rollout, orig_update = env.step_autoreset, algo.rollout, algo.update

    def step_autoreset(states, actions, generator=None):
        out = orig_step(states, actions, generator)
        if cap["on"]:
            cap["next_obs"].append(out[2].obs)
            if (cap["round"], cap["step"]) in check_at:
                cap["full"][(cap["round"], cap["step"])] = (states, actions, out)
            cap["step"] += 1
        return out

    def timed(name, fn):
        def wrapper(*args):
            if not span_on["on"]:
                return fn(*args)
            t0 = time.perf_counter()
            out = fn(*args)
            sync()
            spans[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    timed_rollout, timed_update = timed("rollout", orig_rollout), timed("update", orig_update)

    def rollout(st):
        out = timed_rollout(st)
        if cap["on"]:
            cap["trajs"].append(out[1])
        return out

    env.step_autoreset, algo.rollout, algo.update = step_autoreset, rollout, timed_update

    names = [k for k, _ in algo.net.named_parameters()]
    for k in range(n_setup):
        cap["round"], cap["step"] = k, 0
        state, out = algo.train_round(state)
        r.mark(f"set-up round {k + 1} done")
    cap["on"] = False
    sync()
    r.setup_done()

    span_on["on"] = bool(r.trace)
    t0 = time.perf_counter()
    rounds = 0
    while True:
        state, out = algo.train_round(state)
        rounds += 1
        if time.perf_counter() - t0 >= r.seconds:
            break
    sync()
    seconds = time.perf_counter() - t0
    r.note(f"rounds in the window: {rounds}, seconds {seconds:.4f}, last loss {out['loss']}")

    mega = env.engine.mega
    counter = "launches_links" if links else "launches"
    trace = None
    if r.trace:
        from .. import trace as trace_mod

        acts = torch.profiler.ProfilerActivity
        kinds = [acts.CPU, acts.CUDA] if dev.type == "cuda" else [acts.CPU]
        launches0 = getattr(mega, counter)
        n_tr = int(tr["trace_rounds"])
        span_on["on"] = False
        with torch.profiler.profile(activities=kinds) as prof:
            for _ in range(n_tr):
                state, out = algo.train_round(state)
            sync()
        t_read = time.perf_counter()
        trace = trace_mod.from_profiler(prof, n_tr * T)
        r.note(f"{'emit_links' if links else 'default'} launches counted by the port over "
               f"the traced stretch: {getattr(mega, counter) - launches0}, kernels in the "
               f"trace: {len(trace.kernels_named('megastep_kernel'))}; trace read in "
               f"{time.perf_counter() - t_read:.1f} s")

    # what the check keeps: the setup rounds' data, the checked rows
    rounds_data = []
    for k, traj in enumerate(cap["trajs"]):
        nxt = torch.stack(cap["next_obs"][k * T:(k + 1) * T])
        rounds_data.append({"obs": traj["obs"], "action": traj["action"],
                            "reward": traj["reward"], "terminated": traj["terminated"],
                            "done": traj["done"], "next_obs": nxt})
    by_round = {}
    for (k, t) in sorted(cap["full"]):
        pre, clipped, (ns, no, res) = cap["full"][(k, t)]
        traj = cap["trajs"][k]
        rows = judge.check_rows(B, int(tr["check_rows"]), res.done, pick)
        by_round.setdefault(k, []).append(judge.record(
            rows, pre, traj["obs"][t], traj["action"][t], clipped, traj["log_prob"][t],
            traj["value"][t], res, ns, no))
    records = [(k, judge.concat(recs)) for k, recs in sorted(by_round.items())]
    updates = {"w0": w0, "rounds": rounds_data, "before": rec["before"],
               "losses": [float(x) for x in rec["losses"]], "grad1": rec["grad1"],
               "params": rec["params"], "trail": rec["trail"], "names": names}
    del cap, state, algo, env, mega, orig_step, orig_rollout, orig_update, out

    meta = physics.meta_of(ref_env_mod.make(cfg["env"]))
    phys = physics.flops_per_env(meta, emit_links=links)
    per_round = B * T * (phys + policy.rollout_step_flops(cfg)) + update_flops
    window = {"rounds": rounds, "seconds": seconds, "unroll": T, "flops": rounds * per_round}
    counts = {"megastep_flops_per_launch": phys * B,
              "megastep_bytes_per_launch": physics.bytes_per_launch(meta, B, emit_links=links)}
    e2e = {"samples_per_s": rounds * B * T / seconds}
    return dict(e2e=e2e, window=window, trace=trace, spans=spans, counts=counts,
                records=records, updates=updates)
