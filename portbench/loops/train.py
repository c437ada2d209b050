"""The training loop: A2C rounds of the port, one after another.

Set-up builds the port's algorithm (``harness.build.build_algo``) and state
(``init_state``), gives it weights drawn on the card from the seed by the
reference's initialization, and drives its first rounds through the same
``train_round`` the window calls; their rollouts, losses, the Adam state
after the first step and the parameters after the third are kept for the
check. The window then runs whole rounds (rollout of ``unroll_length``
steps, GAE, one gradient step, metrics read to the host) and ends at the
first round end at or after ``--seconds``. With ``--trace 1`` the rollout
and the update are timed by spans around the instance's bound methods,
each ending in a synchronize, and one more round is profiled after the
window.
"""

from __future__ import annotations

import time

from .. import judge
from ..counts import physics, policy


def run(r):
    import torch

    from .. import program
    from ..reference import env as ref_env_mod
    from ..reference.policy import ActorCritic as RefAC

    cfg, tr, dev = r.config, r.traffic, r.device
    r.mark("the port imported")
    algo = program.build_train(cfg, tr, dev)
    r.mark("algorithm built")
    B, T = algo.cfg.num_envs, algo.cfg.unroll_length
    n_setup = int(tr["setup_rounds"])
    sync = (torch.cuda.synchronize if dev.type == "cuda" else (lambda: None))

    # weights: a fresh run's initialization, drawn on the card from the seed
    wgen = torch.Generator(device=dev)
    wgen.manual_seed(r.seed)
    init = RefAC(cfg["obs_dim"], cfg["action_dim"], cfg["particles"],
                 cfg["actor_shape"], cfg["critic_shape"], cfg["clip_state"]).to(dev)
    init.init_parameters(wgen)
    w0 = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init

    gen = torch.Generator(device=dev)
    gen.manual_seed(r.seed)
    state = algo.init_state(gen)
    algo.net.load_state_dict(w0)
    r.mark("weights drawn, envs reset")
    r.hook("built", algo=algo)

    # checked steps: one of the first round, whose weights both sides share
    # exactly (the policy is compared there), the others from later rounds
    pick = torch.Generator()
    pick.manual_seed(r.seed)
    first = int(torch.randint(T, (1,), generator=pick))
    later = torch.randperm((n_setup - 1) * T, generator=pick)[:int(tr["check_steps"]) - 1]
    check_at = {(0, first)} | {(1 + i // T, i % T) for i in later.tolist()}

    cap = {"on": True, "round": 0, "step": 0, "next_obs": [], "full": {}, "trajs": []}
    spans = {"rollout": [], "update": []}
    span_on = {"on": False}
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
    losses, grad1, params3 = [], None, None
    for k in range(n_setup):
        cap["round"], cap["step"] = k, 0
        state, out = algo.train_round(state)
        losses.append(out["loss"])
        r.mark(f"set-up round {k + 1} done")
        if k == 0:
            adam = algo.opt.adam
            grad1 = {n: (adam.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                         / (1.0 - 0.9)).detach().clone()
                     for n, p in algo.net.named_parameters()}
    params3 = {n: p.detach().clone() for n, p in algo.net.named_parameters()}
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

    trace = None
    if r.trace:
        from .. import trace as trace_mod

        acts = torch.profiler.ProfilerActivity
        kinds = [acts.CPU, acts.CUDA] if dev.type == "cuda" else [acts.CPU]
        launches0 = env.engine.mega.launches_links
        n_tr = int(tr["trace_rounds"])
        span_on["on"] = False
        with torch.profiler.profile(activities=kinds) as prof:
            for _ in range(n_tr):
                state, out = algo.train_round(state)
            sync()
        trace = trace_mod.from_profiler(prof, n_tr * T)
        r.note(f"emit_links launches counted by the port over the traced "
               f"stretch: {env.engine.mega.launches_links - launches0}, kernels "
               f"in the trace: {len(trace.kernels_named('megastep_kernel'))}")

    # what the check keeps: the setup rounds' data, the checked rows
    rounds_data = []
    for k, traj in enumerate(cap["trajs"]):
        nxt = torch.stack(cap["next_obs"][k * T:(k + 1) * T])
        rounds_data.append({"obs": traj["obs"], "action": traj["action"],
                            "reward": traj["reward"], "terminated": traj["terminated"],
                            "done": traj["done"], "next_obs": nxt})
    records = []
    for (k, t) in sorted(cap["full"]):
        pre, clipped, (ns, no, res) = cap["full"][(k, t)]
        traj = cap["trajs"][k]
        rows = judge.check_rows(B, int(tr["check_rows"]), res.done, pick)
        records.append((k, judge.record(rows, pre, traj["obs"][t], traj["action"][t],
                                        clipped, traj["log_prob"][t], traj["value"][t],
                                        res, ns, no)))
    updates = {"w0": w0, "rounds": rounds_data, "losses": losses, "grad1": grad1,
               "params3": params3, "names": names}
    del cap, state, algo, env, orig_step, orig_rollout, orig_update, out

    meta = physics.meta_of(ref_env_mod.make(cfg["env"]))
    phys = physics.flops_per_env(meta, emit_links=True)
    per_round = B * T * (phys + policy.rollout_step_flops(cfg)
                         + policy.update_flops_per_sample(cfg))
    window = {"rounds": rounds, "seconds": seconds, "unroll": T, "flops": rounds * per_round}
    counts = {"megastep_flops_per_launch": phys * B,
              "megastep_bytes_per_launch": physics.bytes_per_launch(meta, B, emit_links=True)}
    e2e = {"samples_per_s": rounds * B * T / seconds}
    return dict(e2e=e2e, window=window, trace=trace, spans=spans, counts=counts,
                records=records, updates=updates)
