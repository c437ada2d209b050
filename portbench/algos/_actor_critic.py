"""What the algorithms on PPO's machinery share: the reference's PFPN
actor-critic and the watch over the port's set-up updates."""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def reference_net(cfg: Dict, device, state: Optional[Dict] = None,
                  seed: Optional[int] = None):
    """The reference actor-critic of ``cfg``: with ``state``; else with the
    configuration's ``.npz`` weights read by the reference's own loader, or,
    where the weights are ``"seeded"``, a fresh run's initialization drawn
    on ``device`` from ``seed``."""
    import numpy as np
    import torch

    from ..reference.policy import ActorCritic, state_dict_from_npz

    net = ActorCritic(cfg["obs_dim"], cfg["action_dim"], cfg["particles"],
                      cfg["actor_shape"], cfg["critic_shape"], cfg["clip_state"]).to(device)
    if state is None:
        if cfg["weights"] == "seeded":
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            net.init_parameters(gen)
            return net
        with np.load(os.path.join(ROOT, cfg["weights"])) as z:
            state = state_dict_from_npz({k: z[k] for k in z.files})
    net.load_state_dict({k: v.to(device) for k, v in state.items()})
    return net


def watch(algo, on: Callable[[], bool], steps: int, before: Optional[Callable] = None,
          trail: bool = False) -> Dict:
    """Wraps ``algo``'s minibatch loss, optimizer step and update. While
    ``on()``: each loss is kept (``losses``), the clipped gradient of the
    first optimizer step is read from Adam's first moment after it
    (``grad1``: exp_avg / (1 - b1)), the parameters are kept after the
    ``steps``-th step (``params``), and ``before(algo, state)`` runs ahead
    of each update (``before``). With ``trail``, each update also leaves a
    host snapshot of the network and Adam's moments ahead of each step
    (with its loss, its sample count and the clipped gradient as Adam
    takes it) and one after the update (``reference/ppo.py``'s
    ``snapshot``; ``trail``)."""
    import torch

    from ..reference.ppo import snapshot

    rec = {"losses": [], "grad1": None, "before": [], "params": None, "steps": 0,
           "trail": []}
    loss_fn, opt_step, update = algo._loss, algo.opt.step, algo.update
    adam_step = algo.opt.adam.step

    def loss(batch, *args, **kw):
        out = loss_fn(batch, *args, **kw)
        if on():
            rec["losses"].append(out[0].detach())
            if trail:
                rec["trail"][-1]["steps"].append(dict(
                    snapshot(algo.net, algo.opt.adam), loss=float(out[0].detach()),
                    samples=int(batch["advantage"].shape[0])))
        return out

    def step():
        opt_step()
        if not on():
            return
        rec["steps"] += 1
        if rec["grad1"] is None:
            adam = algo.opt.adam
            rec["grad1"] = {n: (adam.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                                / (1.0 - 0.9)).detach().clone()
                            for n, p in algo.net.named_parameters()}
        if rec["steps"] == steps:
            rec["params"] = {n: p.detach().clone() for n, p in algo.net.named_parameters()}

    def watched_adam_step(*args, **kw):
        if on() and trail and rec["trail"][-1]["steps"]:
            rec["trail"][-1]["steps"][-1]["grad"] = {
                n: p.grad.detach().to("cpu", copy=True)
                for n, p in algo.net.named_parameters() if p.grad is not None}
        return adam_step(*args, **kw)

    def watched_update(state, traj):
        if not on():
            return update(state, traj)
        if before is not None:
            rec["before"].append(before(algo, state))
        if trail:
            rec["trail"].append({"steps": [], "end": None})
        out = update(state, traj)
        if trail:
            rec["trail"][-1]["end"] = snapshot(algo.net, algo.opt.adam)
        return out

    algo._loss, algo.opt.step, algo.update = loss, step, watched_update
    algo.opt.adam.step = watched_adam_step
    return rec


def unchanged(upd: Dict) -> Dict:
    """``upd`` as the watch would have left it had every optimizer step
    returned the state unchanged: the parameters and every snapshot of the
    trail at the first weights, Adam's moments never set, no gradient
    reaching Adam."""
    import torch

    w0 = upd["w0"]
    frozen = {"state": {k: v.detach().to("cpu", copy=True) for k, v in w0.items()},
              "adam": {}}
    return dict(upd, params={n: w0[n] for n in upd["names"]},
                grad1={n: torch.zeros_like(g) for n, g in upd["grad1"].items()},
                trail=[{"steps": [dict(s, grad={}, **frozen) for s in r["steps"]],
                        "end": frozen}
                       for r in upd.get("trail", [])])
