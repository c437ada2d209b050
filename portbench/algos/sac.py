"""SAC-PFPN: twin critics, Polyak targets, a learned temperature and a
replay ring; the reference is ``reference/sac.py`` and the loop
``loops/offpolicy.py`` (a round is env steps, each followed by its
gradient steps, not a rollout and an update).

What the check judges:

* the checked env steps: the physics, observation, reward and reset
  (``judge.judge_env``), and on the steps before the first gradient step,
  whose weights both sides share exactly, the policy: ``log_prob`` is the
  squashed head's log-density of the taken action, by its pre-tanh value
  (a record's ``action`` holds that value: taken back from the action on
  the bounds through atanh it would lose the digits this compares), and
  ``value`` is min(Q1, Q2) at the middle of the env's bounds
  (``checked_policy``), the critics alone;
* following from the first weights: the first ``STEPS`` gradient steps on
  the port's own batches and draws, their losses, the first step's
  clipped gradient and the parameters' change after them;
* each judged gradient step (the first ``JUDGED`` after the ring's gate
  opens and the last ``JUDGED`` of the set-up rounds) from the port's
  state just before it (parameters, targets, Adam's moments and step, the
  normalizer, ``log_alpha``), on its batch and draws: the critic and actor
  losses (``step_loss_gap``), each group's clipped gradient as Adam takes
  it (``step_grad_gap``) and the change of the parameters, targets and
  normalizer (``step_change_gap``), each Adam group, the targets and the
  normalizer against their own median leaf, as each group is clipped
  apart; ``replay_mismatches``, exactly, counts the drawn rows that differ
  from the transition the env produced for that slot, and
  ``update_mismatches`` how far the port's count of gradient steps departs
  from one per sample once the gate is open (a judged step that never ran
  counts too).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
from typing import Dict, List

from .. import program
from ..counts import policy

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FAULTS = ("targets_frozen", "temperature_frozen", "target_q1_only", "one_clip",
          "ring_off_by_one")
STEPS = 3           # gradient steps followed from the first weights
JUDGED = 8          # judged gradient steps at each end of the set-up rounds


def sizes(cfg: Dict, traffic: Dict) -> Dict[str, int]:
    """Envs (the configuration's workers at the traffic's env multiplier),
    one gradient step per sample, and the batch, round and ring the
    traffic may override."""
    n = cfg["workers"] * int(traffic.get("env_multiplier", 1))
    return {"num_envs": n, "updates_per_step": n,
            **{k: int(traffic.get(k, cfg[k]))
               for k in ("batch_size", "steps_per_round", "buffer_capacity")}}


def build(cfg: Dict, traffic: Dict, device):
    """The preset's SAC through ``program.build_train``, with the batch,
    round and ring the traffic may override, refused where it departs from
    the configuration."""
    algo = program.build_train(cfg, traffic, device)
    s = sizes(cfg, traffic)
    over = {k: s[k] for k in ("batch_size", "steps_per_round", "buffer_capacity") if k in traffic}
    if over:
        algo.cfg = dataclasses.replace(algo.cfg, **over)
    req, c, net = program.require, algo.cfg, algo.net
    req("algorithm", type(algo).__name__, "SAC")
    req("network", type(net).__name__, "SACNet")
    req("algo", c.algo, "sac")
    for key, want in s.items():
        req(key, getattr(c, key), want)
    for key in ("warmup", "tau", "gamma", "lr_actor", "lr_critic", "lr_alpha", "norm_clip",
                "twin_q"):
        req(key, getattr(c, key), cfg[key])
    req("twin critics", [[q.layers[0].in_features] + [layer.out_features for layer in q.layers]
                         for q in (net.q1, net.q2)],
        [[cfg["obs_dim"] + cfg["action_dim"], *cfg["critic_shape"], 1]] * 2)
    req("temperature", net.log_alpha is not None, True)
    req("squashed head", net.cfg.head.squash, True)
    req("normalize_state", net.cfg.normalize_state, True)
    req("resample_interval", net.cfg.head.resample_interval, cfg["resample_interval"])
    return algo


@functools.lru_cache(maxsize=None)
def _bounds(env: str):
    """The env's action bounds, from the reference's own env."""
    from ..reference import env as ref_env_mod

    e = ref_env_mod.make(env)
    return e.action_low.copy(), e.action_high.copy()


def reference_net(cfg: Dict, device, state=None, seed=None):
    """The reference's SAC network of ``cfg``: with ``state``, else with the
    configuration's ``.npz`` by the reference's own loader."""
    import numpy as np

    from ..reference.policy import state_dict_from_npz
    from ..reference.sac import SACNet

    low, high = _bounds(cfg["env"])
    net = SACNet(cfg["obs_dim"], cfg["action_dim"], cfg["particles"], cfg["actor_shape"],
                 cfg["critic_shape"], low, high, cfg["clip_state"]).to(device)
    if state is None:
        with np.load(os.path.join(ROOT, cfg["weights"])) as z:
            state = state_dict_from_npz({k: z[k] for k in z.files})
    net.load_state_dict({k: v.to(device) for k, v in state.items()})
    return net


def settings(cfg: Dict):
    from ..reference.sac import SACSettings

    return SACSettings(gamma=cfg["gamma"], tau=cfg["tau"], lr_actor=cfg["lr_actor"],
                       lr_critic=cfg["lr_critic"], lr_alpha=cfg["lr_alpha"],
                       norm_clip=cfg["norm_clip"])


def checked_policy(algo, obs, drawn):
    """What a checked env step records of the policy, from the port: the
    behaviour draw's pre-tanh value and log-density (``drawn``, what
    ``SAC._sample`` returned for it) and, by the port's own critics,
    min(Q1, Q2) at the middle of the env's bounds (``reference/sac.py``'s
    ``value``: at an action of the actor, the actor's round-off, times the
    critics' slope, would decide the number)."""
    import torch

    from pfpn_torch.networks.heads import denormalize_action

    _, lp, aux = drawn
    net = algo.net
    with torch.no_grad():
        a = denormalize_action(net.cfg.head, torch.zeros_like(aux["pre_tanh"]))
        v = torch.minimum(algo._q_value(net.q1, obs, a), algo._q_value(net.q2, obs, a))
    return aux["pre_tanh"], lp, v


def watch(algo, buffer, on, judged) -> Dict:
    """Wraps the ring's index draw and ``_update_step``. While ``on()``,
    each gradient step whose step count is in ``judged`` leaves an entry of
    ``trail``: its count (``gstep``), the resampling counter, the drawn
    slots, the batch and draws, the state before it and after it
    (``reference/sac.py``'s ``snapshot``, on the host), its critic, actor
    and total losses, and the clipped gradients as Adam took them (the
    gradients the step leaves, eager or replayed from its CUDA graph: Adam
    reads them and leaves them)."""
    from ..reference.sac import snapshot

    rec: Dict = {"trail": []}
    last: Dict = {}
    draw, update_step = buffer.draw_indices, algo._update_step
    cpu = lambda x: x.detach().to("cpu", copy=True)  # noqa: E731

    def draw_indices(batch_size, generator):
        last["idx"] = draw(batch_size, generator)
        return last["idx"]

    def watched(batch, draws, gstep, stats, generator):
        if not (on() and gstep in judged):
            return update_step(batch, draws, gstep, stats, generator)
        before = snapshot(algo.net, algo.target, algo.opt.adam)
        out = update_step(batch, draws, gstep, stats, generator)
        m = out[2]
        rec["trail"].append({
            "gstep": gstep, "train_flag": int(stats.get("train_flag", 0)),
            "idx": cpu(last["idx"]), "batch": {k: cpu(v) for k, v in batch.items()},
            "draws": {k: {kk: cpu(vv) for kk, vv in d.items()} for k, d in draws.items()},
            "before": before, "after": snapshot(algo.net, algo.target, None),
            "critic_loss": float(m["critic_loss"]), "actor_loss": float(m["actor_loss"]),
            "loss": float(m["loss"]),
            "grad": {n: cpu(p.grad) for n, p in algo.net.named_parameters()
                     if p.grad is not None}})
        return out

    buffer.draw_indices, algo._update_step = draw_indices, watched
    return rec


def _on(x, device):
    if isinstance(x, dict):
        return {k: _on(v, device) for k, v in x.items()}
    return x.to(device)


def _batch(entry: Dict, ring: Dict, fault=None) -> Dict:
    """The entry's batch; with ``ring_off_by_one``, the env's transitions
    one slot past the drawn ones."""
    if fault != "ring_off_by_one":
        return entry["batch"]
    n = next(iter(ring.values())).shape[0]
    return {k: v[(entry["idx"] + 1) % n] for k, v in ring.items()}


def _no_resample(cfg: Dict, trail: List[Dict]) -> None:
    for e in trail:
        if e["train_flag"] + 1 >= cfg["resample_interval"]:
            raise RuntimeError(
                f"the port's PFPN resampling counter reads {e['train_flag']} ahead of gradient "
                f"step {e['gstep']} (interval {cfg['resample_interval']}): the reference does "
                "not resample")


def ref_updates(cell, upd: Dict, device, judge_round=None, fault=None) -> Dict:
    """The reference on the port's batches and draws: from ``w0`` (targets
    equal to its critics, a fresh Adam), the first ``STEPS`` steps'
    losses, the first clipped gradients and the parameters after them;
    and each judged step from the port's state ahead of it (``trail``).
    ``judge_round(k, net)`` sees the first weights for each group of
    checked env steps. ``fault`` plants one of ``FAULTS``."""
    from ..reference.sac import FAULTS as STEP_FAULTS, SACReference, snapshot

    cfg = cell.config
    net = reference_net(cfg, device, upd["w0"])
    if judge_round is not None:
        for k in (0, 1):
            judge_round(k, net)
    trail, ring = upd["trail"], upd["transitions"]
    _no_resample(cfg, trail)
    step_fault = fault if fault in STEP_FAULTS else None
    ref = SACReference(net, settings(cfg))
    losses, grad1, params = [], None, None
    for j, e in enumerate(trail[:STEPS]):
        if e["gstep"] != j:
            break
        out = ref.step(_on(_batch(e, ring, fault), device), _on(e["draws"], device), step_fault)
        losses.append(out["loss"])
        grad1 = grad1 or out["grad"]
        if j + 1 == STEPS:
            params = {n: p.detach().clone() for n, p in net.named_parameters()}
    steps = []
    for e in trail:
        ref.load(e["before"], e["gstep"])
        batch = _batch(e, ring, fault)
        out = ref.step(_on(batch, device), _on(e["draws"], device), step_fault)
        steps.append(dict(e, batch=batch, after=snapshot(net, ref.target, None),
                          grad={n: g.cpu() for n, g in out["grad"].items()},
                          **{k: out[k] for k in ("critic_loss", "actor_loss", "loss")}))
    return {"losses": losses, "grad1": grad1, "params": params, "trail": steps}


def unchanged(upd: Dict) -> Dict:
    """``upd`` as the watch would have left it had every gradient step
    returned the state unchanged: the parameters at the first weights, no
    gradient reaching Adam, each judged step's state after it the state
    before it."""
    import torch

    w0 = upd["w0"]
    return dict(upd, params={n: w0[n] for n in upd["names"]},
                grad1={n: torch.zeros_like(w0[n]) for n in upd["names"]},
                trail=[dict(e, after={k: e["before"][k] for k in ("state", "target")},
                            grad={})
                       for e in upd["trail"]])


def _group_gaps(got: Dict, want: Dict, names: List[str], judge) -> tuple:
    """The worst leaf of each group of ``names`` against its own median
    leaf: (gap, leaf)."""
    from ..reference.sac import group_of

    worst = (0.0, None)
    groups: Dict[str, List[str]] = {}
    for n in names:
        key = "target" if n.startswith("target.") else "norm" if n.startswith("norm.") \
            else group_of(n)
        groups.setdefault(key, []).append(n)
    for keep in groups.values():
        worst = max(worst, judge.worst_leaf(got, want, keep), key=lambda w: w[0])
    return worst


def judge_steps(cell, upd: Dict, device) -> Dict[str, float]:
    """Each judged step from the port's state ahead of it: the reference's
    critic and actor losses, clipped gradient and change (the parameters
    that move, by ``judge.moving_leaves`` within each group, every target
    and the normalizer's mean and std) against the port's; and, exactly,
    the drawn rows that differ from the env's transitions at their slots
    and how far the count of gradient steps departs from one per sample."""
    import torch

    from .. import judge
    from ..reference.sac import SACReference, group_of

    cfg = cell.config
    net = reference_net(cfg, device, upd["w0"])
    ref = SACReference(net, settings(cfg))
    ring = upd["transitions"]
    got_l, want_l = [], []
    grad_gap = change_gap = (0.0, None, None)
    replay = 0
    for e in upd["trail"]:
        ref.load(e["before"], e["gstep"])
        out = ref.step(_on(e["batch"], device), _on(e["draws"], device))
        got_l += [e["critic_loss"], e["actor_loss"]]
        want_l += [out["critic_loss"], out["actor_loss"]]
        grads, port_grads = out["grad"], e["grad"] or {}
        got_g = {n: port_grads[n].to(device) if n in port_grads else torch.zeros_like(g)
                 for n, g in grads.items()}
        grad_gap = max(grad_gap, _group_gaps(got_g, grads, list(grads), judge) + (e["gstep"],),
                       key=lambda w: w[0])
        b0, b1 = e["before"], e["after"]
        moving = []
        for key in {group_of(n) for n in grads}:
            part = {n: g for n, g in grads.items() if group_of(n) == key}
            moving += judge.moving_leaves(part)
        now = {"state": ref.net.state_dict(), "target": ref.target.state_dict()}
        got_c, want_c = {}, {}
        for n in moving + ["norm.mean", "norm.std"]:
            got_c[n] = b1["state"][n].to(device) - b0["state"][n].to(device)
            want_c[n] = now["state"][n] - b0["state"][n].to(device)
        for n in b0["target"]:
            got_c["target." + n] = b1["target"][n].to(device) - b0["target"][n].to(device)
            want_c["target." + n] = now["target"][n] - b0["target"][n].to(device)
        change_gap = max(change_gap, _group_gaps(got_c, want_c, list(want_c), judge)
                         + (e["gstep"],), key=lambda w: w[0])
        idx = e["idx"]
        drawn = torch.cat([e["batch"][k].reshape(len(idx), -1) for k in sorted(ring)], 1)
        want_rows = torch.cat([ring[k][idx].reshape(len(idx), -1) for k in sorted(ring)], 1)
        replay += int((drawn != want_rows).any(1).sum())
    missing = len(upd["judged"]) - len(upd["trail"])
    print(f"portbench: each judged step from the port's state: worst gradient {grad_gap}, "
          f"worst change {change_gap} (gap, leaf, step); {len(upd['trail'])} steps judged",
          file=sys.stderr)
    return {"step_loss_gap": judge.loss_gap(got_l, want_l) if got_l else 0.0,
            "step_grad_gap": grad_gap[0], "step_change_gap": change_gap[0],
            "replay_mismatches": float(replay),
            "update_mismatches": float(abs(upd["grad_steps"] - upd["expected_grad_steps"])
                                       + missing)}


def _critic_layers(cfg: Dict):
    sizes_ = [cfg["obs_dim"] + cfg["action_dim"], *cfg["critic_shape"], 1]
    return list(zip(sizes_[:-1], sizes_[1:]))


def _input_backward(layers) -> int:
    """The input's gradient alone through every layer: 2 i o each."""
    return sum(2 * i * o for i, o in layers)


def behaviour_flops(cfg: Dict) -> int:
    """One behaviour action per env: the actor's forward pass."""
    return policy.forward(policy.shapes(cfg)[0])


def update_flops(cfg: Dict, algo_cfg) -> int:
    """One gradient step at the batch: the actor forward twice (the next
    action, the action) and backward once; the target critics forward; the
    online critics forward and backward; the critics held fixed forward,
    and backward to their input."""
    actor, critic = policy.shapes(cfg)[0], _critic_layers(cfg)
    per_sample = (2 * policy.forward(actor) + policy.backward(actor)
                  + 2 * policy.forward(critic)
                  + 2 * (policy.forward(critic) + policy.backward(critic))
                  + 2 * (policy.forward(critic) + _input_backward(critic)))
    return algo_cfg.batch_size * per_sample
