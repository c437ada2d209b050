"""DPPO: the clipped surrogate over shuffled minibatches, with normalized
advantages; the reference is ``reference/ppo.py``.

The reference takes the port's permutations as inputs: ahead of each
set-up update the watch replays the port's generator from its state there,
which is the state ``PPO.update``'s ``randperm`` starts from (GAE draws
nothing). PFPN resampling is left out of the reference: ``ref_updates``
raises where the port's optimizer-step counter shows a resample inside the
rounds it follows.

Followed from the first weights, the reference is compared over the first
``STEPS`` steps only (a sample at the clip's edge parts the two sides
later). Every step of the set-up rounds is judged besides from the port's
own state ahead of it (``judge_steps``): the reference takes the port's
parameters, normalizer and Adam moments there (the watch's trail), makes
the step on the same minibatch, and its loss, clipped gradient and change
are compared with the port's; the count of steps and of samples is exact.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict

from .. import program
from ..counts import policy
from . import _actor_critic

FAULTS = ("half_batch", "no_advantage_norm", "half_minibatches")
# the first three optimizer steps' losses and the change after them: later,
# a sample's ratio within round-off of the clip's edge (1 +- epsilon) takes
# its whole gradient in or out on one side only
STEPS = 3
LOSS_AGAINST_MEDIAN = True      # the surrogate's mean is 0 at a round's first step
reference_net = _actor_critic.reference_net
unchanged = _actor_critic.unchanged


def sizes(cfg: Dict, traffic: Dict) -> Dict[str, int]:
    """Envs, unroll and minibatch: the configuration's at the traffic's env
    multiplier, or the traffic's own."""
    mult = int(traffic.get("env_multiplier", 1))
    return {"num_envs": cfg["workers"] * mult,
            "unroll_length": int(traffic.get("unroll_length", cfg["unroll_length"])),
            "minibatch_size": int(traffic.get("minibatch_size", cfg["minibatch_size"] * mult))}


def build(cfg: Dict, traffic: Dict, device):
    """The preset's PPO, with the unroll and minibatch the traffic may
    override."""
    algo = program.build_train(cfg, traffic, device)
    s = sizes(cfg, traffic)
    if "unroll_length" in traffic or "minibatch_size" in traffic:
        algo.cfg = dataclasses.replace(algo.cfg, unroll_length=s["unroll_length"],
                                       minibatch_size=s["minibatch_size"])
    req, c, n = program.require, algo.cfg, algo.net.cfg
    req("algorithm", type(algo).__name__, "PPO")
    for key, want in s.items():
        req(key, getattr(c, key), want)
    req("opt_epochs", c.opt_epochs, cfg["opt_epochs"])
    req("lr_actor", c.lr_actor, cfg["lr_actor"])
    req("lr_critic", c.lr_critic, cfg["lr_critic"])
    req("norm_clip", c.norm_clip, cfg["norm_clip"])
    req("epsilon", c.epsilon, cfg["epsilon"])
    req("entropy_beta", n.entropy_beta, cfg["entropy_beta"])
    req("gamma", n.gamma, cfg["gamma"])
    req("lambd", n.lambd, cfg["lambd"])
    req("value_loss_coef", n.value_loss_coef, cfg["value_loss_coef"])
    req("normalize_advantage", n.normalize_advantage, cfg["normalize_advantage"])
    req("clip_advantage", n.clip_advantage, None)
    req("normalize_state", n.normalize_state, True)
    req("normalize_value", n.normalize_value, False)
    req("resample_interval", n.head.resample_interval, cfg["resample_interval"])
    return algo


def _before(algo, state) -> Dict:
    """The permutations ``PPO.update`` will draw, replayed from a copy of the
    run's generator, and the resampling counter it starts from."""
    import torch

    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    n = algo.cfg.num_envs * algo.cfg.unroll_length
    perms = [torch.randperm(n, generator=gen, device=state.generator.device)
             for _ in range(algo.cfg.opt_epochs)]
    return {"perms": perms, "train_flag": int(state.head_stats.get("train_flag", 0))}


def watch(algo, on):
    return _actor_critic.watch(algo, on, STEPS, _before, trail=True)


def _no_resample(cfg: Dict, before, steps_per_round: int) -> None:
    flags = [b["train_flag"] for b in before]
    for k, f in enumerate(flags):
        if f + steps_per_round >= cfg["resample_interval"] or (
                k and f != flags[k - 1] + steps_per_round):
            raise RuntimeError(
                f"the port's PFPN resampling counter reads {flags} at the set-up rounds' "
                f"updates ({steps_per_round} steps each, interval "
                f"{cfg['resample_interval']}): the reference does not resample")


def _reference(cell, net, fault=None, keep_after=None):
    from ..reference.ppo import PPOReference, PPOSettings

    cfg = cell.config
    if cfg["lr_actor"] != cfg["lr_critic"]:
        raise ValueError("the reference keeps one Adam group: lr_actor must be lr_critic")
    return PPOReference(net, keep_after=keep_after, cfg=PPOSettings(
        gamma=cfg["gamma"], lambd=cfg["lambd"], value_loss_coef=cfg["value_loss_coef"],
        entropy_beta=cfg["entropy_beta"], epsilon=cfg["epsilon"], lr=cfg["lr_actor"],
        norm_clip=cfg["norm_clip"], minibatch_size=sizes(cfg, cell.traffic)["minibatch_size"],
        normalize_advantage=cfg["normalize_advantage"] and fault != "no_advantage_norm"))


def ref_updates(cell, upd: Dict, device, judge_round=None, fault=None) -> Dict:
    """The reference's updates from ``w0`` on the port's rollouts and
    permutations: ``losses`` (every minibatch's), ``grad1`` (the first
    minibatch's clipped gradients), ``params`` (after ``STEPS`` optimizer
    steps) and ``trail``; ``judge_round(k, net)`` runs before round k.
    Faults: ``half_batch`` (each minibatch's loss over its first half),
    ``no_advantage_norm``, ``half_minibatches`` (each round's first half of
    its minibatches only)."""
    cfg = cell.config
    net = reference_net(cfg, device, upd["w0"])
    ref = _reference(cell, net, fault, keep_after=STEPS)
    mb = ref.cfg.minibatch_size
    before = upd["before"]
    n = before[0]["perms"][0].shape[0]
    _no_resample(cfg, before, (n // mb) * len(before[0]["perms"]))
    losses, grad1 = [], None
    for k, traj in enumerate(upd["rounds"]):
        if judge_round is not None:
            judge_round(k, net)
        got, grads = ref.update({key: v.to(device) for key, v in traj.items()},
                                before[k]["perms"],
                                rows=mb // 2 if fault == "half_batch" else None,
                                minibatches=n // mb // 2 if fault == "half_minibatches"
                                else None)
        losses += got
        if k == 0:
            grad1 = grads
    if ref.kept is None:
        raise RuntimeError(f"the set-up rounds hold {ref.global_step} optimizer steps; "
                           f"the check compares the first {STEPS}")
    return {"losses": losses, "grad1": grad1, "params": ref.kept, "trail": ref.trail}


def judge_steps(cell, upd: Dict, device) -> Dict[str, float]:
    """Each step of the set-up rounds, from the port's state ahead of it
    (``upd["trail"]``): the reference's loss, clipped gradient and change
    (the parameters that move, by the rule of ``judge.moving_leaves``, and
    the normalizer) against the port's (its gradient as Adam takes it);
    and, exactly, how far the port's count of steps and of samples departs
    from the reference's (a step that never reached Adam reads no
    gradient)."""
    import torch

    from .. import judge

    ref = _reference(cell, reference_net(cell.config, device, upd["w0"]))
    mb = ref.cfg.minibatch_size
    buffers = [k for k, _ in ref.net.named_buffers()]
    got_losses, want_losses, off = [], [], 0
    grad_gap = change_gap = (0.0, None, None)
    step = 0
    for traj, before, trail in zip(upd["rounds"], upd["before"], upd["trail"]):
        per_epoch = before["perms"][0].shape[0] // mb
        want = per_epoch * len(before["perms"])
        snaps = trail["steps"] + [trail["end"]]
        off += abs(len(trail["steps"]) - want)
        off += sum(abs(s["samples"] - mb) for s in trail["steps"])
        if trail["steps"]:
            ref.load(snaps[0], step)
            data = ref.prepare({key: v.to(device) for key, v in traj.items()})
        for j, (s, after) in enumerate(zip(snaps[:want], snaps[1:want + 1])):
            epoch, i = divmod(j, per_epoch)
            ref.load(s, step + j)
            loss, grads = ref.step(data, before["perms"][epoch][i * mb:(i + 1) * mb],
                                   epoch == 0)
            got_losses.append(s["loss"])
            want_losses.append(loss)
            grad_got = {n: s.get("grad", {}).get(n, torch.zeros(())).to(device)
                        for n in grads}
            grad_gap = max(grad_gap, judge.worst_leaf(grad_got, grads) + (step + j,),
                           key=lambda w: w[0])
            now = ref.net.state_dict()
            keep = judge.moving_leaves(grads) + buffers
            change_gap = max(change_gap, judge.worst_leaf(
                {k: after["state"][k].to(device) - s["state"][k].to(device) for k in keep},
                {k: now[k] - s["state"][k].to(device) for k in keep}, keep) + (step + j,),
                key=lambda w: w[0])
        step += want
    print(f"portbench: each step from the port's state: worst gradient {grad_gap}, "
          f"worst change {change_gap} (gap, leaf, step)", file=sys.stderr)
    return {"step_loss_gap": judge.loss_gap(got_losses, want_losses, LOSS_AGAINST_MEDIAN)
            if got_losses else 0.0,
            "step_grad_gap": grad_gap[0], "step_change_gap": change_gap[0],
            "update_mismatches": float(off)}


def update_flops(cfg: Dict, algo_cfg) -> int:
    """The minibatches' forward and backward passes: the actor's log-prob
    (and its entropy, where the preset has a bonus) and the critic."""
    actor, critic = policy.shapes(cfg)
    actor_pass = policy.forward(actor) + policy.backward(actor)
    per_sample = (2 if cfg["entropy_beta"] else 1) * actor_pass \
        + policy.forward(critic) + policy.backward(critic)
    n = algo_cfg.num_envs * algo_cfg.unroll_length
    samples = (n // algo_cfg.minibatch_size) * algo_cfg.minibatch_size * algo_cfg.opt_epochs
    return samples * per_sample
