"""A2C (the A3C preset, run synchronously): one clipped-Adam step over the
whole round; the reference is ``reference/a2c.py``."""

from __future__ import annotations

import dataclasses
from typing import Dict

from .. import program
from ..counts import policy
from . import _actor_critic

FAULTS = ("half_batch",)
STEPS = 3                       # one a round: every set-up round's step
reference_net = _actor_critic.reference_net
unchanged = _actor_critic.unchanged


def build(cfg: Dict, traffic: Dict, device):
    """The preset's A2C, with the unroll the traffic may override (one
    minibatch of the whole round)."""
    algo = program.build_train(cfg, traffic, device)
    if "unroll_length" in traffic:
        unroll = int(traffic["unroll_length"])
        algo.cfg = dataclasses.replace(algo.cfg, unroll_length=unroll,
                                       minibatch_size=unroll * algo.cfg.num_envs)
    req, c, n = program.require, algo.cfg, algo.net.cfg
    req("algorithm", type(algo).__name__, "A2C")
    req("num_envs", c.num_envs, cfg["workers"] * int(traffic.get("env_multiplier", 1)))
    req("unroll_length", c.unroll_length, int(traffic.get("unroll_length", cfg["unroll_length"])))
    req("minibatch_size", c.minibatch_size, c.unroll_length * c.num_envs)
    req("opt_epochs", c.opt_epochs, cfg["opt_epochs"])
    req("lr_actor", c.lr_actor, cfg["lr_actor"])
    req("lr_critic", c.lr_critic, cfg["lr_critic"])
    req("norm_clip", c.norm_clip, cfg["norm_clip"])
    req("entropy_beta", n.entropy_beta, cfg["entropy_beta"])
    req("gamma", n.gamma, cfg["gamma"])
    req("lambd", n.lambd, cfg["lambd"])
    req("value_loss_coef", n.value_loss_coef, cfg["value_loss_coef"])
    req("normalize_advantage", n.normalize_advantage, False)
    req("normalize_value", n.normalize_value, False)
    return algo


def watch(algo, on):
    return _actor_critic.watch(algo, on, STEPS)


def ref_updates(cell, upd: Dict, device, judge_round=None, fault=None) -> Dict:
    """The reference's updates from ``w0`` on the port's rollouts:
    ``losses``, ``grad1`` (the first clipped gradients) and ``params``
    (after ``STEPS`` updates); ``judge_round(k, net)`` runs before update
    k. ``fault="half_batch"``: each update over the first half of the envs
    only."""
    from ..reference.a2c import A2CReference, A2CSettings

    cfg = cell.config
    net = reference_net(cfg, device, upd["w0"])
    ref = A2CReference(net, A2CSettings(
        gamma=cfg["gamma"], lambd=cfg["lambd"], value_loss_coef=cfg["value_loss_coef"],
        entropy_beta=cfg["entropy_beta"], lr=cfg["lr_actor"], norm_clip=cfg["norm_clip"]))
    losses, grad1, params = [], None, None
    for k, traj in enumerate(upd["rounds"]):
        if judge_round is not None:
            judge_round(k, net)
        if fault == "half_batch":
            traj = {key: v[:, :v.shape[1] // 2] for key, v in traj.items()}
        loss, grads = ref.update({key: v.to(device) for key, v in traj.items()})
        losses.append(loss)
        if k == 0:
            grad1 = grads
        if k + 1 == STEPS:
            params = {n: p.detach().clone() for n, p in net.named_parameters()}
    if params is None:
        raise RuntimeError(f"the set-up rounds hold {len(losses)} optimizer steps; "
                           f"the check compares the first {STEPS}")
    return {"losses": losses, "grad1": grad1, "params": params}


def update_flops(cfg: Dict, algo_cfg) -> int:
    """One step over the round's samples: ``counts/policy.py``'s A2C loss."""
    return algo_cfg.num_envs * algo_cfg.unroll_length * policy.update_flops_per_sample(cfg)
