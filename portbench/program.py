"""The system under test: ``pfpn_torch``, built as a configuration states.

The only module of the benchmark that imports the port. It builds the
port's env, network and algorithm through the port's own entry points
(``harness.settings``, ``harness.build``, ``networks.actor_critic``) and
refuses to run when what it built departs from the configuration file.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_config(cfg: Dict, traffic: Dict):
    """The port's RunConfig of the preset, at the traffic's env scale."""
    from pfpn_torch.harness import settings

    return settings.build(cfg["preset"], particles=cfg["particles"], env=cfg["env"],
                          env_multiplier=int(traffic.get("env_multiplier", 1)))


def _require(what: str, got, want) -> None:
    if got != want:
        raise RuntimeError(f"the port's {what} is {got!r}; the configuration states {want!r}")


def verify_model(cfg: Dict, env, net) -> None:
    """The env's and network's sizes against the configuration's."""
    hum = cfg["humanoid"]
    eng = env.engine
    _require("obs_dim", env.observation_size, cfg["obs_dim"])
    _require("action_dim", env.action_size, cfg["action_dim"])
    _require("particles", net.cfg.head.particles, cfg["particles"])
    _require("actor_shape", list(net.cfg.actor_shape), cfg["actor_shape"])
    _require("critic_shape", list(net.cfg.critic_shape), cfg["critic_shape"])
    _require("clip_state", net.cfg.clip_state, cfg["clip_state"])
    _require("parameters", sum(p.numel() for p in net.parameters()), cfg["parameters"])
    _require("dofs", env.tree.ndof, hum["dofs"])
    _require("links", len(env.tree.link_body), hum["links"])
    _require("contact candidates", int(eng.contact_set.body.shape[0]),
             hum["contact_candidates"])
    _require("max_contacts", eng.substep_meta.n_contacts, hum["max_contacts"])
    _require("constraint rows", eng.substep_meta.n_rows, hum["constraint_rows"])
    _require("jacobi iterations", eng.substep_meta.iterations, hum["jacobi_iterations"])
    _require("substeps", env.frame_skip, hum["substeps"])
    _require("control rate", env.fps, float(hum["control_hz"]))
    _require("megastep", eng.mega is not None, True)


def build_act(cfg: Dict, traffic: Dict, device):
    """(env, net) of the preset with the configuration's ``.npz`` weights,
    loaded through the port's ``load_jax_params``."""
    from pfpn_torch.harness import build
    from pfpn_torch.networks.actor_critic import load_jax_params

    rc = run_config(cfg, traffic)
    env = build.build_env(rc, device)
    net = build.build_net(rc, env).to(device)
    with np.load(os.path.join(ROOT, cfg["weights"])) as z:
        flat = {k: z[k] for k in z.files}
    net.load_state_dict({k: v.to(device) for k, v in load_jax_params(flat).items()})
    verify_model(cfg, env, net)
    _require("megastep_links", env.engine.megastep_links, bool(cfg.get("megastep_links", False)))
    return env, net


def build_train(cfg: Dict, traffic: Dict, device):
    """The preset's algorithm (A2C on PPO's machinery), its env through the
    megastep variant the configuration states, and the unroll the traffic
    may override."""
    import dataclasses

    from pfpn_torch.harness import build

    links = bool(cfg.get("megastep_links", False))
    saved = os.environ.get("PFPN_MEGASTEP_LINKS")
    os.environ["PFPN_MEGASTEP_LINKS"] = "1" if links else "0"
    try:
        rc = run_config(cfg, traffic)
        algo = build.build_algo(rc, device=device)
    finally:
        if saved is None:
            os.environ.pop("PFPN_MEGASTEP_LINKS", None)
        else:
            os.environ["PFPN_MEGASTEP_LINKS"] = saved
    if "unroll_length" in traffic:
        unroll = int(traffic["unroll_length"])
        algo.cfg = dataclasses.replace(algo.cfg, unroll_length=unroll,
                                       minibatch_size=unroll * algo.cfg.num_envs)
    net, c = algo.net, algo.cfg
    verify_model(cfg, algo.env, net)
    _require("megastep_links", algo.env.engine.megastep_links, links)
    _require("algorithm", type(algo).__name__, "A2C")
    _require("num_envs", c.num_envs, cfg["workers"] * int(traffic.get("env_multiplier", 1)))
    _require("unroll_length", c.unroll_length,
             int(traffic.get("unroll_length", cfg["unroll_length"])))
    _require("minibatch_size", c.minibatch_size, c.unroll_length * c.num_envs)
    _require("opt_epochs", c.opt_epochs, cfg["opt_epochs"])
    _require("lr_actor", c.lr_actor, cfg["lr_actor"])
    _require("lr_critic", c.lr_critic, cfg["lr_critic"])
    _require("norm_clip", c.norm_clip, cfg["norm_clip"])
    n = net.cfg
    _require("entropy_beta", n.entropy_beta, cfg["entropy_beta"])
    _require("gamma", n.gamma, cfg["gamma"])
    _require("lambd", n.lambd, cfg["lambd"])
    _require("value_loss_coef", n.value_loss_coef, cfg["value_loss_coef"])
    _require("normalize_advantage", n.normalize_advantage, False)
    _require("normalize_value", n.normalize_value, False)
    return algo
