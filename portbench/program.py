"""The system under test: ``pfpn_torch``, built as a configuration states.

The only module of the benchmark that imports the port. It builds the
port's env, network and algorithm through the port's own entry points
(``harness.settings``, ``harness.build``, ``networks.actor_critic``) and
refuses to run when what it built departs from the configuration file; what
is specific to a training algorithm is checked by its module
(``algos/<algorithm>.py``).
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


def require(what: str, got, want) -> None:
    if got != want:
        raise RuntimeError(f"the port's {what} is {got!r}; the configuration states {want!r}")


def verify_model(cfg: Dict, env, net) -> None:
    """The env's and network's sizes against the configuration's."""
    hum = cfg["humanoid"]
    eng = env.engine
    require("obs_dim", env.observation_size, cfg["obs_dim"])
    require("action_dim", env.action_size, cfg["action_dim"])
    require("particles", net.cfg.head.particles, cfg["particles"])
    require("actor_shape", list(net.cfg.actor_shape), cfg["actor_shape"])
    require("critic_shape", list(net.cfg.critic_shape), cfg["critic_shape"])
    require("clip_state", net.cfg.clip_state, cfg["clip_state"])
    require("parameters", sum(p.numel() for p in net.parameters()), cfg["parameters"])
    require("dofs", env.tree.ndof, hum["dofs"])
    require("links", len(env.tree.link_body), hum["links"])
    require("contact candidates", int(eng.contact_set.body.shape[0]),
             hum["contact_candidates"])
    require("max_contacts", eng.substep_meta.n_contacts, hum["max_contacts"])
    require("constraint rows", eng.substep_meta.n_rows, hum["constraint_rows"])
    require("jacobi iterations", eng.substep_meta.iterations, hum["jacobi_iterations"])
    require("substeps", env.frame_skip, hum["substeps"])
    require("control rate", env.fps, float(hum["control_hz"]))
    require("megastep", eng.mega is not None, True)


def load_weights(net, cfg: Dict, device, seeded=None) -> None:
    """The configuration's weights into the port's ``net``: ``seeded`` (a
    state dict) where they are ``"seeded"``, else the ``.npz`` through the
    port's ``load_jax_params``."""
    from pfpn_torch.networks.actor_critic import load_jax_params

    if cfg["weights"] == "seeded":
        net.load_state_dict(seeded)
        return
    with np.load(os.path.join(ROOT, cfg["weights"])) as z:
        flat = {k: z[k] for k in z.files}
    net.load_state_dict({k: v.to(device) for k, v in load_jax_params(flat).items()})


def build_act(cfg: Dict, traffic: Dict, device):
    """(env, net) of the preset with the configuration's ``.npz`` weights,
    loaded through the port's ``load_jax_params``."""
    from pfpn_torch.harness import build

    rc = run_config(cfg, traffic)
    env = build.build_env(rc, device)
    net = build.build_net(rc, env).to(device)
    load_weights(net, cfg, device)
    verify_model(cfg, env, net)
    require("megastep_links", env.engine.megastep_links, bool(cfg.get("megastep_links", False)))
    return env, net


def build_train(cfg: Dict, traffic: Dict, device):
    """The preset's algorithm, its env through the megastep variant the
    configuration states; the algorithm's module checks the rest."""
    from pfpn_torch.harness import build

    links = bool(cfg.get("megastep_links", False))
    saved = os.environ.get("PFPN_MEGASTEP_LINKS")
    os.environ["PFPN_MEGASTEP_LINKS"] = "1" if links else "0"
    try:
        algo = build.build_algo(run_config(cfg, traffic), device=device)
    finally:
        if saved is None:
            os.environ.pop("PFPN_MEGASTEP_LINKS", None)
        else:
            os.environ["PFPN_MEGASTEP_LINKS"] = saved
    verify_model(cfg, algo.env, algo.net)
    require("megastep_links", algo.env.engine.megastep_links, links)
    return algo
