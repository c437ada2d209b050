"""Policy evaluation and trajectory export (the CLI without ``--train``).

Counterpart of ``pfpn_tpu/harness/eval.py``: deterministic episodes of the
policy in the latest checkpoint (any preset the port has, PPO's or SAC's
and DDPG's), each env's link positions and orientations
recorded at every frame, written to ``trajectory.npz`` in the run's log
directory in the JAX package's layout (``link_pos`` (T, E, 15, 3),
``link_quat`` (T, E, 15, 4), ``done`` (T, E), ``link_names``), which
``tools/view_trajectory.py`` replays.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..sim.dynamics import fk, link_states
from .build import build_algo
from .checkpoint import CheckpointManager
from .config import RunConfig


@torch.no_grad()
def rollout_trajectory(cfg: RunConfig, algo, num_episodes: int = 3,
                       max_steps: int = 600,
                       generator: Optional[torch.Generator] = None):
    """``max_steps`` deterministic steps of ``num_episodes`` envs started
    from ``generator`` (by default seeded with ``cfg.seed``), recorded at
    every frame, also after an episode ends, as the JAX package's scan does
    (eval.py:24-49). Returns numpy (link_pos, link_quat, done, return); the
    return adds each step's reward while its episode was not done before
    it."""
    env = algo.env
    tree = getattr(env, "env", env).tree     # under DiscreteActionWrapper
    if generator is None:
        generator = torch.Generator(device=env.device).manual_seed(cfg.seed)
    state, obs = env.reset_batch(num_episodes, generator)
    done = torch.zeros(num_episodes, dtype=torch.bool, device=obs.device)
    ret = torch.zeros(num_episodes, device=obs.device)
    pos, quat, dones = [], [], []
    for _ in range(max_steps):
        a = algo.net.act_deterministic(obs)
        res = env.step_batch(state, algo._clip_action(a))
        ret = ret + torch.where(done, torch.zeros_like(res.reward), res.reward)
        done = done | res.done
        ls = link_states(tree, fk(tree, res.state.sim))
        pos.append(ls.frame_pos)
        quat.append(ls.frame_quat)
        dones.append(done)
        state, obs = res.state, res.obs
    return (torch.stack(pos).cpu().numpy(), torch.stack(quat).cpu().numpy(),
            torch.stack(dones).cpu().numpy(), ret.cpu().numpy())


def visualize(cfg: RunConfig, root: str = ".", num_episodes: int = 3, device=None):
    """Roll the latest checkpoint's policy and write the trajectory npz
    (eval.py:52-70). Returns (path, per-episode returns), or None when the
    run has no checkpoint."""
    algo = build_algo(cfg, device)
    state = algo.init_state(torch.Generator(device=algo.env.device).manual_seed(cfg.seed))
    ckpt = CheckpointManager(cfg.checkpoint_dir(root))
    if ckpt.restore_latest(state) is None:
        print(f"[SYSTEM] no checkpoint found in {cfg.checkpoint_dir(root)}")
        return None
    pos, quat, done, ret = rollout_trajectory(cfg, algo, num_episodes)
    out = os.path.join(cfg.log_dir(root), "trajectory.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tree = getattr(algo.env, "env", algo.env).tree
    np.savez(out, link_pos=pos, link_quat=quat, done=done,
             link_names=np.array(tree.link_names))
    print(f"[SYSTEM] episode rewards: {ret}")
    print(f"[SYSTEM] wrote trajectory to {out}")
    return out, ret
