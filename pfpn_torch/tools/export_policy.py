#!/usr/bin/env python3
"""Replay a shipped policy npz with deterministic episodes.

Counterpart of ``tools/export_policy.py --play`` (``:86-106``): build the
preset's env and network, load the npz's ``params/...`` and ``norm/...``
arrays (fp16 weights, widened to fp32), and run ``evaluate``. Runs on the
GPU unless ``--device cpu`` is given.

Usage:
  python -m pfpn_torch.tools.export_policy --play results/policies/<file>.npz \\
      --env DeepMimicWalk-v0 --setting deepmimic_dppo_pfpn --particles 35 --episodes 10
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..algos.ppo import PPO
from ..harness.build import build_algo
from ..harness.settings import build
from ..networks.actor_critic import load_jax_params


def load_policy(algo: PPO, path: str) -> None:
    with np.load(path) as z:
        state = load_jax_params({k: z[k] for k in z.files})
    algo.net.load_state_dict(state, strict=True)


def play(path: str, env: str = "DeepMimicWalk-v0",
         setting: str = "deepmimic_dppo_pfpn", particles: int = 35,
         episodes: int = 10, max_steps: int = 600, seed: int = 0,
         device=None, algo: Optional[PPO] = None) -> dict:
    """Deterministic episodes of the npz policy at ``path``; returns the
    ``evaluate`` dict (per-episode reward, frames, finished)."""
    if algo is None:
        algo = build_algo(build(setting, particles=particles, env=env), device)
        load_policy(algo, path)
    gen = torch.Generator(device=algo.env.device).manual_seed(seed)
    return algo.evaluate(num_episodes=episodes, max_steps=max_steps, generator=gen)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--play", required=True, help="policy npz to evaluate")
    ap.add_argument("--env", default="DeepMimicWalk-v0")
    ap.add_argument("--setting", default="deepmimic_dppo_pfpn")
    ap.add_argument("--particles", type=int, default=35)
    ap.add_argument("--episodes", type=int, default=10)
    ap.add_argument("--max_steps", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = play(args.play, args.env, args.setting, args.particles, args.episodes,
               args.max_steps, args.seed, args.device)
    rew = out["reward"].cpu().numpy()
    frames = out["frames"].cpu().numpy()
    print(f"[PLAY] {args.play}: reward {rew.mean():.2f} "
          f"(min {rew.min():.2f} max {rew.max():.2f}) frames {frames.mean():.0f}")
    return out


if __name__ == "__main__":
    main()
