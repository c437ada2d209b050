#!/usr/bin/env python3
"""Export a port checkpoint to a policy npz, or replay a policy npz.

Counterpart of ``tools/export_policy.py``:

* export: the latest ``<step>.pt`` of the run (``--env``, ``--setting``,
  ``--particles``, ``--seed``, ``--root``, ``--suffix``) becomes
  ``results/policies/<env>_<setting>_particle<n>_<seed>_step<step>.npz``
  under the working directory, in the JAX package's layout
  (``:121-141``): the parameters as ``params/...`` in fp16 (SAC's and
  DDPG's with ``q1``, ``q2`` and SAC's ``log_alpha``, without the
  targets), the observation normalizer as ``norm/...``; the JAX package's
  ``--play`` reads it, as this tool reads the JAX package's files;
* ``--play NPZ``: deterministic episodes of the npz's policy through its
  preset's ``evaluate`` (``PPO.evaluate``, or ``SAC.evaluate`` for the SAC
  and DDPG presets; ``:86-106``); ``--record PATH`` also rolls up to three
  episodes and writes their trajectory npz for ``tools/view_trajectory.py``
  (``:107-119``).

Runs on the GPU unless ``--device cpu`` is given.

Usage:
  python -m pfpn_torch.tools.export_policy --env DeepMimicKick-v0 \\
      --setting deepmimic_dppo_pfpn --particles 35 --seed 34114 [--root DIR]
  python -m pfpn_torch.tools.export_policy --play results/policies/<file>.npz \\
      --env DeepMimicKick-v0 --setting deepmimic_dppo_pfpn --particles 35 --episodes 10
  python -m pfpn_torch.tools.export_policy --play \
      results/policies/DeepMimicWalk-v0_deepmimic_sac_pfpn_particle35_34114_step11138592.npz \
      --env DeepMimicWalk-v0 --setting deepmimic_sac_pfpn --particles 35 --episodes 10
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch

from ..algos.ppo import PPO
from ..algos.sac import SAC
from ..harness.build import build_algo
from ..harness.checkpoint import CheckpointManager
from ..harness.eval import rollout_trajectory
from ..harness.settings import build
from ..networks.actor_critic import export_jax_params, load_jax_params


def load_policy(algo: Union[PPO, SAC], path: str) -> None:
    with np.load(path) as z:
        state = load_jax_params({k: z[k] for k in z.files})
    algo.net.load_state_dict(state, strict=True)


def play(path: str, env: str = "DeepMimicWalk-v0",
         setting: str = "deepmimic_dppo_pfpn", particles: int = 35,
         episodes: int = 10, max_steps: int = 600, seed: int = 0,
         device=None, algo: Optional[Union[PPO, SAC]] = None,
         init_time: Optional[torch.Tensor] = None) -> dict:
    """Deterministic episodes of the npz policy at ``path`` (loaded into
    ``algo`` when none is given), started at phases drawn from a generator
    seeded with ``seed`` or at the times ``init_time`` (E,); returns the
    ``evaluate`` dict (per-episode reward, frames, finished)."""
    if algo is None:
        algo = build_algo(build(setting, particles=particles, env=env), device)
        load_policy(algo, path)
    gen = torch.Generator(device=algo.env.device).manual_seed(seed)
    return algo.evaluate(num_episodes=episodes, max_steps=max_steps, generator=gen,
                         init_time=init_time)


def export(env: str, setting: str, particles: int = 35, seed: int = 34114,
           root: str = ".", suffix: str = "", env_multiplier: int = 1,
           device=None) -> str:
    """Write the run's latest checkpoint as a policy npz under
    ``results/policies/`` of the working directory; returns its path."""
    cfg = build(setting, particles=particles, env=env, seed=seed,
                env_multiplier=env_multiplier)
    if suffix:
        cfg = dataclasses.replace(cfg, suffix=suffix)
    algo = build_algo(cfg, device)
    ckpt = CheckpointManager(cfg.checkpoint_dir(root))
    step = ckpt.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {cfg.checkpoint_dir(root)}")
    ckpt.restore_latest(algo.init_state(
        torch.Generator(device=algo.env.device).manual_seed(cfg.seed)))
    os.makedirs("results/policies", exist_ok=True)
    name = (f"results/policies/{env}_{cfg.name}"
            f"_particle{particles}_{seed}_step{step}.npz")
    # params in fp16, the normalizer as it is (tools/export_policy.py:130-135)
    np.savez_compressed(name, **{
        k: v.astype(np.float16) if k.startswith("params/") and v.dtype == np.float32 else v
        for k, v in export_jax_params(algo.net).items()})
    print(f"exported {name} ({os.path.getsize(name) / 1e6:.1f} MB, step {step})")
    return name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="DeepMimicWalk-v0")
    ap.add_argument("--setting", default="deepmimic_dppo_pfpn")
    ap.add_argument("--particles", type=int, default=35)
    ap.add_argument("--seed", type=int, default=34114)
    ap.add_argument("--root", default=".")
    ap.add_argument("--suffix", default="", help="run-dir suffix (the training --suffix)")
    ap.add_argument("--env_multiplier", type=int, default=1,
                    help="must match the training run for checkpoint export")
    ap.add_argument("--play", default=None, help="npz to evaluate instead")
    ap.add_argument("--episodes", type=int, default=10)
    ap.add_argument("--max_steps", type=int, default=600)
    ap.add_argument("--record", default=None,
                    help="with --play: also roll deterministic episodes and "
                         "write a trajectory npz for tools/view_trajectory.py")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.play:
        return export(args.env, args.setting, args.particles, args.seed, args.root,
                      args.suffix, args.env_multiplier, args.device)

    cfg = build(args.setting, particles=args.particles, env=args.env, seed=args.seed,
                env_multiplier=args.env_multiplier)
    algo = build_algo(cfg, args.device)
    load_policy(algo, args.play)
    out = play(args.play, episodes=args.episodes, max_steps=args.max_steps, algo=algo)
    rew = out["reward"].cpu().numpy()
    frames = out["frames"].cpu().numpy()
    print(f"[PLAY] {args.play}: reward {rew.mean():.2f} "
          f"(min {rew.min():.2f} max {rew.max():.2f}) frames {frames.mean():.0f}")
    if args.record:
        pos, quat, done, ret = rollout_trajectory(cfg, algo, min(args.episodes, 3),
                                                  args.max_steps)
        tree = getattr(algo.env, "env", algo.env).tree
        np.savez(args.record, link_pos=pos, link_quat=quat, done=done,
                 link_names=np.array(tree.link_names))
        print(f"[PLAY] wrote trajectory to {args.record} "
              f"(episode rewards {np.round(ret, 1)})")
    return out


if __name__ == "__main__":
    main()
