"""Training loop: rounds, interleaved evaluation, checkpointing, resume.

Counterpart of ``pfpn_tpu/harness/train.py``: build the algorithm (PPO,
A2C, V-trace, recurrent PPO, or SAC / DDPG) from the RunConfig, initialize from ``cfg.seed`` (or resume
from the latest checkpoint), then run training rounds until
``cfg.max_samples`` samples or exactly ``max_rounds`` rounds; evaluate the
deterministic policy every ``eval_every_rounds`` rounds (with histograms of
the particle means and stds as the head stores them, in atanh space for the
squashed heads, and of the actions, except for the recurrent net, whose
action needs its carry: the JAX package's call raises there and is
skipped); checkpoint every
``cfg.save_checkpoint_interval`` optimizer steps and at the end.

In a process group of more than one rank (``distributed/mesh.py``, joined
by the CLI), every rank builds the same global state from the seed or the
checkpoint and keeps its slice of the per-env fields; rank 0 alone logs,
evaluates and writes checkpoints, which hold the gathered global per-env
fields, so a run saved at one world size resumes at another. After every
round the ranks check that their parameters and normalizer are equal. The JAX
package's tunnel watchdog and ``rounds_per_dispatch`` are not part of the
port.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..distributed import mesh as mesh_mod
from ..networks.recurrent_ac import RecurrentActorCritic
from .build import build_algo
from .checkpoint import CheckpointManager
from .config import RunConfig
from .metrics import MetricsLogger


EVAL_EPISODES = 10


def train(cfg: RunConfig, root: str = ".", eval_every_rounds: int = 50,
          max_rounds: Optional[int] = None, debug: bool = False, device=None):
    """Train; returns (algo, state), the state this rank's slice of it."""
    mesh = mesh_mod.current_mesh()
    lead = mesh is None or mesh.lead
    algo = build_algo(cfg, mesh_mod.rank_device(device))
    dev = algo.env.device
    state = algo.init_state(torch.Generator(device=dev).manual_seed(cfg.seed))

    ckpt = CheckpointManager(cfg.checkpoint_dir(root))
    restored = ckpt.restore_latest(state)
    if restored is not None:
        state = restored
        if lead:
            print(f"[SYSTEM] resumed from step {ckpt.latest_step()}", flush=True)
    if mesh is not None:
        algo.shard(mesh)
        state = mesh_mod.shard_state(state, mesh)
        if lead:
            print(f"[SYSTEM] data-parallel over {mesh.world} ranks "
                  f"({cfg.num_envs // mesh.world} envs per rank)", flush=True)

    def save(step, st):
        if mesh is not None:
            st = mesh_mod.gather_state(st, mesh)
        if lead:
            ckpt.save(step, st)

    # --debug lifts the 10 s console throttle
    logger = (MetricsLogger(cfg.log_dir(root), console_interval=0.0 if debug else 10.0)
              if lead else None)
    eval_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 12345)
    eval_reward_sum, eval_reward_n = 0.0, 0   # performance_test/reward_avg
    last_ckpt_step = state.global_step
    t_start = time.time()
    round_idx = 0
    while state.total_samples < cfg.max_samples:
        if max_rounds is not None and round_idx >= max_rounds:
            break
        state, metrics = algo.train_round(state)
        round_idx += 1
        if mesh is not None:
            mesh.check_replicated(list(algo.net.state_dict().values()), "parameter")
        step = state.global_step
        if lead:   # rank 0 alone logs and evaluates
            logger.log(step, metrics, prefix="train/")
            logger.console("TRAIN", step, {
                "samples": metrics["total_samples"], "loss": metrics["loss"],
                "ep_reward": metrics["episode_reward"],
                "sps": metrics["total_samples"] / max(time.time() - t_start, 1e-9)})

            if eval_every_rounds and round_idx % eval_every_rounds == 0:
                out = algo.evaluate(num_episodes=EVAL_EPISODES, generator=eval_gen)
                rew = out["reward"].cpu().numpy()
                frames = out["frames"].cpu().numpy()
                eval_reward_sum += float(rew.sum())
                eval_reward_n += rew.size
                reward_avg = eval_reward_sum / eval_reward_n
                logger.log(step, {"reward": rew.mean(), "reward_avg": reward_avg,
                                  "reward_max": rew.max(), "reward_min": rew.min(),
                                  "frames": frames.mean(),
                                  "samples": state.total_samples},
                           prefix="performance_test/")
                print(f"[PERFORM] step {step} reward {rew.mean():.2f} "
                      f"(avg {reward_avg:.2f} min {rew.min():.2f} max {rew.max():.2f}) "
                      f"frames {frames.mean():.0f}", flush=True)
                head = algo.net.head
                with torch.no_grad():
                    hists = {}
                    if not isinstance(algo.net, RecurrentActorCritic):
                        hists["action"] = algo.net.act_deterministic(state.obs).cpu().numpy()
                    if algo.net.is_pfpn:
                        hists["particle/loc"] = head.particles.cpu().numpy()
                        hists["particle/std"] = torch.exp(head.log_std_tensor()).cpu().numpy()
                if hists:
                    logger.log_histograms(step, hists, prefix="train/")

        if step - last_ckpt_step >= cfg.save_checkpoint_interval:
            save(step, state)
            last_ckpt_step = step

    save(state.global_step, state)
    if lead:
        logger.close()
    return algo, state
