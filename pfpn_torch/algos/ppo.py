"""PPO, acting side: deterministic evaluation of a policy.

Counterpart of ``_clip_action`` and ``evaluate`` in
``pfpn_tpu/algos/ppo.py`` (:135-140, :312-332): reset a batch of episodes,
let the policy act deterministically and step the batch, summing each
episode's reward and frames until it is done. ``rollout``, ``update`` and
``train_round`` come with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..sim.dynamics import const


class PPO:
    def __init__(self, env, net):
        self.env = env
        self.net = net

    def _clip_action(self, a: torch.Tensor) -> torch.Tensor:
        return torch.clamp(a, const(self.env.action_low, a),
                           const(self.env.action_high, a))

    @torch.no_grad()
    def evaluate(self, num_episodes: int = 10, max_steps: int = 600,
                 generator: Optional[torch.Generator] = None) -> dict:
        """Deterministic episodes; stops early once every episode is done
        (later steps would add nothing). Returns per-episode ``reward``,
        ``frames`` and ``finished``."""
        env = self.env
        state, obs = env.reset_batch(num_episodes, generator)
        ret = torch.zeros(num_episodes, device=obs.device)
        frames = torch.zeros(num_episodes, dtype=torch.int32, device=obs.device)
        done = torch.zeros(num_episodes, dtype=torch.bool, device=obs.device)
        for _ in range(max_steps):
            a = self.net.act_deterministic(obs)
            res = env.step_batch(state, self._clip_action(a))
            ret = ret + torch.where(done, torch.zeros_like(res.reward), res.reward)
            frames = frames + (~done).int()
            done = done | res.done
            state, obs = res.state, res.obs
            if bool(done.all()):
                break
        return {"reward": ret, "frames": frames, "finished": done}
