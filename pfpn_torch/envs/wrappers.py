"""Env wrappers.

Counterpart of ``pfpn_tpu/envs/wrappers.py``: :class:`DiscreteActionWrapper`
quantizes each continuous action dimension into ``n`` evenly spaced values,
turning the task into a factored-discrete control problem for the
categorical head (the ``deepmimic_dppo_dis`` preset).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..sim.dynamics import const


class DiscreteActionWrapper:
    """Action index i in {0..n-1} per dimension -> the continuous value
    low + i (high - low) / (n - 1) (wrappers.py:15). The wrapped env's
    bounds are dropped, as a discrete space has none; every other attribute
    (``engine``, ``device``, ``reset_at``, ...) is the wrapped env's."""

    def __init__(self, env, n: int):
        self.env = env
        self.n = n
        low = np.asarray(env.action_low, dtype=np.float32)
        high = np.asarray(env.action_high, dtype=np.float32)
        steps = np.arange(n, dtype=np.float32)[None, :] / (n - 1)
        self.table = low[:, None] + steps * (high - low)[:, None]    # (dims, n)
        self.action_size = env.action_size
        self.observation_size = env.observation_size
        self.action_low = None
        self.action_high = None

    def continuous(self, actions: torch.Tensor) -> torch.Tensor:
        """Integer actions (..., dims) -> continuous actions (..., dims)."""
        tbl = const(self.table, actions)
        idx = actions.long()
        dims = torch.arange(tbl.shape[0], device=actions.device)
        return tbl[dims, idx]

    def step(self, states, actions: torch.Tensor):
        return self.env.step(states, self.continuous(actions))

    def step_batch(self, states, actions: torch.Tensor):
        return self.env.step_batch(states, self.continuous(actions))

    def step_autoreset(self, states, actions: torch.Tensor,
                       generator: Optional[torch.Generator] = None):
        return self.env.step_autoreset(states, self.continuous(actions), generator)

    def __getattr__(self, name):
        return getattr(self.env, name)
