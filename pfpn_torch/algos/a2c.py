"""A2C / A3C (advantage actor-critic) on the PPO machinery.

Counterpart of ``pfpn_tpu/algos/a2c.py``. The reference's A3C applies
gradients asynchronously from 16 workers; the JAX package, and so the
port, runs it synchronously with the same losses and data flow: 16 envs
x a 32-step unroll, one minibatch of 512 per round, so one optimizer step
(the configuration is ``PPOConfig``, as JAX's ``A2CConfig`` is).
Rollout, GAE, the optimizer and the normalizers are PPO's, and so is the
rest of the loss (a2c.py:24-59): the advantage normalized and clipped per
minibatch when configured, the value target ``value + advantage``
(materialized as the reference's host buffer is, workers/a2c.py:74-77),
normalized through the value normalizer when ``normalize_value`` is on,
and the entropy bonus weighted by ``entropy_beta``. Only the policy loss
differs: the plain policy gradient ``-mean(log_prob * advantage)``.
"""

from __future__ import annotations

from typing import Dict

import torch

from .ppo import PPO


class A2C(PPO):
    """PPO's rollout, update and loss with the policy-gradient objective."""

    def _surrogate(self, lp: torch.Tensor, batch: Dict[str, torch.Tensor],
                   adv: torch.Tensor) -> torch.Tensor:
        return -self._mean(lp * adv)
