"""Return and advantage estimators as reverse loops over time.

Counterpart of ``pfpn_tpu/algos/gae.py``, whose ``lax.scan(reverse=True)``
recurrences become Python loops over the time axis, vectorized over envs.

Time-major layout (T, B); per-step flags:
  terminated[t] -- true env terminal (bootstrap 0)
  done[t]       -- terminal OR truncation OR unroll boundary (stop the carry)
  next_values[t] -- V(s_{t+1}) evaluated on the *pre-reset* next state
"""

from __future__ import annotations

from typing import Tuple

import torch


def discount(values: torch.Tensor, factor: float,
             bootstrap: torch.Tensor) -> torch.Tensor:
    """Reverse discounted sum: out[t] = values[t] + factor * out[t + 1],
    with out[T] = bootstrap (gae.py:21)."""
    out = torch.empty_like(values)
    carry = bootstrap
    for t in range(values.shape[0] - 1, -1, -1):
        carry = values[t] + factor * carry
        out[t] = carry
    return out


def gae(rewards, values, next_values, terminated, done, gamma: float,
        lambd: float) -> torch.Tensor:
    """Generalized advantage estimation with per-step episode boundaries
    (gae.py:32): the TD error bootstraps with 0 on true terminals and with
    V(next pre-reset state) on truncation and unroll end; the carry resets
    across episode boundaries."""
    not_term = 1.0 - terminated.to(rewards.dtype)
    not_done = 1.0 - done.to(rewards.dtype)
    delta = rewards + gamma * not_term * next_values - values
    adv = torch.empty_like(delta)
    carry = torch.zeros_like(delta[-1])
    for t in range(delta.shape[0] - 1, -1, -1):
        carry = delta[t] + gamma * lambd * not_done[t] * carry
        adv[t] = carry
    return adv


def td_lambda_targets(rewards, values, next_values, terminated, done,
                      gamma: float, lambd: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(TD(lambda) value targets, advantages)."""
    adv = gae(rewards, values, next_values, terminated, done, gamma, lambd)
    return adv + values, adv
