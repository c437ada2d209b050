"""Value-target normalizer with a renormalization that keeps outputs.

Counterpart of ``pfpn_tpu/networks/value_norm.py``: the critic regresses
*normalized* targets; when the running target statistics move, a scale and
offset pair is updated so that the network's learned outputs keep
denormalizing to the same values:

    value = (critic_out * scale + offset) * std + mean
    on update:  scale' = scale * std / std_new
                offset' = offset * std / std_new + (mean - mean_new) / std_new

The update *composes* with the earlier scale and offset, as the JAX package
does (its PARITY deviation from the reference, which overwrites them and so
keeps outputs only while they are still the identity). The statistics move
by the observation normalizer's moving average
(:func:`~pfpn_torch.networks.normalizer.moving_average`), the decay taken at
the given optimizer step. Off in every shipped preset; reached through
``NetworkSettings(normalize_value=True)`` on the feed-forward PPO and A2C
paths. The state is four 0-d tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .normalizer import moving_average


class ValueNormState(NamedTuple):
    mean: torch.Tensor
    std: torch.Tensor
    scale: torch.Tensor
    offset: torch.Tensor


def init(device=None) -> ValueNormState:
    """The identity (value_norm.py:40)."""
    zero = torch.zeros((), device=device)
    one = torch.ones((), device=device)
    return ValueNormState(mean=zero, std=one, scale=one.clone(), offset=zero.clone())


def denormalize(state: ValueNormState, raw_value: torch.Tensor,
                clip: Optional[float] = None) -> torch.Tensor:
    v = raw_value * state.scale + state.offset
    if clip:
        v = torch.clamp(v, -clip, clip)
    return v * state.std + state.mean


def normalize_target(state: ValueNormState, target: torch.Tensor,
                     clip: Optional[float] = None) -> torch.Tensor:
    t = (target - state.mean) / state.std
    if clip:
        t = torch.clamp(t, -clip, clip)
    return t


@torch.no_grad()
def update(state: ValueNormState, targets: torch.Tensor, global_step: int) -> ValueNormState:
    """Move the statistics towards ``targets`` (N,) and renormalize the
    scale and offset so that denormalized outputs stay (value_norm.py:61)."""
    new_mean, new_std = moving_average(state.mean, state.std, targets.reshape(-1), global_step)
    ratio = state.std / new_std
    offset = state.offset * ratio + (state.mean - new_mean) / new_std
    return ValueNormState(mean=new_mean, std=new_std, scale=state.scale * ratio, offset=offset)
