"""Operations of the actor-critic's matrix products, from the layer shapes.

A forward pass of a linear layer of ``i`` inputs and ``o`` outputs is
2 i o operations per sample; its backward pass is 4 i o (the weight's
gradient and the input's), 2 i o for the first layer of an MLP, whose
input needs no gradient. Biases, activations and the particle mixture's
element-wise work are left out: under 2% of the products at these widths.
"""

from __future__ import annotations

from typing import Dict, Sequence


def _layers(sizes: Sequence[int]):
    return list(zip(sizes[:-1], sizes[1:]))


def shapes(cfg: Dict):
    """(actor layers, critic layers) as (in, out) pairs; the actor ends in
    the particle head's logits, action_dim x particles."""
    obs, actor, critic = cfg["obs_dim"], cfg["actor_shape"], cfg["critic_shape"]
    head = cfg["action_dim"] * cfg["particles"]
    return (_layers([obs, *actor, head]), _layers([obs, *critic, 1]))


def forward(layers) -> int:
    return sum(2 * i * o for i, o in layers)


def backward(layers) -> int:
    return sum((2 if k == 0 else 4) * i * o for k, (i, o) in enumerate(layers))


def act_flops(cfg: Dict) -> int:
    """One ``ActorCritic.act`` per sample: the actor and the critic."""
    actor, critic = shapes(cfg)
    return forward(actor) + forward(critic)


def rollout_step_flops(cfg: Dict) -> int:
    """One rollout step per env: ``act`` and the critic on the pre-reset
    observation."""
    actor, critic = shapes(cfg)
    return forward(actor) + 2 * forward(critic)


def update_flops_per_sample(cfg: Dict) -> int:
    """A2C's loss per sample: the log-prob's and the entropy's actor passes
    and the critic's, each forward and backward."""
    actor, critic = shapes(cfg)
    return 2 * (forward(actor) + backward(actor)) + forward(critic) + backward(critic)
