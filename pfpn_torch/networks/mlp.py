"""Plain MLP with the reference's activation (relu6) and initialization.

Counterpart of ``pfpn_tpu/networks/mlp.py``: a stack of linear layers with
relu6 between them (``mlp.py:48``) and an optional activation after the
last one. Weights are ``nn.Linear``'s ``(out, in)``; the JAX package keeps
``(in, out)`` (see ``networks/actor_critic.py:load_jax_params``).
:func:`init_linear_` draws the reference's truncated-normal(0, 0.01)
weights, cut at two standard deviations, with zero biases
(``mlp.py:17-45``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

INIT_STD = 0.01


def truncated_normal_(w: torch.Tensor, generator: Optional[torch.Generator],
                      stddev: float = INIT_STD) -> torch.Tensor:
    """tf.truncated_normal_initializer: normal(0, stddev) redrawn beyond two
    standard deviations (mlp.py:17). ``trunc_normal_``'s bounds are absolute
    values, hence +-2 stddev."""
    return nn.init.trunc_normal_(w, 0.0, stddev, -2.0 * stddev, 2.0 * stddev,
                                 generator=generator)


@torch.no_grad()
def init_linear_(layer: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """Truncated-normal weights and zero biases, in place (mlp.py:28)."""
    truncated_normal_(layer.weight, generator)
    layer.bias.zero_()


class MLP(nn.Module):
    """sizes = [in, h1, ..., out]."""

    def __init__(self, sizes: Sequence[int],
                 last_activation: Optional[Callable] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1))
        self.last_activation = last_activation

    def init_parameters(self, generator: Optional[torch.Generator]) -> None:
        """The reference's initialization of every layer (mlp.py:36)."""
        for layer in self.layers:
            init_linear_(layer, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            act = self.last_activation if i + 1 == len(self.layers) else F.relu6
            if act is not None:
                x = act(x)
        return x
