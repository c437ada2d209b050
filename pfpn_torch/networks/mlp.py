"""Plain MLP with the reference's activation (relu6).

Counterpart of ``pfpn_tpu/networks/mlp.py``: a stack of linear layers with
relu6 between them (``mlp.py:48``) and an optional activation after the
last one. Weights are ``nn.Linear``'s ``(out, in)``; the JAX package keeps
``(in, out)`` (see ``networks/actor_critic.py:load_jax_params``).
Initialization comes with the training slice.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F


class MLP(nn.Module):
    """sizes = [in, h1, ..., out]."""

    def __init__(self, sizes: Sequence[int],
                 last_activation: Optional[Callable] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1))
        self.last_activation = last_activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            act = self.last_activation if i + 1 == len(self.layers) else F.relu6
            if act is not None:
                x = act(x)
        return x
