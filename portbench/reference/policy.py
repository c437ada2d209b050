"""The PFPN actor-critic in plain PyTorch.

A frozen copy of the parts of ``pfpn_torch/networks`` (``mlp.py``,
``normalizer.py``, ``heads.py``'s unsquashed particle head and
``actor_critic.py``) that acting and A2C training run: the clipped state
normalizer, relu6 MLPs with the truncated-normal initialization, the
particle head over a [D, N] grid, the critic, the moving-average
normalizer update, and the loader of the JAX package's flat ``.npz``
layout. Parameter names are the port's, so a state dict made here loads
there.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from . import particle as pfp

INIT_STD = 0.01


@torch.no_grad()
def init_linear_(layer: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """Truncated-normal(0, 0.01) weights cut at two standard deviations,
    zero biases."""
    nn.init.trunc_normal_(layer.weight, 0.0, INIT_STD, -2.0 * INIT_STD,
                          2.0 * INIT_STD, generator=generator)
    layer.bias.zero_()


class MLP(nn.Module):
    """sizes = [in, h1, ..., out]; relu6 between layers."""

    def __init__(self, sizes: Sequence[int], last_relu6: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1))
        self.last_relu6 = last_relu6

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i + 1 < len(self.layers) or self.last_relu6:
                x = F.relu6(x)
        return x


class Normalizer(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("std", torch.ones(dim))
        self.register_buffer("count", torch.tensor(1e-4))

    def forward(self, x: torch.Tensor, clip: Optional[float]) -> torch.Tensor:
        y = (x - self.mean) / self.std
        return torch.clamp(y, -clip, clip) if clip else y

    @torch.no_grad()
    def update_moving_average(self, batch: torch.Tensor, global_step: int) -> None:
        """decay = min(0.9999, (1 + s) / (10 + s)) in fp32 at the new
        optimizer step s; the std floored at 1e-6."""
        s = np.float32(global_step)
        decay = np.minimum(np.float32(0.9999), (np.float32(1.0) + s) / (np.float32(10.0) + s))
        decay, rest = float(decay), float(np.float32(1.0) - decay)
        m = torch.mean(batch, 0)
        v = torch.var(batch, 0, correction=0)
        self.mean.copy_(decay * self.mean + rest * m)
        self.std.copy_(torch.clamp(decay * self.std + rest * torch.sqrt(v), min=1e-6))


class ParticleHead(nn.Module):
    """Logits over N particles per action dim, free means and log-stds [D, N]."""

    def __init__(self, feat_dim: int, action_dim: int, particles: int):
        super().__init__()
        self.action_dim, self.n = action_dim, particles
        self.fc_policy = nn.Linear(feat_dim, action_dim * particles)
        self.particles = nn.Parameter(torch.zeros(action_dim, particles))
        self.particles_log_std = nn.Parameter(torch.zeros(action_dim, particles))

    @torch.no_grad()
    def init_parameters(self, generator: Optional[torch.Generator]) -> None:
        """Truncated-normal logit weights, zero biases, the grid: endpoints
        linspace(-1, 1, N), std 2 / (N - 1)."""
        init_linear_(self.fc_policy, generator)
        d, n = self.action_dim, self.n
        loc = np.broadcast_to(-1.0 + 2.0 / (n - 1) * np.arange(n), (d, n))
        self.particles.copy_(torch.from_numpy(loc.astype(np.float32)))
        self.particles_log_std.fill_(float(np.float32(np.log(2.0 / (n - 1)))))

    def dist(self, feat: torch.Tensor):
        logits = self.fc_policy(feat).reshape(feat.shape[:-1] + (self.action_dim, self.n))
        scale = torch.exp(torch.clamp(self.particles_log_std, -20.0, 2.0))
        return logits, self.particles, scale

    def log_prob_of(self, feat: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        logits, loc, scale = self.dist(feat)
        return pfp.log_prob(logits, loc, scale, action)

    def entropy_of(self, feat: torch.Tensor) -> torch.Tensor:
        return torch.sum(pfp.entropy(self.dist(feat)[0]), dim=-1)


class ActorCritic(nn.Module):
    """normalizer -> actor MLP (relu6 after every layer) -> particle head;
    normalizer -> critic MLP -> value."""

    def __init__(self, obs_dim: int, action_dim: int, particles: int,
                 actor_shape: Sequence[int], critic_shape: Sequence[int],
                 clip_state: float = 5.0):
        super().__init__()
        self.clip_state = clip_state
        self.norm = Normalizer(obs_dim)
        self.actor_trunk = MLP([obs_dim, *actor_shape], last_relu6=True)
        self.head = ParticleHead(actor_shape[-1], action_dim, particles)
        self.critic = MLP([obs_dim, *critic_shape, 1])

    def init_parameters(self, generator: Optional[torch.Generator]) -> None:
        """Layer by layer in the port's order: actor trunk, head, critic."""
        for layer in self.actor_trunk.layers:
            init_linear_(layer, generator)
        self.head.init_parameters(generator)
        for layer in self.critic.layers:
            init_linear_(layer, generator)

    def actor_features(self, obs: torch.Tensor) -> torch.Tensor:
        return self.actor_trunk(self.norm(obs, self.clip_state))

    def value(self, obs: torch.Tensor) -> torch.Tensor:
        return self.critic(self.norm(obs, self.clip_state))[..., 0]

    def log_prob(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return self.head.log_prob_of(self.actor_features(obs), action)

    def entropy(self, obs: torch.Tensor) -> torch.Tensor:
        return self.head.entropy_of(self.actor_features(obs))


def state_dict_from_npz(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX package's flat ``params/<mlp>/#<i>/{w,b}``,
    ``params/head/...`` and ``norm/...`` arrays as a state dict of
    :class:`ActorCritic`: weights (in, out) become (out, in)."""
    state: Dict[str, torch.Tensor] = {}
    for key, val in flat.items():
        t = torch.tensor(np.asarray(val, dtype=np.float32))
        parts = key.split("/")
        if parts[0] == "norm":
            state[f"norm.{parts[1]}"] = t
            continue
        parts = parts[1:]
        leaf = parts[-1]
        if leaf in ("w", "b"):
            t = t.T.contiguous() if leaf == "w" else t
            name = "weight" if leaf == "w" else "bias"
            if parts[0] == "head":
                state[f"head.{parts[1]}.{name}"] = t
            else:
                state[f"{parts[0]}.layers.{int(parts[1].lstrip('#'))}.{name}"] = t
        else:
            state[".".join(parts)] = t
    return state
