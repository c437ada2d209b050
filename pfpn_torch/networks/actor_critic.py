"""Actor-critic network as an ``nn.Module``.

Counterpart of ``pfpn_tpu/networks/actor_critic.py``: clipped state
normalizer -> optional shared trunk -> actor MLP (relu6 after every layer)
+ policy head (Gaussian, categorical or particle); critic MLP -> value.
The module holds the trainable parameters and the normalizer's buffers;
:class:`ACConfig` carries the loss settings PPO reads. Ported:
initialization (:meth:`ActorCritic.init_parameters`,
``actor_critic.py:81``), :meth:`~ActorCritic.init_stats`, the policy API
(``act``, ``act_deterministic``, ``log_prob``, ``entropy``, ``value``,
``:149-178``), the value normalization's view of the critic
(``raw_value``, ``normalized_value``, and ``value`` and ``act`` given the
:class:`~pfpn_torch.networks.value_norm.ValueNormState`, ``:129-161``) with
the straight-through value clip (:func:`clip_with_gradient`, ``:31-48``),
and :func:`load_jax_params` and :func:`export_jax_params`, which carry
weights between the packages: the off-policy networks' too
(``algos/sac.py``'s ``q1``, ``q2`` and the 0-d ``log_alpha``) and the
recurrent network's LSTM (``networks/recurrent_ac.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .heads import HeadConfig, ParticleHead, head_module, init_activation_stats
from .mlp import MLP
from .normalizer import Normalizer
from .value_norm import ValueNormState


class _ClipWithGradient(torch.autograd.Function):
    """Hard clip forward, identity gradient backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None, None


def clip_with_gradient(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Straight-through clip (``_clip_with_gradient``, actor_critic.py:31;
    reference networks/ops.py:4-9): a critic output outside the clip band
    keeps a nonzero value-loss gradient and can recover."""
    return _ClipWithGradient.apply(x, lo, hi)


@dataclasses.dataclass(frozen=True)
class ACConfig:
    obs_dim: int
    head: HeadConfig
    common_shape: Tuple[int, ...] = ()
    actor_shape: Tuple[int, ...] = (1024, 512)
    critic_shape: Tuple[int, ...] = (1024, 512)
    normalize_state: bool = True
    clip_state: Optional[float] = 5.0
    # value-target normalization (actor_critic.py:46-48; off in every
    # shipped preset)
    normalize_value: bool = False
    clip_value: Optional[float] = None
    # loss coefficients (actor_critic.py:101-184)
    value_loss_coef: float = 0.5
    entropy_beta: Optional[float] = None
    normalize_advantage: bool = False
    clip_advantage: Optional[float] = None
    # returns
    gamma: float = 0.95
    lambd: float = 0.95


class ActorCritic(nn.Module):
    """``with_critic=False`` leaves out the value MLP, as SAC's parameters
    do (``algos/sac.py:135-136``)."""

    def __init__(self, cfg: ACConfig, with_critic: bool = True):
        super().__init__()
        self.cfg = cfg
        self.norm = Normalizer((cfg.obs_dim,))
        feat = self._build_trunk(cfg)
        actor_feat = feat
        self.actor_trunk = None
        if cfg.actor_shape:
            self.actor_trunk = MLP([feat, *cfg.actor_shape], last_activation=F.relu6)
            actor_feat = cfg.actor_shape[-1]
        self.head = head_module(cfg.head, actor_feat)
        self.critic = MLP([feat, *cfg.critic_shape, 1]) if with_critic else None

    def _build_trunk(self, cfg: ACConfig) -> int:
        """Sets ``self.common``, the trunk both sides read, and returns its
        output width."""
        self.common = None
        if not cfg.common_shape:
            return cfg.obs_dim
        self.common = MLP([cfg.obs_dim, *cfg.common_shape], last_activation=F.relu6)
        return cfg.common_shape[-1]

    def init_parameters(self, generator: Optional[torch.Generator]) -> None:
        """The reference's initialization (actor_critic.py:81): every trunk
        and the critic truncated-normal, the head as its kind is initialized
        (for the particle head, its grid). The normalizer keeps its state."""
        for part in (self.common, self.actor_trunk, self.head, self.critic):
            if part is not None:
                part.init_parameters(generator)

    @property
    def is_pfpn(self) -> bool:
        return isinstance(self.cfg.head, ParticleHead)

    def init_stats(self) -> Dict:
        """The particle head's resampling accumulators, none for the other
        heads (actor_critic.py:101-104)."""
        if not self.is_pfpn:
            return {}
        return init_activation_stats(self.cfg.head, self.head.particles.device)

    def normalized(self, obs: torch.Tensor) -> torch.Tensor:
        """The clipped, normalized observation (actor_critic.py:106)."""
        cfg = self.cfg
        if cfg.normalize_state:
            return self.norm(obs, clip=cfg.clip_state)
        if cfg.clip_state:
            return torch.clamp(obs, -cfg.clip_state, cfg.clip_state)
        return obs

    def _features(self, obs: torch.Tensor) -> torch.Tensor:
        x = self.normalized(obs)
        return self.common(x) if self.common is not None else x

    def actor_features(self, obs: torch.Tensor) -> torch.Tensor:
        x = self._features(obs)
        return self.actor_trunk(x) if self.actor_trunk is not None else x

    def raw_value(self, obs: torch.Tensor) -> torch.Tensor:
        """The critic MLP's output before any value (de)normalization."""
        return self.critic(self._features(obs))[..., 0]

    def normalized_value(self, obs: torch.Tensor,
                         vnorm: Optional[ValueNormState] = None) -> torch.Tensor:
        """The critic's output through the scale and offset when value
        normalization is on, then clipped straight-through when
        ``clip_value`` is set, also without normalization
        (actor_critic.py:134): what the value loss regresses against the
        normalized target."""
        cfg = self.cfg
        v = self.raw_value(obs)
        if cfg.normalize_value and vnorm is not None:
            v = v * vnorm.scale + vnorm.offset
        if cfg.clip_value:
            v = clip_with_gradient(v, -cfg.clip_value, cfg.clip_value)
        return v

    def value(self, obs: torch.Tensor,
              vnorm: Optional[ValueNormState] = None) -> torch.Tensor:
        """The denormalized value estimate, which GAE and the bootstraps
        take (actor_critic.py:148)."""
        v = self.normalized_value(obs, vnorm)
        if self.cfg.normalize_value and vnorm is not None:
            v = v * vnorm.std + vnorm.mean
        return v

    def dist(self, obs: torch.Tensor):
        return self.head.dist(self.actor_features(obs))

    def act_deterministic(self, obs: torch.Tensor) -> torch.Tensor:
        return self.head.deterministic_action(self.actor_features(obs))

    def act(self, obs: torch.Tensor, generator: Optional[torch.Generator],
            vnorm: Optional[ValueNormState] = None):
        """Sampled action, its log-prob, the value and aux (the rollout
        path, actor_critic.py:157)."""
        a, lp, aux = self.head.sample_with_log_prob(self.actor_features(obs), generator)
        return a, lp, self.value(obs, vnorm), aux

    def log_prob(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return self.head.log_prob_of(self.actor_features(obs), action)

    def entropy(self, obs: torch.Tensor) -> torch.Tensor:
        return self.head.entropy_of(self.actor_features(obs))


def load_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX package's flat ``params/...`` and ``norm/...`` arrays (the
    layout of ``tools/export_policy.py:25-55``, ``:130-139``) as an
    :class:`ActorCritic` state dict (fp32, CPU): ``params/<mlp>/#<i>/w``
    (in, out) becomes ``<mlp>.layers.<i>.weight`` (out, in); the head's
    linear layers (``fc_policy``, ``fc_mu``, ``fc_log_sigma``) likewise,
    its other arrays (``particles``, ``particles_log_std``, ``log_sigma``)
    keep their names and shapes, and so do a top-level array such as
    SAC's 0-d ``params/log_alpha`` and the recurrent network's
    ``params/lstm/wi``, ``wh`` and ``b``."""
    state: Dict[str, torch.Tensor] = {}
    for key, val in flat.items():
        t = torch.tensor(np.asarray(val, dtype=np.float32))
        parts = key.split("/")
        if parts[0] == "norm":
            state[f"norm.{parts[1]}"] = t
            continue
        if parts[0] != "params":
            raise KeyError(f"unexpected key {key!r}")
        parts = parts[1:]
        if len(parts) == 1:         # a top-level array (SAC's log_alpha)
            state[parts[0]] = t
        elif parts[0] == "lstm":    # (in, 4h), (h, 4h) and (4h,), as stored
            state[f"lstm.{parts[1]}"] = t
        elif parts[0] == "head":
            if len(parts) == 3:     # a linear layer of the head
                state[f"head.{parts[1]}.{_linear_name(parts[2])}"] = _linear(parts[2], t)
            else:
                state[f"head.{parts[1]}"] = t
        else:
            mlp, layer, leaf = parts
            idx = int(layer.lstrip("#"))
            state[f"{mlp}.layers.{idx}.{_linear_name(leaf)}"] = _linear(leaf, t)
    return state


def export_jax_params(net: nn.Module) -> Dict[str, np.ndarray]:
    """The reverse of :func:`load_jax_params`: ``net``'s parameters and
    normalizer as the JAX package's flat ``params/...`` and ``norm/...``
    arrays (fp32), weights back in (in, out)."""
    flat: Dict[str, np.ndarray] = {}
    for key, t in net.state_dict().items():
        a = t.detach().cpu().numpy()
        parts = key.split(".")
        if len(parts) == 1:         # a top-level array (SAC's log_alpha)
            flat[f"params/{key}"] = a
        elif parts[0] == "norm":
            flat[f"norm/{parts[1]}"] = a
        elif parts[0] == "lstm":
            flat[f"params/lstm/{parts[1]}"] = a
        elif parts[0] == "head":
            if len(parts) == 3:     # a linear layer of the head
                flat[f"params/head/{parts[1]}/{_leaf_name(parts[2])}"] = _unlinear(parts[2], a)
            else:
                flat[f"params/head/{parts[1]}"] = a
        else:
            mlp, _, idx, leaf = parts
            flat[f"params/{mlp}/#{idx}/{_leaf_name(leaf)}"] = _unlinear(leaf, a)
    return flat


def _leaf_name(name: str) -> str:
    return {"weight": "w", "bias": "b"}[name]


def _unlinear(name: str, a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.T) if name == "weight" else a


def _linear_name(leaf: str) -> str:
    return {"w": "weight", "b": "bias"}[leaf]


def _linear(leaf: str, t: torch.Tensor) -> torch.Tensor:
    return t.T.contiguous() if leaf == "w" else t
