"""Stateful gym-style adapter over the batched DeepMimic env.

Counterpart of ``pfpn_tpu/envs/gym_adapter.py``: a mutable-attribute
``Box`` space and an ``Env`` with ``reset() -> obs`` and ``step(a) -> (obs,
reward, done, info)``, for driving one environment interactively. Training
never uses it. :class:`GymEnv` holds a batch of one on the env's device:
``reset`` is ``reset_batch(1, generator)``, ``step`` is the env's
``step`` (one megastep launch on the card) followed by one host copy of
the observation, reward and flags.

As in JAX:

* ``info["TimeLimit.truncated"]`` is True when the episode ended by its
  time limit rather than a fall;
* ``Box`` keeps ``shape``, ``low`` and ``high`` as plain mutable
  attributes, so wrappers can rewrite them;
* ``seed(s)`` reseeds the reset-phase stream: here a ``torch.Generator``
  on the env's device, not JAX's ``PRNGKey``, so the two packages draw
  different phases from one seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Space:
    """Minimal space base."""

    def __init__(self, shape=None):
        self.np_random = np.random.RandomState()
        self.shape = shape

    def contains(self, x):
        raise NotImplementedError

    def sample(self):
        raise NotImplementedError


class Box(Space):
    """Mutable-attribute Box."""

    def __init__(self, low=None, high=None, shape=None):
        self.low = low
        self.high = high
        if shape is None:
            shape = np.array(self.low).shape
        super().__init__(shape)

    def contains(self, x):
        x = np.asarray(x)
        return bool(np.all(x >= self.low) and np.all(x <= self.high))

    def sample(self):
        low = np.broadcast_to(np.asarray(self.low, np.float64), self.shape)
        high = np.broadcast_to(np.asarray(self.high, np.float64), self.shape)
        if np.all(np.isfinite(low)) and np.all(np.isfinite(high)):
            return self.np_random.uniform(low, high)
        # unbounded dims, as gym's Box: normal where both sides are open,
        # exponential offsets where one is
        out = self.np_random.normal(size=self.shape)
        lo_fin, hi_fin = np.isfinite(low), np.isfinite(high)
        both = lo_fin & hi_fin
        out = np.where(both, self.np_random.uniform(
            np.where(both, low, 0.0), np.where(both, high, 1.0)), out)
        only_lo = lo_fin & ~hi_fin
        out = np.where(only_lo, np.where(lo_fin, low, 0.0)
                       + self.np_random.exponential(size=self.shape), out)
        only_hi = ~lo_fin & hi_fin
        out = np.where(only_hi, np.where(hi_fin, high, 0.0)
                       - self.np_random.exponential(size=self.shape), out)
        return out

    def __repr__(self):
        return "Box({})".format(self.shape)

    def __eq__(self, rhs):
        return (np.array_equal(self.low, getattr(rhs, "low", None))
                and np.array_equal(self.high, getattr(rhs, "high", None)))


class Env:
    """Stateful env base."""

    name = None
    action_space = None
    observation_space = None
    reward_range = (-math.inf, math.inf)

    def step(self, action):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def render(self):
        raise NotImplementedError

    def close(self):
        return

    def seed(self, seed):
        return

    def __str__(self):
        if self.name is None:
            return "<{} instance>".format(type(self).__name__)
        return self.name


class GymEnv(Env):
    """One stateful environment over a batched env
    (:class:`~pfpn_torch.envs.deepmimic.DeepMimicEnv` or a wrapper with its
    ``reset_batch`` / ``step`` surface), as a batch of one."""

    def __init__(self, env, seed: int = 0):
        self.env = env
        self.name = (f"DeepMimic{env.motion_name.capitalize()}-v0"
                     if hasattr(env, "motion_name") else None)
        if getattr(env, "action_low", None) is not None:
            self.action_space = Box(low=np.asarray(env.action_low),
                                    high=np.asarray(env.action_high))
        else:  # discrete-wrapped: shape only, low/high dropped
            self.action_space = Box(shape=[env.action_size])
            self.action_space.low = None
            self.action_space.high = None
        obs_dim = env.observation_size
        self.observation_space = Box(
            low=np.full(obs_dim, -np.inf, dtype=np.float32),
            high=np.full(obs_dim, np.inf, dtype=np.float32))
        self.reward_range = (0.0, 1.0)
        self._state = None
        self._generator = torch.Generator(device=env.device)
        self.seed(seed)

    def seed(self, seed):
        self._generator.manual_seed(int(seed))

    def reset(self):
        self._state, obs = self.env.reset_batch(1, self._generator)
        return obs[0].cpu().numpy()

    def reset_at(self, init_time: float):
        """Reset to the reference pose at ``init_time`` seconds."""
        t = torch.tensor([float(init_time)], device=self.env.device)
        self._state, obs = self.env.reset_at(t)
        return obs[0].cpu().numpy()

    def step(self, action):
        assert self._state is not None, "call reset() before step()"
        a = torch.as_tensor(np.asarray(action, dtype=np.float32),
                            device=self.env.device)[None]
        res = self.env.step(self._state, a)
        self._state = res.state
        # one host copy of everything the caller reads
        host = torch.cat([res.obs[0], torch.stack([
            res.reward[0], res.done[0].float(), res.truncated[0].float()])]).cpu().numpy()
        n = res.obs.shape[-1]
        info = {"TimeLimit.truncated": bool(host[n + 2] > 0.5)}
        return host[:n].copy(), float(host[n]), bool(host[n + 1] > 0.5), info

    def render(self):
        # trajectories are exported (harness/eval.py) instead of a live GUI
        return None

    def __getattr__(self, name):
        # guard against infinite recursion when 'env' itself is missing
        # (copy/pickle create instances without running __init__)
        if name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)
