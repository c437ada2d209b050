"""A2C's update in plain PyTorch: GAE, the loss, the clip and Adam.

A frozen copy of what ``pfpn_torch/algos/a2c.py`` takes from
``pfpn_torch/algos/ppo.py`` and ``gae.py`` for a round of one minibatch:
GAE with 0 bootstrapped on true terminals and V(next pre-reset
observation) elsewhere; the loss -mean(log_prob * advantage) - beta
mean(entropy) + c mean((V - (V_old + advantage))^2); the gradients
clipped by their global norm, then Adam (b1 0.9, b2 0.999, eps 1e-8);
then the observation normalizer's moving average over the round's
observations at the new optimizer step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from .policy import ActorCritic


@dataclasses.dataclass(frozen=True)
class A2CSettings:
    gamma: float = 0.95
    lambd: float = 0.95
    value_loss_coef: float = 0.5
    entropy_beta: float = 2.5e-4
    lr: float = 1e-4
    norm_clip: float = 0.5


def gae(rewards, values, next_values, terminated, done, gamma: float,
        lambd: float) -> torch.Tensor:
    """Time-major (T, B) advantages; the carry stops at every done."""
    not_term = 1.0 - terminated.to(rewards.dtype)
    not_done = 1.0 - done.to(rewards.dtype)
    delta = rewards + gamma * not_term * next_values - values
    adv = torch.empty_like(delta)
    carry = torch.zeros_like(delta[-1])
    for t in range(delta.shape[0] - 1, -1, -1):
        carry = delta[t] + gamma * lambd * not_done[t] * carry
        adv[t] = carry
    return adv


class A2CReference:
    """One network, its Adam state and the optimizer-step count."""

    def __init__(self, net: ActorCritic, cfg: A2CSettings = A2CSettings()):
        self.net, self.cfg = net, cfg
        self.params: List[torch.nn.Parameter] = list(net.parameters())
        self.adam = torch.optim.Adam(self.params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        self.global_step = 0

    def advantages(self, traj: Dict[str, torch.Tensor]) -> torch.Tensor:
        """GAE over the round, values taken by this network."""
        cfg = self.cfg
        with torch.no_grad():
            v = self.net.value(traj["obs"])
            v_next = self.net.value(traj["next_obs"])
        return gae(traj["reward"], v, v_next, traj["terminated"], traj["done"],
                   cfg.gamma, cfg.lambd), v

    def loss(self, obs, action, adv, v_old) -> torch.Tensor:
        cfg, net = self.cfg, self.net
        lp = net.log_prob(obs, action)
        v = net.value(obs)
        policy_loss = -torch.mean(lp * adv) - cfg.entropy_beta * torch.mean(net.entropy(obs))
        value_loss = torch.mean((v - (v_old + adv)) ** 2)
        return policy_loss + cfg.value_loss_coef * value_loss

    def update(self, traj: Dict[str, torch.Tensor]):
        """One optimizer step over the whole round. Returns (loss, the
        clipped gradients as Adam takes them, by parameter name)."""
        adv, v_old = self.advantages(traj)
        flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
        obs, action = flat(traj["obs"]), flat(traj["action"])
        self.adam.zero_grad(set_to_none=True)
        loss = self.loss(obs, action, flat(adv), flat(v_old))
        loss.backward()
        with torch.no_grad():
            grads = [p.grad for p in self.params]
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            if norm >= self.cfg.norm_clip:
                for g in grads:
                    g.mul_(self.cfg.norm_clip / norm)
            clipped = {n: p.grad.clone() for n, p in self.net.named_parameters()}
        self.adam.step()
        self.global_step += 1
        self.net.norm.update_moving_average(obs, self.global_step)
        return float(loss.detach()), clipped
