"""Recurrent (LSTM) actor-critic with a carried state per env.

Counterpart of ``pfpn_tpu/networks/recurrent_ac.py``. The LSTM takes the
place of the shared trunk and both sides read its output:

    obs -> state normalizer -> LSTM -> actor MLP (relu6) -> policy head
                                    -> critic MLP -> value

Every policy and value method takes and returns an
:class:`~pfpn_torch.networks.recurrent.LSTMState` carry, one row per env.
The sequence methods run over time-major ``[T, B, ...]`` stacks and zero
the carry before step ``t`` where ``reset_before[t]`` is set (the step
after an episode ended), as the rollout does, so the update recomputes the
rollout's log-probs and values from the unroll's first carry. The value
takes neither value normalization nor the value clip, as in the JAX
package; ``algos/recurrent.py`` refuses value normalization.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .actor_critic import ACConfig, ActorCritic
from .recurrent import LSTM, LSTMState, lstm_cell


@dataclasses.dataclass(frozen=True)
class RecurrentACConfig(ACConfig):
    lstm_hidden: int = 128


class RecurrentActorCritic(ActorCritic):
    """:class:`ActorCritic`'s normalizer, actor MLP, head, critic and
    initialization around an LSTM trunk (``recurrent_ac.py:39``). The
    feed-forward methods that read no carry (``value``, ``log_prob``,
    ``entropy``, ``actor_features``) raise."""

    def _build_trunk(self, cfg: RecurrentACConfig) -> int:
        self.common = None
        self.lstm = LSTM(cfg.obs_dim, cfg.lstm_hidden)
        return cfg.lstm_hidden

    def _features(self, obs: torch.Tensor) -> torch.Tensor:
        raise TypeError("the recurrent network reads a carry: use act, act_deterministic, "
                        "value_step or sequence_outputs")

    def init_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.lstm.init_parameters(generator)
        super().init_parameters(generator)

    def zero_carry(self, batch: int) -> LSTMState:
        h = self.cfg.lstm_hidden
        dev = self.lstm.b.device
        return LSTMState(c=torch.zeros(batch, h, device=dev), h=torch.zeros(batch, h, device=dev))

    # -- one step (the rollout and evaluation) -----------------------------
    def _features_step(self, obs: torch.Tensor, carry: LSTMState):
        new_carry, h = lstm_cell(self.lstm, carry, self.normalized(obs))
        return h, new_carry

    def _actor_feat(self, h: torch.Tensor) -> torch.Tensor:
        return self.actor_trunk(h) if self.actor_trunk is not None else h

    def act(self, obs: torch.Tensor, generator: Optional[torch.Generator],
            carry: LSTMState):
        """(action, log_prob, value, aux, carry') (recurrent_ac.py:79)."""
        h, new_carry = self._features_step(obs, carry)
        a, lp, aux = self.head.sample_with_log_prob(self._actor_feat(h), generator)
        return a, lp, self.critic(h)[..., 0], aux, new_carry

    def act_deterministic(self, obs: torch.Tensor, carry: LSTMState):
        """(action, carry')."""
        h, new_carry = self._features_step(obs, carry)
        return self.head.deterministic_action(self._actor_feat(h)), new_carry

    def value_step(self, obs: torch.Tensor, carry: LSTMState):
        """(value, carry')."""
        h, new_carry = self._features_step(obs, carry)
        return self.critic(h)[..., 0], new_carry

    # -- sequences (the update) --------------------------------------------
    def sequence_features(self, obs_seq: torch.Tensor, carry0: LSTMState,
                          reset_before: torch.Tensor):
        """(h [T, B, hidden], the last carry) over ``obs_seq`` [T, B, obs]
        (recurrent_ac.py:99)."""
        carry, hs = carry0, []
        for t in range(obs_seq.shape[0]):
            keep = 1.0 - reset_before[t].to(obs_seq.dtype)[..., None]
            carry = LSTMState(c=carry.c * keep, h=carry.h * keep)
            carry, h = lstm_cell(self.lstm, carry, self.normalized(obs_seq[t]))
            hs.append(h)
        return torch.stack(hs), carry

    def sequence_outputs(self, obs_seq: torch.Tensor, action_seq: torch.Tensor,
                         carry0: LSTMState, reset_before: torch.Tensor,
                         want_entropy: bool = False):
        """(log_prob [T, B], value [T, B], entropy [T, B] or None) of the
        stored actions, with gradients (recurrent_ac.py:121)."""
        hs, _ = self.sequence_features(obs_seq, carry0, reset_before)
        t, b = hs.shape[0], hs.shape[1]
        h_flat = hs.reshape(t * b, -1)
        feat = self._actor_feat(h_flat)
        a_flat = action_seq.reshape((t * b,) + action_seq.shape[2:])
        lp = self.head.log_prob_of(feat, a_flat).reshape(t, b)
        v = self.critic(h_flat)[..., 0].reshape(t, b)
        ent = self.head.entropy_of(feat).reshape(t, b) if want_entropy else None
        return lp, v, ent
