"""Multi-task DeepMimic batch: one env batch spanning several motions.

Counterpart of ``pfpn_tpu/envs/multitask.py``. Task assignment is static
per slot: contiguous slice k of the batch always imitates motion k, as even
as possible with the remainder to the first tasks (B = 8 over three motions
gives 3/3/2). Each slice steps through its own :class:`DeepMimicEnv`, so an
env step launches the megastep once per task, as the JAX package compiles
one subgraph per motion. Auto-reset keeps a slot on its task. With
``task_obs`` a one-hot task id is appended to the observation.

The batched API takes ``(batch, generator)`` where JAX takes keys; every
call that draws (``reset_batch``, ``step_autoreset``) draws from the one
generator slice by slice, in task order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..sim.types import tree_map
from .deepmimic import DeepMimicEnv, EnvState, StepResult


class MultiTaskEnv:
    """Batched multi-motion env with :class:`DeepMimicEnv`'s batched API
    (``reset_batch``, ``reset_at``, ``step_batch``, ``step_autoreset``)."""

    def __init__(self, motions: Sequence[str] = ("walk", "punch", "kick"),
                 task_obs: bool = False, device=None, **kwargs):
        if len(motions) < 1:
            raise ValueError("need at least one motion")
        self.motions = tuple(motions)
        self.envs = [DeepMimicEnv(motion=m, device=device, **kwargs) for m in motions]
        self.num_tasks = len(self.envs)
        self.task_obs = task_obs
        e0 = self.envs[0]
        self.device = e0.device
        self.engine = e0.engine          # the first task's; every task's is alike
        self.tree = e0.tree
        self.observation_size = e0.observation_size + (self.num_tasks if task_obs else 0)
        self.action_size = e0.action_size
        self.action_low = e0.action_low
        self.action_high = e0.action_high
        for e in self.envs[1:]:
            assert e.observation_size == e0.observation_size
            assert e.action_size == e0.action_size

    # -- helpers ----------------------------------------------------------
    def _sizes(self, batch: int) -> List[int]:
        """Per-task slice sizes, the remainder to the first tasks."""
        base, rem = divmod(batch, self.num_tasks)
        return [base + (1 if k < rem else 0) for k in range(self.num_tasks)]

    def _tasks(self, batch: int):
        """(env, slice of the batch) of each task that has slots; with
        fewer slots than tasks the last tasks have none."""
        offsets = np.cumsum([0] + self._sizes(batch))
        return [(env, slice(int(offsets[k]), int(offsets[k + 1])))
                for k, env in enumerate(self.envs) if offsets[k + 1] > offsets[k]]

    @staticmethod
    def _take(states: EnvState, s: slice) -> EnvState:
        return tree_map(lambda a: a[s], states)

    @staticmethod
    def _concat(parts):
        if isinstance(parts[0], torch.Tensor):
            return torch.cat(parts, 0)
        return tree_map(lambda *xs: torch.cat(xs, 0), *parts)

    def _concat_results(self, parts) -> StepResult:
        res = StepResult(*[self._concat([getattr(p, f) for p in parts])
                           for f in StepResult._fields])
        return res._replace(obs=self._with_task_obs(res.obs))

    def task_ids(self, batch: int) -> np.ndarray:
        """Each slot's task index."""
        return np.repeat(np.arange(self.num_tasks), self._sizes(batch))

    def _with_task_obs(self, obs: torch.Tensor) -> torch.Tensor:
        if not self.task_obs:
            return obs
        onehot = torch.as_tensor(
            np.eye(self.num_tasks, dtype=np.float32)[self.task_ids(obs.shape[0])],
            dtype=obs.dtype, device=obs.device)
        return torch.cat([obs, onehot], -1)

    # -- batched API ------------------------------------------------------
    def reset_batch(self, batch: int, generator: Optional[torch.Generator] = None):
        parts = [env.reset_batch(s.stop - s.start, generator) for env, s in self._tasks(batch)]
        return (self._concat([p[0] for p in parts]),
                self._with_task_obs(self._concat([p[1] for p in parts])))

    def reset_at(self, init_time: torch.Tensor):
        """Reset slot i to its task's reference pose at ``init_time[i]``."""
        parts = [env.reset_at(init_time[s]) for env, s in self._tasks(init_time.shape[0])]
        return (self._concat([p[0] for p in parts]),
                self._with_task_obs(self._concat([p[1] for p in parts])))

    def step_batch(self, states: EnvState, actions: torch.Tensor) -> StepResult:
        return self._concat_results([
            env.step_batch(self._take(states, s), actions[s])
            for env, s in self._tasks(actions.shape[0])])

    def step_autoreset(self, states: EnvState, actions: torch.Tensor,
                       generator: Optional[torch.Generator] = None):
        """Per task: step, and reset the slots whose episode ended. Returns
        (new_states, new_obs, StepResult of the pre-reset transition)."""
        parts = [env.step_autoreset(self._take(states, s), actions[s], generator)
                 for env, s in self._tasks(actions.shape[0])]
        return (self._concat([p[0] for p in parts]),
                self._with_task_obs(self._concat([p[1] for p in parts])),
                self._concat_results([p[2] for p in parts]))
