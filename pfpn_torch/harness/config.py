"""Declarative run configuration.

A copy of ``pfpn_tpu/harness/config.py`` (pure Python): the algorithm x
policy-head x env settings as frozen dataclasses, the derived env count,
minibatch size and run directories, and the DPPO-PFPN resample-interval
rule.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class HeadSettings:
    kind: str = "particle"            # "particle" | "gaussian" | "discrete"
    particles: Optional[int] = 35     # per action dimension
    init_sigma: Optional[float] = None
    fixed_sigma: bool = False
    resample: int = -1
    resample_interval: int = 2000
    resample_threshold: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class NetworkSettings:
    common_shape: tuple = ()
    actor_shape: tuple = (1024, 512)
    critic_shape: tuple = (1024, 512)
    lstm: Optional[int] = None
    gamma: float = 0.95
    lambd: float = 0.95
    value_loss_coef: float = 0.5
    normalize_state: bool = True
    clip_state: Optional[float] = 5.0
    normalize_value: bool = False
    clip_value: Optional[float] = None
    normalize_advantage: bool = False
    clip_advantage: Optional[float] = None
    entropy_beta: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class WorkerSettings:
    lr_critic: float = 1e-4
    lr_actor: float = 5e-6
    norm_clip: Optional[float] = 1.0
    opt_epochs: Optional[int] = 1
    batch_size: int = 32              # per-worker minibatch (reference units)
    unroll_length: int = 512
    buffer_capacity: int = 1_000_000
    observations: int = 0


@dataclasses.dataclass(frozen=True)
class RunConfig:
    name: str
    algo: str
    head: HeadSettings
    network: NetworkSettings
    worker: WorkerSettings
    workers: int = 8
    env: str = "DeepMimicWalk-v0"
    seed: int = 1
    max_samples: int = 15_000_000
    save_checkpoint_interval: int = 1000
    suffix: str = ""
    env_multiplier: int = 1

    @property
    def num_envs(self) -> int:
        return self.workers * self.env_multiplier

    @property
    def minibatch_size(self) -> int:
        """The reference aggregates ``workers`` gradients of ``batch_size``
        samples each: one minibatch of workers x batch (config.py:86)."""
        return self.worker.batch_size * self.workers * self.env_multiplier

    def _dir_suffix(self) -> str:
        suffix = ""
        if self.head.kind in ("particle", "discrete") and self.head.particles:
            suffix = f"_particle{self.head.particles}"
        if self.suffix:
            suffix += f"_{self.suffix}"
        return suffix

    def checkpoint_dir(self, root: str = ".") -> str:
        return f"{root}/ckpt_{self.env}/{self.name}{self._dir_suffix()}/{self.seed}"

    def log_dir(self, root: str = ".") -> str:
        return f"{root}/log_{self.env}/{self.name}{self._dir_suffix()}/{self.seed}"


def dppo_pfpn_resample_interval(worker: WorkerSettings, soft: bool = False) -> int:
    """~20 episodes of 600 steps as optimizer iterations (config.py:112)."""
    resample_every_episodes = 20
    episode_length = 600
    iterations_per_roll = (
        worker.unroll_length / worker.batch_size * (worker.opt_epochs or 1))
    rolls = round(episode_length * resample_every_episodes / worker.unroll_length)
    if soft:
        return int(rolls * worker.unroll_length)
    return int(rolls * iterations_per_roll)

