"""Named run presets. Counterpart of ``pfpn_tpu/harness/settings.py``;
this slice ports the headline preset, ``deepmimic_dppo_pfpn``
(``settings.py:62-71``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from .config import (
    HeadSettings, NetworkSettings, RunConfig, WorkerSettings,
    dppo_pfpn_resample_interval,
)


def build(setting: str, particles: Optional[int] = None,
          env: str = "DeepMimicWalk-v0", seed: int = 1,
          max_samples: int = 15_000_000, soft: bool = False,
          env_multiplier: int = 1) -> RunConfig:
    name = setting.split(".")[-1]
    if name != "deepmimic_dppo_pfpn":
        raise NotImplementedError(f"setting {setting!r} is not ported yet")
    worker = dataclasses.replace(
        WorkerSettings(), norm_clip=1.0, opt_epochs=1, batch_size=32,
        unroll_length=512, lr_actor=1e-4)
    head = HeadSettings(kind="particle", particles=particles or 35, resample=-1,
                        resample_interval=dppo_pfpn_resample_interval(worker, soft))
    net = dataclasses.replace(NetworkSettings(), normalize_advantage=True)
    return RunConfig(name=name, algo="ppo", head=head, network=net,
                     worker=worker, workers=8, env=env, seed=seed,
                     max_samples=max_samples, env_multiplier=env_multiplier)
