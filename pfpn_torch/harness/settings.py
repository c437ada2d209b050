"""Named run presets. Counterpart of ``pfpn_tpu/harness/settings.py``,
all thirteen of its settings: the DPPO presets (``settings.py:62-87``): the
particle head (``deepmimic_dppo_pfpn``, the headline), the Gaussian head
(``deepmimic_dppo_gauss``) and the discretized action space
(``deepmimic_dppo_dis``); the A3C and IMPALA presets (``:89-137``), each
with the same three heads and an entropy bonus of 2.5e-4; and the
off-policy presets (``:139-172``): ``deepmimic_sac_pfpn``,
``deepmimic_sac_gauss``, ``deepmimic_ddpg_pfpn`` and
``deepmimic_ddpg_gauss``, one env (the reference's exact loop) times
``env_multiplier``."""

from __future__ import annotations

import dataclasses
from typing import Optional

from .config import (
    HeadSettings, NetworkSettings, RunConfig, WorkerSettings,
    dppo_pfpn_resample_interval,
)

def _dppo_worker(**kw) -> WorkerSettings:
    # deepmimic_dppo_base.py:6-11; lr_actor stays 5e-6 (deepmimic_base.py)
    # unless a preset sets it
    return dataclasses.replace(WorkerSettings(), norm_clip=1.0, opt_epochs=1,
                               batch_size=32, unroll_length=512, **kw)


def _a3c_worker(**kw) -> WorkerSettings:
    # deepmimic_a3c_base.py:6-12
    return dataclasses.replace(WorkerSettings(), norm_clip=0.5, opt_epochs=1,
                               batch_size=32, unroll_length=32, **kw)


def _impala_worker(**kw) -> WorkerSettings:
    # deepmimic_impala_base.py:6-12
    return dataclasses.replace(WorkerSettings(), norm_clip=0.5, opt_epochs=1,
                               batch_size=4, unroll_length=64, **kw)


# the A3C and IMPALA presets: (algo, worker, workers, the PFPN resample
# interval: 12000 * 16 / 32 (deepmimic_a3c_pfpn.py:7) and 12000 * 32 / 4 / 64
# (deepmimic_impala_pfpn.py:7))
_ASYNC = {"a3c": ("a2c", _a3c_worker, 16, int(12000 * 16 / 32)),
          "impala": ("vtrace", _impala_worker, 32, int(12000 * 32 / 4 / 64))}


def _sac_worker(**kw) -> WorkerSettings:
    # deepmimic_sac_base.py:4-13: one batch-256 gradient step per sample
    return dataclasses.replace(WorkerSettings(), norm_clip=1.0, opt_epochs=None,
                               batch_size=256, unroll_length=1,
                               buffer_capacity=1_000_000, observations=0, **kw)


# the off-policy presets: (algo, head kind, lr_actor of 1e-4 for the PFPN head)
_OFF_POLICY = {"deepmimic_sac_pfpn": ("sac", "particle"),
               "deepmimic_sac_gauss": ("sac", "gaussian"),
               "deepmimic_ddpg_pfpn": ("ddpg", "particle"),
               "deepmimic_ddpg_gauss": ("ddpg", "gaussian")}


def build(setting: str, particles: Optional[int] = None,
          env: str = "DeepMimicWalk-v0", seed: int = 1,
          max_samples: int = 15_000_000, soft: bool = False,
          env_multiplier: int = 1) -> RunConfig:
    name = setting.split(".")[-1]
    family, _, kind = name[len("deepmimic_"):].partition("_")
    if name.startswith("deepmimic_") and family in _ASYNC and kind in ("pfpn", "gauss", "dis"):
        algo, make_worker, workers, interval = _ASYNC[family]
        if kind == "pfpn":
            worker = make_worker(lr_actor=1e-4)
            head = HeadSettings(kind="particle", particles=particles or 35, resample=-1,
                                resample_interval=interval)
        elif kind == "gauss":
            worker = make_worker()
            head = HeadSettings(kind="gaussian", particles=None)
        else:
            worker = make_worker(lr_actor=1e-4)
            head = HeadSettings(kind="discrete", particles=particles or 35)
        net = dataclasses.replace(NetworkSettings(), entropy_beta=2.5e-4)
        return RunConfig(name=name, algo=algo, head=head, network=net, worker=worker,
                         workers=workers, env=env, seed=seed, max_samples=max_samples,
                         env_multiplier=env_multiplier)
    if name in _OFF_POLICY:
        algo, kind = _OFF_POLICY[name]
        if kind == "particle":
            worker = _sac_worker(lr_actor=1e-4)
            # deepmimic_sac_pfpn.py:6
            head = HeadSettings(kind="particle", particles=particles or 35, resample=-1,
                                resample_interval=12000)
        else:
            worker = _sac_worker()
            head = HeadSettings(kind="gaussian", particles=None)
        return RunConfig(name=name, algo=algo, head=head, network=NetworkSettings(),
                         worker=worker, workers=1, env=env, seed=seed,
                         max_samples=max_samples, env_multiplier=env_multiplier)
    if name == "deepmimic_dppo_pfpn":
        worker = _dppo_worker(lr_actor=1e-4)
        head = HeadSettings(kind="particle", particles=particles or 35, resample=-1,
                            resample_interval=dppo_pfpn_resample_interval(worker, soft))
    elif name == "deepmimic_dppo_gauss":
        worker = _dppo_worker()
        head = HeadSettings(kind="gaussian", particles=None, init_sigma=0.05)
    elif name == "deepmimic_dppo_dis":
        worker = _dppo_worker(lr_actor=1e-4)
        head = HeadSettings(kind="discrete", particles=particles or 35)
    else:
        raise KeyError(f"unknown setting: {setting}")
    net = dataclasses.replace(NetworkSettings(), normalize_advantage=True)
    return RunConfig(name=name, algo="ppo", head=head, network=net,
                     worker=worker, workers=8, env=env, seed=seed,
                     max_samples=max_samples, env_multiplier=env_multiplier)
