"""Checkpoints of the whole training state through ``torch.save``.

Counterpart of ``pfpn_tpu/harness/checkpoint.py``, in the port's own
format: one ``<step>.pt`` file per checkpoint in
``RunConfig.checkpoint_dir`` (the JAX package's directory scheme), holding
the parameters and normalizer, the Adam state, the PFPN activation
statistics, the env states and observations, the generator's state, the
counters and the episode returns. Resume is implicit: :meth:`restore_latest`
at startup. Only tensors, numbers and containers are stored, so files load
with ``weights_only=True``. Reading the JAX package's orbax checkpoints is
not supported.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Optional

import torch

from ..algos.ppo import PPOState

_FILE = re.compile(r"^(\d+)\.pt$")


def _to_tree(x: Any) -> Any:
    """Dataclasses (env and sim states) -> dicts of their fields."""
    if dataclasses.is_dataclass(x):
        return {f.name: _to_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return x


def _from_tree(template: Any, tree: Any, device) -> Any:
    """Rebuild ``template``'s structure from ``tree`` with tensors on ``device``."""
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _from_tree(getattr(template, f.name), tree[f.name], device)
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _from_tree(template[k], tree[k], device) for k in template}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


class CheckpointManager:
    """The checkpoints of one run directory; only the newest is kept, as
    the JAX package keeps one."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        return sorted(int(m.group(1)) for m in map(_FILE.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state: PPOState) -> str:
        """Write ``<step>.pt`` (through a temporary file, so a crash leaves
        no partial checkpoint) and drop the older ones."""
        payload = {
            "net": state.net.state_dict(),
            "opt": state.opt.state_dict(),
            "head_stats": state.head_stats,
            "env_state": _to_tree(state.env_state),
            "obs": state.obs,
            "generator": state.generator.get_state(),
            "global_step": state.global_step,
            "total_samples": state.total_samples,
            "ep_return": state.ep_return,
            "last_ep_return": state.last_ep_return,
        }
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-1]:
            os.unlink(self.path(old))
        return path

    def restore_latest(self, state: PPOState) -> Optional[PPOState]:
        """Load the newest checkpoint into ``state`` (its module and
        optimizer in place) and return the restored state, or None when the
        directory holds none."""
        step = self.latest_step()
        if step is None:
            return None
        ck = torch.load(self.path(step), map_location="cpu", weights_only=True)
        device = state.obs.device
        state.net.load_state_dict(ck["net"])
        state.opt.load_state_dict(ck["opt"])
        state.generator.set_state(ck["generator"])
        return state.replace(
            head_stats=_from_tree(state.head_stats, ck["head_stats"], device),
            env_state=_from_tree(state.env_state, ck["env_state"], device),
            obs=ck["obs"].to(device),
            global_step=int(ck["global_step"]),
            total_samples=int(ck["total_samples"]),
            ep_return=ck["ep_return"].to(device),
            last_ep_return=ck["last_ep_return"].to(device))
