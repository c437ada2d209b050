"""Checkpoints of the whole training state through ``torch.save``.

Counterpart of ``pfpn_tpu/harness/checkpoint.py``, in the port's own
format: one ``<step>.pt`` file per checkpoint in
``RunConfig.checkpoint_dir`` (the JAX package's directory scheme), holding
every field of the run's state (``PPOState`` or ``SACState``): the
parameters and normalizer (and SAC's targets), the Adam state, the PFPN
activation statistics, the env states and observations, the generator's
state, the counters and the episode returns, the value normalizer and the
recurrent net's LSTM carry. The off-policy replay ring is not saved
(``checkpoint.py:10-28``): a restored run keeps its template's fresh, empty
ring. A field or entry the file lacks (a checkpoint written before the
field existed) keeps its template's value, as the JAX package's ``_graft``
keeps it (``checkpoint.py:60-97``). Resume is implicit:
:meth:`restore_latest` at startup.
Only tensors, numbers and containers are stored, so files load with
``weights_only=True``. Reading the JAX package's orbax checkpoints is not
supported.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Optional

import torch
from torch import nn

from ..algos.ppo import ClippedAdam

_FILE = re.compile(r"^(\d+)\.pt$")
_SKIP_FIELDS = ("buffer",)     # the replay ring


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _to_tree(x: Any) -> Any:
    """Dataclasses (env and sim states) and NamedTuples (the value
    normalizer, the LSTM carry) -> dicts of their fields."""
    if dataclasses.is_dataclass(x):
        return {f.name: _to_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if _is_namedtuple(x):
        return {k: _to_tree(v) for k, v in x._asdict().items()}
    return x


def _from_tree(template: Any, tree: Any, device) -> Any:
    """Rebuild ``template``'s structure from ``tree`` with tensors on
    ``device``; what ``tree`` lacks keeps the template's value."""
    if isinstance(template, dict) or dataclasses.is_dataclass(template) \
            or _is_namedtuple(template):
        if not isinstance(tree, dict):
            return template
        if isinstance(template, dict):
            return {k: _from_tree(v, tree.get(k, v), device) for k, v in template.items()}
        names = ([f.name for f in dataclasses.fields(template)]
                 if dataclasses.is_dataclass(template) else template._fields)
        fields = {k: _from_tree(getattr(template, k), tree.get(k, getattr(template, k)), device)
                  for k in names}
        if _is_namedtuple(template):
            return type(template)(**fields)
        return dataclasses.replace(template, **fields)
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

    def save(self, step: int, state: Any) -> str:
        """Write ``<step>.pt`` (through a temporary file, so a crash leaves
        no partial checkpoint) and drop the older ones."""
        payload = {}
        for f in dataclasses.fields(state):
            v = getattr(state, f.name)
            if f.name in _SKIP_FIELDS:
                continue
            if isinstance(v, (nn.Module, ClippedAdam)):
                payload[f.name] = v.state_dict()
            elif isinstance(v, torch.Generator):
                payload[f.name] = v.get_state()
            else:
                payload[f.name] = _to_tree(v)
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-1]:
            os.unlink(self.path(old))
        return path

    def restore_latest(self, state: Any) -> Optional[Any]:
        """Load the newest checkpoint into ``state`` (its modules and
        optimizer in place) and return the restored state, or None when the
        directory holds none."""
        step = self.latest_step()
        if step is None:
            return None
        ck = torch.load(self.path(step), map_location="cpu", weights_only=True)
        device = state.obs.device
        fields = {}
        for f in dataclasses.fields(state):
            v = getattr(state, f.name)
            if f.name in _SKIP_FIELDS:
                continue
            if f.name not in ck:          # saved before the field existed
                continue
            if isinstance(v, (nn.Module, ClippedAdam)):
                v.load_state_dict(ck[f.name])
            elif isinstance(v, torch.Generator):
                v.set_state(ck[f.name])
            else:
                fields[f.name] = _from_tree(v, ck[f.name], device)
        return state.replace(**fields)
