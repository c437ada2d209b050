"""Data-parallel training over ``torch.distributed``: one process per card.

Counterpart of ``pfpn_tpu/distributed/mesh.py``. JAX shards the env batch
over a device mesh and lets GSPMD insert the gradient all-reduce; here each
rank is a process (``torchrun`` or the five variables by hand) on its own
device, NCCL between cards and gloo on the CPU. The fields named in
:data:`DATA_FIELDS` (per-env state, leading axis ``num_envs``) are split by
rank along the env axis, chosen by field name and never by shape; every
other field (parameters, optimizer, normalizers, PFPN statistics, the
generator, counters, the replay ring) is replicated.

A world-size-N round computes the world-size-1 round:

* each rank steps only its slice of the envs (:class:`ShardedEnv`), and
  all-gathers the step's observations, rewards and flags, so the policy
  acts on the global batch with the replicated generator: every random
  draw (action noise, reset phases, OU noise) is the one-process draw;
* the trajectory is therefore global on every rank; PPO and A2C split each
  minibatch by rank, each rank's loss is its rows' share of the global
  mean, and :class:`~pfpn_torch.algos.ppo.ClippedAdam` all-reduces (sums)
  the gradients before the global-norm clip;
* V-trace and recurrent PPO (whose minibatch is one env stream) and the
  off-policy gradient steps run replicated on every rank, as the replay
  ring is replicated in JAX (``mesh.py:57-62``); their gradients are
  averaged over the ranks all the same, so every rank's clip and Adam see
  one gradient and the replicas stay equal by construction;
* the training loop checks once a round that every rank holds the same
  parameters and normalizer (:meth:`DataMesh.check_replicated`).

``num_envs`` must be divisible by the world size; separate processes
cannot fall back to one device as JAX does, so :func:`check_divisible`
raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from ..sim.types import tree_map

DATA_FIELDS = frozenset(
    {"env_state", "obs", "ep_return", "last_ep_return", "carry", "ou_state"})

_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def init_distributed(device=None, backend: Optional[str] = None) -> bool:
    """Join the process group that ``torchrun``'s variables describe
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``). Returns False when they are absent. The backend is
    NCCL for a card and gloo for the CPU unless ``backend`` is given; on a
    card the rank's device is ``cuda:LOCAL_RANK`` unless ``device`` names
    another."""
    if dist.is_initialized():
        return True
    if any(not os.environ.get(v) for v in _VARS):
        return False
    dev = torch.device(device if device is not None
                       else f"cuda:{int(os.environ['LOCAL_RANK'])}")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        world_size=int(os.environ["WORLD_SIZE"]), rank=int(os.environ["RANK"]))
    return True


def rank_device(device=None) -> Optional[torch.device]:
    """The device of this rank: ``device`` when given, else
    ``cuda:LOCAL_RANK`` in a process group, else None (the entry point's
    own default)."""
    if device is not None:
        return torch.device(device)
    if dist.is_initialized():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return None


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This rank's place on the data axis."""

    rank: int
    world: int

    @property
    def lead(self) -> bool:
        return self.rank == 0

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a global per-env tensor (dim 0)."""
        n = x.shape[0] // self.world
        return x[self.rank * n:(self.rank + 1) * n]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's slice, in rank order (through
        host copies where the backend is gloo and ``x`` on a card)."""
        via_host = x.is_cuda and dist.get_backend() == "gloo"
        y = x.cpu() if via_host else x.contiguous()
        parts = [torch.empty_like(y) for _ in range(self.world)]
        dist.all_gather(parts, y)
        out = torch.cat(parts, 0)
        return out.to(x.device) if via_host else out

    def all_reduce_(self, tensors: Sequence[torch.Tensor], average: bool = False) -> None:
        """Sum (or average) ``tensors`` over the ranks in place, in one
        collective."""
        if not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        if average:
            flat /= self.world
        i = 0
        for t in tensors:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()

    def check_replicated(self, tensors: Sequence[torch.Tensor], what: str) -> None:
        """Raise unless ``tensors`` hold the same values on every rank: the
        float64 sum of each, its largest and smallest over the ranks
        compared (one collective)."""
        sums = torch.stack([t.detach().double().sum() for t in tensors])
        both = torch.cat([sums, -sums])
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
        hi, lo = both[:sums.numel()], -both[sums.numel():]
        if not torch.equal(hi, lo):
            n = int((hi != lo).sum())
            raise RuntimeError(f"rank {self.rank}: {n} of the {len(tensors)} {what} "
                               f"tensors differ between the {self.world} replicas")


def current_mesh() -> Optional[DataMesh]:
    """The data axis of the process group, or None outside one or at world
    size 1 (nothing to shard)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return DataMesh(rank=dist.get_rank(), world=dist.get_world_size())


def check_divisible(num_envs: int, world: int) -> None:
    if num_envs % world:
        raise ValueError(
            f"num_envs={num_envs} is not divisible by the world size {world}: "
            f"every rank must step the same number of envs")


def _map_field(fn, value: Any) -> Any:
    """``fn`` on every tensor of a data field: a tensor, a dataclass of
    tensors (the env state), a tuple or NamedTuple (the LSTM carry)."""
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        return fn(value)
    if dataclasses.is_dataclass(value):
        return tree_map(lambda x: _map_field(fn, x), value)
    if isinstance(value, tuple):
        parts = [_map_field(fn, v) for v in value]
        return type(value)(*parts) if hasattr(value, "_fields") else tuple(parts)
    return value


def shard_state(state: Any, mesh: DataMesh) -> Any:
    """This rank's slice of every field in :data:`DATA_FIELDS` of a global
    algorithm state; every other field is left as it is (replicated)."""
    return dataclasses.replace(state, **{
        f.name: _map_field(mesh.local, getattr(state, f.name))
        for f in dataclasses.fields(state) if f.name in DATA_FIELDS})


def gather_state(state: Any, mesh: DataMesh) -> Any:
    """The global state from every rank's slice (a collective: every rank
    calls it)."""
    return dataclasses.replace(state, **{
        f.name: _map_field(mesh.gather, getattr(state, f.name))
        for f in dataclasses.fields(state) if f.name in DATA_FIELDS})


class ShardedEnv:
    """The training env of one rank: :meth:`step_autoreset` takes the
    global batch's actions, steps this rank's envs, and returns their new
    states with the global batch's observations and step results, every
    reset phase drawn for the global batch. Everything else (``reset_batch``,
    ``step_batch``, the attributes) is the wrapped env's, unsharded, as the
    lead rank's evaluation uses it."""

    def __init__(self, env, mesh: DataMesh):
        if getattr(env, "num_tasks", 1) > 1:
            raise ValueError("the multi-task env assigns tasks by batch "
                             "position and is not sharded")
        self.env = env
        self.mesh = mesh

    def _reset_local(self, batch: int, generator: Optional[torch.Generator]):
        """``reset_batch(batch, generator)``'s draw for the global batch,
        reset only for this rank's envs."""
        env = self.env
        if env.random_init_pose:
            ph = torch.rand(batch, generator=generator, device=env.device)
        else:
            ph = torch.zeros(batch, device=env.device)
        return env.reset_at(self.mesh.local(ph) * env.motion.duration)

    def step_autoreset(self, states, actions: torch.Tensor,
                       generator: Optional[torch.Generator] = None):
        from ..envs.deepmimic import StepResult

        m = self.mesh
        res = self.env.step_batch(states, m.local(actions))
        reset_states, reset_obs = self._reset_local(actions.shape[0], generator)

        def pick(r, n):
            return torch.where(res.done.reshape((-1,) + (1,) * (n.ndim - 1)), r, n)

        new_states = tree_map(pick, reset_states, res.state)
        flags = torch.stack([res.reward, res.terminated.float(),
                             res.truncated.float(), res.done.float()], -1)
        g = m.gather(torch.cat([pick(reset_obs, res.obs), res.obs, flags], -1))
        n = res.obs.shape[-1]
        next_obs, obs, f = g[:, :n], g[:, n:2 * n], g[:, 2 * n:]
        return new_states, next_obs, StepResult(
            state=res.state, obs=obs, reward=f[:, 0], done=f[:, 3] > 0.5,
            terminated=f[:, 1] > 0.5, truncated=f[:, 2] > 0.5)

    def __getattr__(self, name):
        if name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)


def to_global(mesh: Optional[DataMesh], *fields):
    """The global value of each data field (unchanged without a mesh)."""
    if mesh is None:
        return fields
    return tuple(_map_field(mesh.gather, f) for f in fields)


def to_local(mesh: Optional[DataMesh], *fields):
    """This rank's slice of each global data field (unchanged without a
    mesh)."""
    if mesh is None:
        return fields
    return tuple(_map_field(mesh.local, f) for f in fields)
