"""Device mesh / distributed context (port of ``mammo_clip_tpu/core/mesh.py``).

The JAX package builds a named mesh and lets GSPMD place the collectives. Here
the data-parallel axes are ranks of ``torch.distributed``: one process per
card, each holding its own rows of the global batch, as the reference's DDP
ran (``trainer_ddp.py:134``, a 4-GPU node).

Axes
----
``data``    batch-parallel: rank r holds rows ``r * B .. (r + 1) * B - 1`` of
            the global batch (``B = data.batch_size_per_device``). The train-mode
            BatchNorm statistics, the fused MBConv kernel's batch sums
            (``ops/mbconv6.py``) and the contrastive negatives
            (``parallel/shard_loss.py``) span every rank, as they span the
            global batch under GSPMD; the gradients are averaged across ranks.
``replica`` cross-slice data parallelism in JAX: here another batch axis over
            the same ranks (``replica * data`` ranks in all, data fastest).
``model``   tensor parallelism: only 1 here (the next slice of the port).

``MeshContext.create`` reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` as ``python -m torch.distributed.run``
sets them, and with more than one rank calls ``init_process_group`` with the
address, the world size and the rank given explicitly and a finite timeout
(a collective that hangs fails): NCCL on ``cuda:LOCAL_RANK``, gloo when the
caller asks for the CPU. Without those variables it is one process, no group.
``data_sum()`` is the hook that sums a tensor over the ranks in place, or None
with no group (or one rank); train-mode BatchNorm, the fused kernel and the
loss take it, so that without a group every path is the one-process path.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _grouped() else 0


def world_size() -> int:
    return dist.get_world_size() if _grouped() else 1


def is_master() -> bool:
    """True on the process that performs host I/O (checkpoints, logs): rank 0."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing without a group)."""
    if world_size() > 1:
        dist.barrier()


class RankSum:
    """The cross-rank sum: ``hook(t)`` sums the contiguous tensor ``t`` over the
    ranks in place and returns it; ``ranks`` is their number."""

    def __init__(self, group=None):
        self.group = group
        self.ranks = dist.get_world_size(group)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.group)
        return t


def data_sum() -> Optional[RankSum]:
    """The sum over the data-parallel ranks, or None with no process group or
    one rank (every batch statistic is then this process's own)."""
    return RankSum() if world_size() > 1 else None


def any_rank(flag: bool, device) -> bool:
    """True on every rank when ``flag`` is true on any (one small all-reduce)."""
    if world_size() <= 1:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)


def mean_over_ranks(values: Mapping[str, float], device) -> dict:
    """The ranks' mean of each named scalar (the values themselves with one rank)."""
    if world_size() <= 1:
        return {k: float(v) for k, v in values.items()}
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64, device=device)
    dist.all_reduce(t)
    return {k: float(v) / world_size() for k, v in zip(keys, t.tolist())}


def make_mesh(data: int = -1, model: int = 1, replica: int = 1,
              ranks: Optional[int] = None) -> dict:
    """The mesh's axis sizes ``{"replica", "data", "model"}`` over ``ranks``
    processes (the world size by default); ``data=-1`` absorbs what the others
    leave. ``model > 1`` raises: tensor parallelism is the next slice."""
    if model != 1:
        raise NotImplementedError(
            "mesh.model > 1 (tensor parallelism over 'model') is not ported yet: it is "
            "the next slice of the port (ROADMAP queue 1 item 9b); use model=1")
    n = world_size() if ranks is None else int(ranks)
    if data == -1:
        if n % replica:
            raise ValueError(f"{n} ranks not divisible by replica={replica}")
        data = n // replica
    if replica * data != n:
        raise ValueError(f"mesh {replica}x{data}x{model} != {n} ranks")
    return {"replica": replica, "data": data, "model": model}


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """The mesh over this run's ranks and this rank's place in it."""

    shape: dict
    rank: int
    device: torch.device

    @classmethod
    def create(cls, data: int = -1, model: int = 1, replica: int = 1, device="cuda",
               env: Optional[Mapping[str, str]] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> "MeshContext":
        """The context of this process: joins the process group that ``env``
        (``os.environ`` by default) describes, unless one is already up."""
        env = os.environ if env is None else env
        world = int(env.get("WORLD_SIZE", "1"))
        rank_ = int(env.get("RANK", "0"))
        local = int(env.get("LOCAL_RANK", str(rank_)))
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", local if world > 1 else 0)
        make_mesh(data, model, replica, world)  # refuse a bad mesh before joining
        if world > 1 and not _grouped():
            addr = env.get("MASTER_ADDR", "localhost")
            port = int(env.get("MASTER_PORT", "29500"))
            if device.type == "cuda":
                torch.cuda.set_device(device)
            dist.init_process_group(
                backend="nccl" if device.type == "cuda" else "gloo",
                init_method=f"tcp://{addr}:{port}", world_size=world, rank=rank_,
                timeout=datetime.timedelta(seconds=timeout_s))
        if world_size() != world:
            raise RuntimeError(f"WORLD_SIZE={world} but the process group has "
                               f"{world_size()} ranks")
        return cls(shape=make_mesh(data, model, replica, world), rank=rank(), device=device)

    @property
    def process_count(self) -> int:
        """The batch-carrying ranks: ``replica * data``."""
        return self.shape["replica"] * self.shape["data"]

    def global_batch_size(self, per_device: int) -> int:
        """Distinct examples a step: the per-device batch on every batch-carrying rank."""
        return per_device * self.process_count

    def shard_host_batch(self, batch, stacked: bool = False):
        """This rank's rows of a global host batch (numpy arrays or tensors), on
        this rank's device: rows ``rank * B .. (rank + 1) * B - 1`` of axis 0, or
        of axis 1 for a (K, B, ...) super-batch (``stacked``). A Batcher built
        with this rank's ``process_index`` yields its rows already."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v)
            axis = 1 if stacked else 0
            b = t.shape[axis] // self.process_count
            t = t.narrow(axis, self.rank * b, b)
            if t.dtype == torch.int32:
                t = t.long()
            out[k] = t.to(self.device).contiguous()
        return out

    def close(self) -> None:
        """Leave the process group (nothing without one)."""
        if _grouped():
            dist.destroy_process_group()
