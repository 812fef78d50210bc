"""Device mesh / distributed context (port of ``mammo_clip_tpu/core/mesh.py``).

The JAX package builds a named mesh and lets GSPMD place the collectives. Here
the axes are ranks of ``torch.distributed``: one process per card, laid out
as JAX's ``np.asarray(devices).reshape(replica, data, model)``, ``model``
varying fastest: rank ``r`` has model index ``r % model`` and data index
``r // model`` (over ``replica * data``), as the reference's DDP ran one
process a card (``trainer_ddp.py:134``, a 4-GPU node).

Axes
----
``data``    batch-parallel: data index q holds rows ``q * B .. (q + 1) * B - 1``
            of the global batch (``B = data.batch_size_per_device``). The
            train-mode BatchNorm statistics, the fused MBConv kernel's batch
            sums (``ops/mbconv6.py``) and the contrastive negatives
            (``parallel/shard_loss.py``) span every data rank's rows, as
            they span the global batch under GSPMD, and the gradients are
            averaged over them. The data group is the ranks with this rank's
            model index; ZeRO-3 shards (``parallel/partitioning.py``) are
            split over it.
``replica`` cross-slice data parallelism in JAX: here another batch axis over
            the same ranks (``replica * data`` batch-carrying ranks, data
            fastest after model).
``model``   tensor parallelism: the ranks of a model group hold the same rows
            and split the Megatron layers (``parallel/tensor.py``) between
            them; with ``model = 1`` every rank is its own model group and
            nothing is split.

``MeshContext.create`` reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` as ``python -m torch.distributed.run``
sets them, and with more than one rank calls ``init_process_group`` with the
address, the world size and the rank given explicitly and a finite timeout
(a collective that hangs fails): NCCL on ``cuda:LOCAL_RANK``, gloo when the
caller asks for the CPU; then, with ``model > 1``, it makes the model groups
and the data groups (every rank joins every ``new_group`` call, in one
order). Without those variables it is one process, no group. ``data_sum()``
is the hook that sums a tensor over the data group in place, or None with
one data rank; ``world_sum()`` sums over every rank and ``model_sum()`` over
the model group. Train-mode BatchNorm and the fused kernel take the world's
(a channel shard's BatchNorm the data group's), the loss the data group's,
so that without a group every path is the one-process path. With ``model =
1`` the data group is the world, so the data-parallel paths run the
collectives they ran before the model axis existed.
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
    """The sum over a group of ranks: ``hook(t)`` sums the contiguous tensor
    ``t`` over them in place and returns it; ``ranks`` is their number and
    ``index`` this rank's place among them (``None``: the world).
    ``gather(t, dim)`` concatenates every rank's ``t`` along ``dim`` in that
    order, ``scatter_sum(t, dim)`` returns this rank's slice along ``dim``
    of the ranks' sum of ``t`` (a reduce-scatter), and ``shift(t)`` returns
    the ``t`` of the rank before this one (zeros on the first; with
    ``reverse``, of the rank after it, zeros on the last): one batch of
    point-to-point sends and receives, which every rank of the group joins
    (blocking pairs would deadlock)."""

    def __init__(self, group=None):
        self.group = group
        self.ranks = dist.get_world_size(group)
        self.index = dist.get_rank(group)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.group)
        return t

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        t = t.contiguous()  # the collective writes dense buffers: no strides kept
        parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
                 for _ in range(self.ranks)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim)

    def scatter_sum(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        parts = [c.contiguous() for c in t.chunk(self.ranks, dim)]
        out = torch.empty_like(parts[self.index])
        dist.reduce_scatter(out, parts, group=self.group)
        return out

    def shift(self, t: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        t = t.contiguous()
        out = torch.zeros_like(t)
        step = -1 if reverse else 1
        peer = lambda i: i if self.group is None else dist.get_global_rank(self.group, i)
        ops = []
        if 0 <= self.index + step < self.ranks:
            ops.append(dist.P2POp(dist.isend, t, peer(self.index + step), self.group))
        if 0 <= self.index - step < self.ranks:
            ops.append(dist.P2POp(dist.irecv, out, peer(self.index - step), self.group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        return out


# this process's groups: {"shape": mesh shape, "data": group or None (the
# world), "model": group or None (no model axis)}, set by MeshContext.create
_AXES: dict = {}


def _shape() -> dict:
    return _AXES.get("shape") or {"replica": 1, "data": world_size(), "model": 1}


def model_size() -> int:
    """The ranks of this rank's model group (1 without a model axis)."""
    return _shape()["model"] if _grouped() else 1


def model_index() -> int:
    """This rank's place in its model group: ``rank % model``."""
    return rank() % model_size()


def data_size() -> int:
    """The batch-carrying ranks: ``replica * data`` (the world with ``model = 1``)."""
    return world_size() // model_size()


def data_index() -> int:
    """This rank's place in its data group: ``rank // model``; its rows of the
    global batch and its Batcher's stride start there."""
    return rank() // model_size()


def data_sum() -> Optional[RankSum]:
    """The sum over the data group (the ranks with this rank's model index),
    or None with one data rank (every batch statistic is then this process's
    own). With ``model = 1`` the group is the world."""
    if data_size() <= 1:
        return None
    return RankSum(_AXES.get("data"))


def world_sum() -> Optional[RankSum]:
    """The sum over every rank, or None with one rank. The batch statistics of
    a tensor that a model group's ranks all hold (replicated over ``model``)
    sum here: every data rank's rows then count ``model`` times in the sums
    and in the count alike, and the result is the same bits on every rank,
    where sums over each data group could differ in their last bits between
    the model ranks (a kernel's atomic sums). With ``model = 1`` it is
    ``data_sum()``."""
    return RankSum() if world_size() > 1 else None


def model_sum() -> Optional[RankSum]:
    """The sum over the model group (the ranks that hold this rank's rows), or
    None without a model axis."""
    if model_size() <= 1:
        return None
    return RankSum(_AXES["model"])


def _make_groups(shape: dict) -> None:
    """The model and data groups of ``shape`` over the world (model fastest).
    Every rank makes every group, in one order, as ``new_group`` requires; a
    second call with the same shape keeps the groups it made."""
    if _AXES.get("shape") == shape:
        return
    m, n = shape["model"], world_size()
    _AXES.clear()
    _AXES["shape"] = dict(shape)
    if m == 1:
        _AXES["data"] = None  # the world: the data-parallel paths' own collectives
        return
    r = rank()
    for q in range(n // m):
        g = dist.new_group(list(range(q * m, (q + 1) * m)))
        if r // m == q:
            _AXES["model"] = g
    for j in range(m):
        g = dist.new_group(list(range(j, n, m)))
        if r % m == j:
            _AXES["data"] = g


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
    leave, as JAX's ``make_mesh`` does."""
    n = world_size() if ranks is None else int(ranks)
    if data == -1:
        if n % (model * replica):
            raise ValueError(f"{n} ranks not divisible by model*replica={model * replica}")
        data = n // (model * replica)
    if replica * data * model != n:
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
        shape = make_mesh(data, model, replica, world)
        if world > 1:
            _make_groups(shape)
        return cls(shape=shape, rank=rank(), device=device)

    @property
    def process_count(self) -> int:
        """The batch-carrying ranks: ``replica * data``."""
        return self.shape["replica"] * self.shape["data"]

    @property
    def data_index(self) -> int:
        """This rank's place among the batch-carrying ranks: ``rank // model``."""
        return self.rank // self.shape["model"]

    @property
    def model_index(self) -> int:
        """This rank's place in its model group: ``rank % model``."""
        return self.rank % self.shape["model"]

    def global_batch_size(self, per_device: int) -> int:
        """Distinct examples a step: the per-device batch on every batch-carrying
        rank (the ranks of a model group hold the same rows, JAX :131-140)."""
        return per_device * self.process_count

    def shard_host_batch(self, batch, stacked: bool = False):
        """This rank's rows of a global host batch (numpy arrays or tensors), on
        this rank's device: rows ``q * B .. (q + 1) * B - 1`` of axis 0 (q the
        data index: a model group's ranks take the same rows), or of axis 1
        for a (K, B, ...) super-batch (``stacked``). A Batcher built with this
        rank's data index as ``process_index`` yields its rows already."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v)
            axis = 1 if stacked else 0
            b = t.shape[axis] // self.process_count
            t = t.narrow(axis, self.data_index * b, b)
            if t.dtype == torch.int32:
                t = t.long()
            out[k] = t.to(self.device).contiguous()
        return out

    def close(self) -> None:
        """Leave the process group (nothing without one)."""
        _AXES.clear()
        if _grouped():
            dist.destroy_process_group()
