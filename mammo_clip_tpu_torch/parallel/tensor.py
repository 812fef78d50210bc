"""The collectives of tensor parallelism and ZeRO-3, as autograd Functions
(what GSPMD inserts around a sharded ``jit`` in the JAX package, written out).

Each takes an ``axis``: ``core/mesh.py::RankSum`` over the model group
(``mesh.model_sum()``) or the data group (``mesh.data_sum()``), or, for the
model axis, one rank of a ``ThreadGroup`` below; ``copy_to_model`` and
``reduce_from_model`` return their input with no axis (a layer that is not
split runs the same code). An axis sums a tensor over
its ranks in place (``axis(t)``), concatenates their tensors
(``axis.gather(t, dim)``), returns this rank's slice of their sum
(``axis.scatter_sum(t, dim)``, ZeRO-3's; a ``ThreadGroup`` has none), and
knows its ``ranks`` and this rank's ``index``.

Megatron's pair over ``model`` (``models/bert.py``, ``models/efficientnet.py``):

* ``copy_to_model``: the identity forward, the sum over the ranks backward. A
  replicated tensor entering column-split layers: each rank's columns give
  part of its cotangent.
* ``reduce_from_model``: the sum over the ranks forward, the identity backward.
  The partial products of row-split layers: every rank then holds the whole
  product and its whole cotangent.
* ``gather_from_model``: the ranks' shards concatenated forward; backward
  this rank's own slice of the cotangent, not a sum. Every rank computes the
  same replicated result from the gathered tensor, so each already holds the
  whole cotangent; a sum would count it ``ranks`` times.

ZeRO-3 over ``data`` (``parallel/partitioning.py``):

* ``gather_shards``: the data ranks' shards of a parameter concatenated
  forward; backward this rank's slice of the ranks' cotangents summed and
  divided by their number (a reduce-scatter as a mean: each data rank holds
  the gradient of its own rows' loss, as ``train/step.py::average_gradients``
  averages the replicated leaves).
"""

from __future__ import annotations

import threading

import torch


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis(g.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return axis.gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.axis.ranks
        return g.narrow(ctx.dim, ctx.axis.index * n, n), None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return axis.gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.scatter_sum(g.contiguous(), ctx.dim) / ctx.axis.ranks, None, None


def copy_to_model(x: torch.Tensor, axis) -> torch.Tensor:
    return x if axis is None else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis) -> torch.Tensor:
    return x if axis is None else _ReduceFromModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    return _GatherFromModel.apply(x, dim, axis)


def gather_shards(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    return _GatherShards.apply(x, dim, axis)


class ThreadGroup:
    """``ranks`` ranks as threads of one process (two model ranks on one card,
    or on the CPU in a test; the fused kernel's cross-rank sums of two data
    ranks on one card): ``rank(r)`` is rank r's axis. A collective
    deposits this thread's tensor, waits for the others, computes its result
    from every rank's tensor in rank order (the same bits on every thread),
    and waits again before returning, so that no thread overwrites a tensor
    another still reads; on a card every thread enqueues on the same stream,
    whose order makes each result read the others' finished values. The
    threads must run their backward themselves
    (``torch.autograd.set_multithreading_enabled(False)``, as ``run`` does):
    autograd's one thread per device would otherwise wait at the first
    barrier forever."""

    def __init__(self, ranks: int, timeout_s: float = 120.0):
        self.ranks = ranks
        self.barrier = threading.Barrier(ranks, timeout=timeout_s)
        self._slots = [None] * ranks

    def rank(self, r: int) -> "_ThreadAxis":
        return _ThreadAxis(self, r)

    def run(self, fn, timeout_s: float = 600.0) -> list:
        """``[fn(r) for each rank r]``, one thread a rank, each running its own
        backward. A rank that fails aborts the barrier, so the others fail at
        it instead of waiting; a rank that fails, or does not finish within
        ``timeout_s``, raises here."""
        out, errors = [None] * self.ranks, []

        def worker(r):
            try:
                with torch.autograd.set_multithreading_enabled(False):
                    out[r] = fn(r)
            except BaseException as e:  # re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=worker, args=(r,), daemon=True)
                   for r in range(self.ranks)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout_s)
        if any(t.is_alive() for t in threads):
            raise RuntimeError(f"a rank of {self.ranks} did not finish in {timeout_s} s")
        if errors:
            raise RuntimeError(f"a rank of {self.ranks} failed: {errors[0]!r}") from errors[0]
        return out


class _ThreadAxis:
    def __init__(self, group: ThreadGroup, index: int):
        self.group, self.index, self.ranks = group, index, group.ranks

    def _exchange(self, t, combine):
        g = self.group
        g._slots[self.index] = t
        g.barrier.wait()
        out = combine(g._slots)
        g.barrier.wait()
        return out

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        def total(slots):
            s = slots[0].clone()
            for other in slots[1:]:
                s += other
            return s

        return t.copy_(self._exchange(t, total))

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return self._exchange(t.contiguous(), lambda slots: torch.cat(slots, dim))
