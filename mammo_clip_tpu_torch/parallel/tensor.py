"""The collectives of tensor parallelism and ZeRO-3, as autograd Functions
(what GSPMD inserts around a sharded ``jit`` in the JAX package, written out).

Each takes an ``axis``: ``core/mesh.py::RankSum`` over the model group
(``mesh.model_sum()``) or the data group (``mesh.data_sum()``), or, for the
model axis, one rank of a ``ThreadGroup`` below; ``copy_to_model`` and
``reduce_from_model`` return their input with no axis (a layer that is not
split runs the same code). An axis sums a tensor over
its ranks in place (``axis(t)``), concatenates their tensors
(``axis.gather(t, dim)``), returns this rank's slice of their sum
(``axis.scatter_sum(t, dim)``), passes a tensor one rank down the chain of
its ranks (``axis.shift(t)``: rank i receives rank i - 1's, rank 0 zeros;
the pipeline's), and knows its ``ranks`` and this rank's ``index``.

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

Megatron's sequence parallelism over ``model`` (``models/bert.py`` with
``seq_parallel``; ``parallel/constraint.py``), on the sequence dim (1) of a
(B, S, H) activation, each rank holding S / ranks of it between the split
layers; each returns its input with no axis:

* ``scatter_to_seq``: this rank's S-slice forward; backward the ranks'
  cotangent slices gathered. A replicated tensor entering the sharded
  region: every rank then holds the whole cotangent, as it holds the whole
  tensor.
* ``gather_from_seq``: the ranks' slices gathered forward; backward this
  rank's slice of the cotangents' sum (a reduce-scatter). The sequence
  entering column-split layers, whose every rank gives part of each token's
  cotangent.
* ``reduce_scatter_to_seq``: this rank's S-slice of the ranks' sum forward;
  backward the cotangent slices gathered. A row split's partial products
  leaving for the sharded region, in place of ``reduce_from_model``'s
  all-reduce.
* The encoder's output leaves the sharded region through
  ``gather_from_model`` on dim 1 (above): every rank then holds the whole
  output and its whole cotangent.

The pipeline (``parallel/pipeline.py``):

* ``shift_to_next``: rank i + 1 receives rank i's tensor forward (rank 0
  zeros, the last rank's goes nowhere); backward the reverse, rank i
  receiving rank i + 1's cotangent (the last rank zeros).

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


def _slice(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """This rank's equal part of ``x`` along ``dim``."""
    n = x.shape[dim] // axis.ranks
    return x.narrow(dim, axis.index * n, n)


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
        return _slice(g, ctx.dim, ctx.axis), None, None


class _ScatterToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _slice(x, dim, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.gather(g.contiguous(), ctx.dim), None, None


class _GatherFromSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return axis.gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.scatter_sum(g.contiguous(), ctx.dim), None, None


class _ReduceScatterToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return axis.scatter_sum(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.gather(g.contiguous(), ctx.dim), None, None


class _ShiftToNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.shift(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.shift(g.contiguous(), reverse=True), None


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


def scatter_to_seq(x: torch.Tensor, axis, dim: int = 1) -> torch.Tensor:
    return x if axis is None else _ScatterToSeq.apply(x, dim, axis)


def gather_from_seq(x: torch.Tensor, axis, dim: int = 1) -> torch.Tensor:
    return x if axis is None else _GatherFromSeq.apply(x, dim, axis)


def reduce_scatter_to_seq(x: torch.Tensor, axis, dim: int = 1) -> torch.Tensor:
    return x if axis is None else _ReduceScatterToSeq.apply(x, dim, axis)


def shift_to_next(x: torch.Tensor, axis) -> torch.Tensor:
    """``axis.shift`` with its reverse as the backward (a tensor that needs no
    gradient is shifted outside autograd)."""
    return _ShiftToNext.apply(x, axis) if x.requires_grad else axis.shift(x.contiguous())


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

    def scatter_sum(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        def part(slots):
            n = slots[0].shape[dim] // self.ranks
            s = slots[0].narrow(dim, self.index * n, n).clone()
            for other in slots[1:]:
                s += other.narrow(dim, self.index * n, n)
            return s

        return self._exchange(t.contiguous(), part)

    def shift(self, t: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        src = self.index + 1 if reverse else self.index - 1
        return self._exchange(t.contiguous(), lambda slots: slots[src].clone()
                              if 0 <= src < self.ranks else torch.zeros_like(t))
