"""The train and eval steps (port of ``mammo_clip_tpu/train/step.py``).

One step: (optional) on-device augmentation -> dual-encoder forward in train
mode (updating the BatchNorm running statistics) -> loss -> backward -> AdamW
update. Randomness (augmentation, dropout, drop-connect) is drawn in that
order from the ``torch.Generator`` the caller passes. Given a ``seed``, the
step first reseeds that generator from (seed, state.step), as the JAX step
folds the step count into its key: a step's draws then depend only on the seed
and the step, which makes K fused steps equal to K single ones and a resumed
run equal to an uninterrupted one.

Under data parallelism (``core/mesh.py``) each data rank runs this step on
its own rows: the BatchNorm statistics and the loss span the global batch, and
after the backward the gradients are averaged over the data ranks
(``average_gradients``, one all-reduce per bucket) before the optimizer clips
and applies them, so every rank takes the same update. A ZeRO-3 shard's
gradient is already that mean (``parallel/tensor.py::gather_shards``). Data rank q folds q into its step seed, so that no two data
ranks draw the same augmentation, drop-connect or dropout, the ranks of one
model group draw the same, and rank 0 draws what one process draws.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..core import mesh
from ..parallel.partitioning import shard_of
from .state import TrainState

BUCKET_ELEMENTS = 1 << 24  # gradients flattened into buckets of at most this many


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """The generator seed of step ``step`` of a run seeded ``seed``, on data rank
    ``rank`` (the rank moves the seed's low 32 bits, all that the CPU generator
    reads)."""
    return (seed * 1_000_003 + step + rank * 1_000_000_007) % (2**63)


@torch.no_grad()
def _mean(grads, group, ranks: int) -> None:
    """Each gradient replaced with its mean over ``group`` (``ranks`` ranks):
    gradients of one dtype flattened into buckets of at most
    ``BUCKET_ELEMENTS``, one all-reduce each."""
    buckets, cur, n = [], [], 0
    for g in grads:
        if cur and (n + g.numel() > BUCKET_ELEMENTS or g.dtype != cur[0].dtype):
            buckets.append(cur)
            cur, n = [], 0
        cur.append(g)
        n += g.numel()
    if cur:
        buckets.append(cur)
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        flat /= ranks
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


@torch.no_grad()
def average_gradients(params) -> None:
    """Replace each gradient with its mean over the data ranks (nothing with one
    rank). A leaf split over ``model`` is averaged over its data group. A
    whole leaf is averaged over every rank, and a ZeRO-3 shard (its backward
    averaged it over its data group) over its model group: the ranks of a
    model group compute the same gradient for it up to the order of a
    kernel's atomic sums (an embedding's, a conv's), so their mean is the
    data mean and keeps the same bits on every rank. With ``model = 1`` this
    is one mean over the world. Every rank of a group holds gradients for the
    same parameters (the same graph runs on each)."""
    data, model = mesh.data_size(), mesh.model_size()
    if data * model <= 1:
        return
    by_axis = {None: [], "model": [], "data": []}
    for p in params:
        if p.grad is not None:
            by_axis[getattr(shard_of(p), "axis", None)].append(p.grad)
    _mean(by_axis[None], None, data * model)
    if data > 1:
        _mean(by_axis["model"], mesh.data_sum().group, data)
    if model > 1:
        _mean(by_axis["data"], mesh.model_sum().group, model)


def make_train_step(model, loss_fn: Callable, preprocess: Optional[Callable] = None):
    """Returns ``step(state, batch, generator, seed=None) -> (state, loss_dict)``;
    the loss dict holds detached scalars (the ranks' mean under data
    parallelism)."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator,
             seed: Optional[int] = None):
        if seed is not None:
            generator.manual_seed(step_seed(seed, state.step, mesh.data_index()))
        if preprocess is not None:
            batch = preprocess(batch, generator)
        outputs = model(batch, train=True, generator=generator)
        loss_dict = loss_fn(outputs, batch, True)
        loss_dict["total"].backward()
        average_gradients(state.optimizer.params)
        state.apply_gradients()
        return state, {k: v.detach() for k, v in loss_dict.items()}

    return step


def make_train_multistep(model, loss_fn: Callable, preprocess: Optional[Callable] = None):
    """K steps in one call: ``step(state, batches, generator, seed=None)`` where
    every leaf of ``batches`` carries a leading steps axis K
    (``data.pipeline.stack_batches``). A loop over the single-step body, so it
    equals K single steps; returns the last step's loss dict."""
    single = make_train_step(model, loss_fn, preprocess)

    def step(state: TrainState, batches: Dict[str, torch.Tensor], generator: torch.Generator,
             seed: Optional[int] = None):
        k_steps = next(iter(batches.values())).shape[0]
        loss_dict = None
        for k in range(k_steps):
            state, loss_dict = single(state, {n: v[k] for n, v in batches.items()}, generator,
                                      seed)
        return state, loss_dict

    return step


def make_eval_step(model, loss_fn: Callable, preprocess: Optional[Callable] = None):
    """Validation-loss step (reference: trainer.py:322-381), deterministic. It
    judges the EMA weights when the state tracks them (the weights that would
    be served), with the BatchNorm running statistics."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        b = preprocess(batch, None) if preprocess is not None else batch
        with torch.no_grad(), state.eval_weights():
            outputs = model(b, train=False)
            return {k: v.detach() for k, v in loss_fn(outputs, b, False).items()}

    return step
