"""GPipe pipeline parallelism of the text tower (port of
``mammo_clip_tpu/parallel/pipeline.py``).

Stage ``i`` of a P-stage pipeline holds BERT layers ``[i * L / P, (i + 1) *
L / P)``; microbatches stream through the stages over a ``pipe`` axis, one
rank a stage: a ``core/mesh.py::RankSum`` over a pipe group
(``pipe_axes``), or a ``ThreadGroup`` rank (stages as threads of one
process, on one card or in the CPU tests).

The schedule is JAX's, tick for tick (``pipeline_apply``): with M
microbatches the loop runs T = M + P - 1 ticks; at tick t stage 0 takes
microbatch t (zeros once they run out), every stage applies its layers to
what it holds, and ``shift_to_next`` passes each result one stage down (no
wrap-around). Stage P - 1 emits microbatch t - (P - 1) at tick t, so its
last M outputs are the pipeline's; every other stage emits zeros, and the
outputs are summed over ``pipe``, which replicates them exactly. The sum's
backward is the identity (``reduce_from_model``'s): every stage computes
the same loss from the replicated outputs, so each already holds the whole
cotangent. The selection of a stage's input and of its output keeps both
branches in the graph (as ``jnp.where`` does), so every stage runs the
same backward, tick by tick, and its shifts meet their partners': stage 0's
cotangents arrive through the reverse shifts, and the bubble's ticks carry
zero cotangents to the real rows.

``pipelined_bert_hidden`` runs an encoder's layers so, dropout off. Every
rank computes the embeddings of its rows; only stage 0 reads them, so they
enter through ``copy_to_model`` over ``pipe`` (backward: the stages' sum),
which gives every stage the embeddings' and ``embeddings_ln``'s whole
gradient, as JAX's replicated parameters get. With a ``data`` axis, data
rank d streams its part of every microbatch (JAX's ``P(None, "data")``):
rows ``pipeline_rows`` of the batch, whose hidden states it returns.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .tensor import copy_to_model, reduce_from_model, shift_to_next

PIPE_AXIS, DATA_AXIS = "pipe", "data"


def stage_layers(num_layers: int, num_stages: int, stage: int) -> range:
    """The layer indices of ``stage``: ``[stage * L / P, (stage + 1) * L / P)``."""
    if num_layers % num_stages:
        raise ValueError(f"{num_layers} layers not divisible by {num_stages} stages")
    per = num_layers // num_stages
    return range(stage * per, (stage + 1) * per)


def stack_layer_params(state_dict: Dict[str, torch.Tensor], num_stages: int, stage: int,
                       prefix: str = "layer_") -> List[Dict[str, torch.Tensor]]:
    """Stage ``stage``'s layers of a state dict (the port's names:
    ``layer_<i>.<name>``, or ``text_encoder.layer_<i>.<name>`` with that
    ``prefix``): one ``{name: tensor}`` a layer, in the order of the integer
    suffix, as JAX's ``stack_layer_params`` stacks them at ``[stage, j]``.
    Raises ``ValueError`` when there is no layer or the stages do not divide
    them."""
    layers: Dict[int, Dict[str, torch.Tensor]] = {}
    for k, v in state_dict.items():
        if not k.startswith(prefix):
            continue
        index, _, name = k[len(prefix):].partition(".")
        if index.isdigit() and name:
            layers.setdefault(int(index), {})[name] = v
    if not layers:
        raise ValueError(f"no '{prefix}<i>' entries in the state dict")
    order = sorted(layers)
    return [layers[order[i]] for i in stage_layers(len(order), num_stages, stage)]


def _select(flag: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` where ``flag`` holds, else ``b``; both stay in the graph."""
    return torch.where(torch.tensor(flag, device=a.device), a, b)


def pipeline_apply(stage_fn: Callable, microbatches: Sequence[torch.Tensor], pipe) -> Tuple:
    """JAX's GPipe schedule on this rank's stage of ``pipe`` (its ``index``).

    stage_fn(tensors) -> tensors: this stage's layers on one microbatch (a
      tuple of tensors; the output has the input's structure and shapes).
    microbatches: a tuple of (M, mb, ...) tensors, the same on every stage
      (stage 0 alone reads them).

    Returns the (M, mb, ...) outputs, the same on every stage."""
    stage, stages = pipe.index, pipe.ranks
    micro = tuple(microbatches)
    num_mb = micro[0].shape[0]
    carry = tuple(torch.zeros_like(a[0]) for a in micro)
    outs = []
    for t in range(num_mb + stages - 1):
        x_t = tuple(a[t] if t < num_mb else torch.zeros_like(a[0]) for a in micro)
        y = tuple(stage_fn(tuple(_select(stage == 0, a, c) for a, c in zip(x_t, carry))))
        carry = tuple(shift_to_next(a, pipe) for a in y)
        if t >= stages - 1:
            outs.append(tuple(_select(stage == stages - 1, a, torch.zeros_like(a)) for a in y))
    return tuple(reduce_from_model(torch.stack(o), pipe) for o in zip(*outs))


def pipeline_rows(batch: int, num_microbatches: int, data_ranks: int = 1,
                  data_index: int = 0) -> torch.Tensor:
    """The batch rows that data rank ``data_index`` streams, in the order of
    its outputs: its ``mb / data_ranks`` rows of each microbatch of ``mb =
    batch / num_microbatches`` rows, microbatch by microbatch."""
    if batch % num_microbatches:
        raise ValueError(f"batch {batch} not divisible by {num_microbatches} microbatches")
    mb = batch // num_microbatches
    if mb % data_ranks:
        raise ValueError(f"microbatch {mb} not divisible by {data_ranks} data ranks")
    k = mb // data_ranks
    return (torch.arange(num_microbatches)[:, None] * mb + data_index * k
            + torch.arange(k)[None, :]).reshape(-1)


def pipelined_bert_hidden(encoder, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                          pipe, data=None, num_stages: Optional[int] = None,
                          num_microbatches: int = 1,
                          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``BertEncoder``'s last hidden state, its layers pipelined over ``pipe``
    (``num_stages``, its ranks by default and never another number), dropout
    off. ``input_ids`` and ``attention_mask`` are the whole (B, S) batch on
    every rank. Returns the (B / data ranks, S, H) hidden states of this data
    rank's rows, ``pipeline_rows(B, num_microbatches, data.ranks,
    data.index)`` (all of them, in order, without ``data``), the same on every
    stage; a stage's layers get the gradients of those rows, the others none."""
    stages = pipe.ranks if num_stages is None else num_stages
    if stages != pipe.ranks:
        raise ValueError(f"{stages} stages on a pipe axis of {pipe.ranks} ranks")
    d_ranks, d_index = (1, 0) if data is None else (data.ranks, data.index)
    rows = pipeline_rows(input_ids.shape[0], num_microbatches, d_ranks, d_index)
    rows = rows.to(input_ids.device)
    ids, mask = input_ids[rows], attention_mask[rows]
    x = copy_to_model(encoder.embed(ids, dtype=dtype), pipe)
    m = num_microbatches
    x_mb = x.reshape(m, -1, *x.shape[1:])
    mask_mb = mask.reshape(m, -1, mask.shape[1]).to(x.dtype)
    layers = [getattr(encoder, f"layer_{i}")
              for i in stage_layers(encoder.cfg.num_layers, stages, pipe.index)]

    def stage_fn(xm):
        h, mk = xm
        keep = mk > 0
        for layer in layers:
            h = layer(h, keep, False)
        return h, mk

    out, _ = pipeline_apply(stage_fn, (x_mb, mask_mb), pipe)
    return out.reshape(-1, *out.shape[2:])


def pipe_axes(pipe: int):
    """This process's (pipe, data) axes over the world, laid out as JAX's
    ``Mesh(devices.reshape(D, P), ("data", "pipe"))``: pipe index ``rank %
    P``, data index ``rank // P``. Returns ``(RankSum over the pipe group,
    RankSum over the data group or None with one data rank)``; every rank
    makes every group, in one order, as ``new_group`` requires."""
    import torch.distributed as dist

    from ..core.mesh import RankSum

    n, r = dist.get_world_size(), dist.get_rank()
    if n % pipe:
        raise ValueError(f"{n} ranks not divisible by pipe={pipe}")
    axes = {}
    for q in range(n // pipe):
        g = dist.new_group(list(range(q * pipe, (q + 1) * pipe)))
        if r // pipe == q:
            axes[PIPE_AXIS] = RankSum(g)
    for j in range(pipe):
        g = dist.new_group(list(range(j, n, pipe)))
        if r % pipe == j:
            axes[DATA_AXIS] = RankSum(g) if n > pipe else None
    return axes[PIPE_AXIS], axes[DATA_AXIS]
