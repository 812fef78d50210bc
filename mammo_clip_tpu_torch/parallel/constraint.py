"""Sequence sharding of an activation (port of
``mammo_clip_tpu/parallel/constraint.py``).

JAX's ``shard_seq`` constrains a (B, S, H) activation to S-shards over the
mesh's ``model`` axis and lets GSPMD turn the row split's all-reduce into a
reduce-scatter and insert the all-gather before the next column split. Here
the collectives are written out (``parallel/tensor.py``: ``scatter_to_seq``,
``gather_from_seq``, ``reduce_scatter_to_seq``; ``models/bert.py`` with
``seq_parallel``), and ``shard_seq`` is the entry into the sharded region:
this rank's S-slice, whose backward gathers the cotangent.

It is the identity where JAX's is: no axis, an axis of one rank, fewer
than 2 dims, or an S that the ranks do not divide. Called eagerly it shards
as it does anywhere (JAX's raises when it is called eagerly under an active
mesh: fault R3 of the reference, not inherited).
"""

from __future__ import annotations

from typing import Optional

import torch

from .tensor import scatter_to_seq

# the tensor-parallel axis' name, as the JAX package names it
MODEL_AXIS = "model"


def seq_axis(x: torch.Tensor, axis) -> Optional[object]:
    """``axis`` when ``shard_seq`` splits ``x`` over it, else None."""
    ranks = getattr(axis, "ranks", 1)
    if axis is None or ranks <= 1 or x.dim() < 2 or x.shape[1] % ranks:
        return None
    return axis


def shard_seq(x: torch.Tensor, axis) -> torch.Tensor:
    """This rank's S-slice of a (B, S, ...) ``x`` over ``axis`` (a
    ``core/mesh.py::RankSum`` over the model group, or a ``ThreadGroup``
    rank), or ``x`` itself in JAX's no-op cases."""
    return scatter_to_seq(x, seq_axis(x, axis))
