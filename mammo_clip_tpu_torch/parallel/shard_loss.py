"""The contrastive losses over every data-parallel rank's batch (port of
``mammo_clip_tpu/parallel/shard_loss.py``).

Each rank holds its own rows of the global batch. ``gather_rows`` all-gathers
the ranks' embeddings in rank order; its backward sums each rank's slice of
the cotangent over the ranks (an all-reduce, then the rank's slice: the
reduce-scatter of the reference's DistAutogradAllGatherFunction,
util/dist_autograd.py:5-27, in a form gloo runs too). Rank r scores its own
rows against every column with labels offset by ``r * local_b``
(breast_clip.py:39-40 of the reference), as ``shard_map_clip_loss`` does.

Scale. Rank r differentiates its own term L_r (its rows' cross-entropy mean).
Through the gather's backward its embeddings' cotangent is the sum over ranks
of dL_s/de_r, W times that of the global loss L = mean_s L_s; the ranks'
parameter gradients are then averaged (``train/step.py::average_gradients``),
which gives dL/dtheta. The values returned are the ranks' mean, the global
loss one process computes over the whole batch, with the gradient of L_r.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..losses.clip_loss import cross_entropy


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        b = g.shape[0] // dist.get_world_size(ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * b:(r + 1) * b], None


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in rank order; differentiable (its
    backward sums the ranks' cotangents of this rank's rows)."""
    return _GatherRows.apply(x, group)


def _rank_mean(out: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each value replaced by the ranks' mean, keeping its own gradient."""
    keys = list(out)
    mean = torch.stack([out[k].detach().float() for k in keys])
    dist.all_reduce(mean, group=group)
    mean /= dist.get_world_size(group)
    return {k: out[k] + (mean[i] - out[k]).detach() for i, k in enumerate(keys)}


def gathered_clip_loss(image_embeddings, text_embeddings, logit_scale,
                       text_embeddings2: Optional[torch.Tensor] = None,
                       image_view_embeddings: Optional[torch.Tensor] = None,
                       label_smoothing: float = 0.0, i2i_weight: float = 1.0,
                       t2t_weight: float = 0.5, is_train: bool = True,
                       group=None) -> Dict[str, torch.Tensor]:
    """Multi-positive InfoNCE over the global batch from this rank's rows (the
    twin of ``shard_map_clip_loss``): the same dict as
    ``losses.multi_positive_clip_loss`` on the gathered batch."""
    local_b = image_embeddings.shape[0]
    labels = torch.arange(local_b, device=image_embeddings.device) + (
        dist.get_rank(group) * local_b)
    s = label_smoothing if is_train else 0.0
    scale = logit_scale.float()

    def pair(a_local, b_gathered, smoothing):
        return cross_entropy(scale * (a_local.float() @ b_gathered.float().T), labels, smoothing)

    i1, t1 = image_embeddings, text_embeddings
    gi1, gt1 = gather_rows(i1, group), gather_rows(t1, group)
    if text_embeddings2 is None or image_view_embeddings is None:
        loss_i2t = pair(i1, gt1, s)
        loss_t2i = pair(t1, gi1, s)
        out = {"contrastive": (loss_i2t + loss_t2i) / 2.0, "i2t": loss_i2t, "t2i": loss_t2i}
    else:
        i2, t2 = image_view_embeddings, text_embeddings2
        gi2, gt2 = gather_rows(i2, group), gather_rows(t2, group)
        loss_i2t = (pair(i1, gt1, s) + pair(i2, gt1, s) + pair(i1, gt2, s) + pair(i2, gt2, s)) / 4.0
        loss_t2i = (pair(t1, gi1, s) + pair(t1, gi2, s) + pair(t2, gi1, s) + pair(t2, gi2, s)) / 4.0
        loss_i2i = (pair(i1, gi2, 0.0) + pair(i2, gi1, 0.0)) / 2.0
        loss_t2t = (pair(t2, gt1, 0.0) + pair(t1, gt2, 0.0)) / 2.0
        out = {"contrastive": (loss_i2t + loss_t2i) / 2.0 + i2i_weight * loss_i2i
               + t2t_weight * loss_t2t,
               "i2t": loss_i2t, "t2i": loss_t2i, "i2i": loss_i2i, "t2t": loss_t2t}
    return _rank_mean(out, group)


def gathered_contrastive_clip_loss(image_embeddings, text_embeddings, logit_scale,
                                   label_smoothing: float = 0.0, i2t_weight: float = 0.75,
                                   t2i_weight: float = 0.25, is_train: bool = True,
                                   group=None) -> Dict[str, torch.Tensor]:
    """The ConVIRT-style single-pair loss over the global batch from this
    rank's rows (``losses.contrastive_clip_loss`` on the gathered batch)."""
    local_b = image_embeddings.shape[0]
    labels = torch.arange(local_b, device=image_embeddings.device) + (
        dist.get_rank(group) * local_b)
    s = label_smoothing if is_train else 0.0
    scale = logit_scale.float()
    gi, gt = gather_rows(image_embeddings, group), gather_rows(text_embeddings, group)
    loss_i2t = cross_entropy(scale * (image_embeddings.float() @ gt.float().T), labels, s)
    loss_t2i = cross_entropy(scale * (text_embeddings.float() @ gi.float().T), labels, s)
    return _rank_mean({"contrastive": i2t_weight * loss_i2t + t2i_weight * loss_t2i,
                       "i2t": loss_i2t, "t2i": loss_t2i}, group)
