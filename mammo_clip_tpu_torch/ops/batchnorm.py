"""Train-mode BatchNorm as one autograd Function, over this process's batch or
over a batch that spans data-parallel ranks.

``TrainBatchNorm.apply(x, scale, bias, eps, rank_sum)`` normalises NCHW ``x``
with its batch (mean, biased var), computed in fp32, and returns y in x's
type with those statistics. It keeps x (in its own type) and two per-channel
vectors for the backward, which recomputes the normalised x: the composition
of autograd ops keeps two fp32 copies of x instead (8 bytes an element where a
bf16 x takes 2), which at the flagship's widths without remat does not fit a
step at batch 8 on one 80 GB card.

``rank_sum`` (``core/mesh.py::RankSum``, or None) sums a tensor over the
ranks in place. With it the statistics are those of every rank's batch: the
forward sums [sum x | sum x^2 | count] over the ranks, and the backward
[sum dy | sum dy xhat], which dx needs. The scale and bias gradients stay this
rank's own sums: the ranks' parameter gradients are averaged after the
backward, and a sum over ranks here as well would count them twice. With None
it is the one-process function.
"""

from __future__ import annotations

import torch


class TrainBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, rank_sum=None):
        xf = x.float()
        ch = x.shape[1]
        if rank_sum is None:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            count = None
        else:
            sums = torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                              xf.new_full((1,), float(x.numel() // ch))])
            rank_sum(sums)
            count = sums[-1]
            mean = sums[:ch] / count
            var = torch.clamp(sums[ch:2 * ch] / count - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        c = (1, -1, 1, 1)
        y = (xf - mean.view(c)) * (invstd * scale).view(c) + bias.view(c)
        ctx.save_for_backward(x, scale, mean, invstd)
        ctx.rank_sum, ctx.count = rank_sum, count
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, invstd = ctx.saved_tensors
        c = (1, -1, 1, 1)
        xhat = (x.float() - mean.view(c)) * invstd.view(c)
        dyf = dy.float()
        sum_dy = dyf.sum(dim=(0, 2, 3))
        sum_dy_xhat = (dyf * xhat).sum(dim=(0, 2, 3))
        if ctx.rank_sum is None:
            m = x.numel() // x.shape[1]
            mean_dy, mean_dy_xhat = sum_dy / m, sum_dy_xhat / m
        else:
            both = ctx.rank_sum(torch.cat([sum_dy, sum_dy_xhat])) / ctx.count
            mean_dy, mean_dy_xhat = both.chunk(2)
        dx = (invstd * scale).view(c) * (dyf - mean_dy.view(c) - xhat * mean_dy_xhat.view(c))
        return dx.to(x.dtype), sum_dy_xhat, sum_dy, None, None
