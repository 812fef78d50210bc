"""Headless ResNet-50/101/152 feature extractor (port of
``mammo_clip_tpu/models/resnet.py``).

Bottleneck-v1 topology with the [3,4,6,3] / [3,4,23,3] / [3,8,36,3] stage
repeats, returning ``pooled`` (N, 2048), the spatial mean, and ``features``,
the raw C5 map, NHWC. Convolutions use Flax's "SAME" padding
(``efficientnet.same_pad``: the extra pixel at the end on an even size at
stride 2, which the 7x7/2 stem, every stride-2 3x3 ``conv2`` and the 3x3/2
max pool meet); the max pool pads with -inf. BatchNorm is eps 1e-5 with
Flax momentum 0.9, the train-mode ``_TrainBatchNorm`` Function that keeps x
in its own type, and its running statistics are updated once per call. A
block has a ``downsample`` branch exactly where its residual's shape differs
from its output's, which includes stage 1 block 0 at stride 1 (64 -> 256
channels). Names follow the Flax tree (``stage3_block5.conv2.kernel``,
``stem_bn.var``...), conv kernels in OIHW.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pooling import global_avg_pool
from .efficientnet import BatchNorm, Conv, same_pad

_STAGES: Dict[str, Sequence[int]] = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}

RESNET_BN_EPS = 1e-5
RESNET_BN_MOMENTUM = 0.9


def _bn(features: int) -> BatchNorm:
    return BatchNorm(features, eps=RESNET_BN_EPS, momentum=RESNET_BN_MOMENTUM)


def _bn_call(bn: BatchNorm, x: torch.Tensor, train: bool) -> torch.Tensor:
    y, stats = bn(x, train)
    if stats is not None:
        bn.update(stats)
    return y


class Bottleneck(nn.Module):
    def __init__(self, cin: int, filters: int, strides: int = 1):
        super().__init__()
        self.conv1 = Conv(cin, filters, 1)
        self.bn1 = _bn(filters)
        self.conv2 = Conv(filters, filters, 3, strides)
        self.bn2 = _bn(filters)
        self.conv3 = Conv(filters, filters * 4, 1)
        self.bn3 = _bn(filters * 4)
        # residual.shape != y.shape: a channel change or a stride
        if cin != filters * 4 or strides != 1:
            self.downsample = Conv(cin, filters * 4, 1, strides)
            self.downsample_bn = _bn(filters * 4)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(_bn_call(self.bn1, self.conv1(x), train))
        y = F.relu(_bn_call(self.bn2, self.conv2(y), train))
        y = _bn_call(self.bn3, self.conv3(y), train)
        residual = x
        if hasattr(self, "downsample"):
            residual = _bn_call(self.downsample_bn, self.downsample(x), train)
        return F.relu(y + residual)


class ResNet(nn.Module):
    def __init__(self, variant: str = "resnet101", in_channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        stages = _STAGES[variant]  # KeyError for an unknown name, as in JAX
        self.variant, self.in_channels, self.dtype = variant, in_channels, dtype
        self.stem_conv = Conv(in_channels, 64, 7, 2)
        self.stem_bn = _bn(64)
        self.blocks = []
        cin = 64
        for stage, reps in enumerate(stages):
            filters = 64 * 2 ** stage
            for i in range(reps):
                name = f"stage{stage + 1}_block{i}"
                self.add_module(name, Bottleneck(cin, filters, 2 if (i == 0 and stage > 0) else 1))
                self.blocks.append(name)
                cin = filters * 4

    @property
    def out_dim(self) -> int:
        return 2048

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if x.dim() != 4 or x.shape[-1] != self.in_channels:
            raise ValueError(f"expected NHWC with C={self.in_channels}, got {tuple(x.shape)}")
        x = x.permute(0, 3, 1, 2).contiguous().to(self.dtype)
        x = F.relu(_bn_call(self.stem_bn, self.stem_conv(x), train))
        x = F.max_pool2d(same_pad(x, 3, 2, value=float("-inf")), 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        return {"pooled": global_avg_pool(x), "features": x.permute(0, 2, 3, 1)}
