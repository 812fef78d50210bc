"""EfficientNet image tower in plain PyTorch, over a dict of named weights.

The architecture of Tan & Le (2019) as the TF reference implements it and as
Mammo-CLIP runs it (timm's ``tf_efficientnet_b5_ns``, one input channel):
TF "SAME" padding, MBConv blocks with squeeze-excitation (squeeze width from
the block's input filters), swish, per-sample stochastic depth on residual
blocks at ``drop_connect_rate * block / blocks``, train-mode BatchNorm with
the biased batch variance and eps 1e-3, a 1x1 head conv and a global average
pool. Names follow the measured program's state dict
(``image_encoder.block_4.bn1.scale``), so one set of weights serves both.

Departure from a textbook forward, for memory only: each block runs under
``torch.utils.checkpoint`` in train mode (the same function; its random
draws are made outside it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .precision import Precision

BN_EPS = 1e-3

# (repeats, kernel, stride, expand, in, out, se_ratio) of B0
BASE_BLOCKS = (
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
)
# variant -> (width multiplier, depth multiplier)
VARIANTS = {"b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
            "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1)}


def round_filters(filters: float, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


@dataclasses.dataclass(frozen=True)
class Block:
    kernel: int
    stride: int
    expand: int
    cin: int
    cout: int
    squeeze: int

    @property
    def expanded(self) -> int:
        return self.cin * self.expand

    @property
    def residual(self) -> bool:
        return self.stride == 1 and self.cin == self.cout


def variant_of(name: str) -> str:
    for v in VARIANTS:
        if v in name:
            return v
    raise ValueError(f"not an EfficientNet name: {name}")


def blocks(variant: str) -> List[Block]:
    width, depth = VARIANTS[variant]
    out = []
    for r, k, s, e, i, o, se in BASE_BLOCKS:
        i_s, o_s = round_filters(i, width), round_filters(o, width)
        for j in range(int(math.ceil(depth * r))):
            cin = i_s if j == 0 else o_s
            out.append(Block(k, s if j == 0 else 1, e, cin, o_s, max(1, int(cin * se))))
    return out


def stem_width(variant: str) -> int:
    return round_filters(32, VARIANTS[variant][0])


def head_width(variant: str) -> int:
    return round_filters(1280, VARIANTS[variant][0])


def param_shapes(variant: str, in_channels: int = 1, prefix: str = "image_encoder."
                 ) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """({parameter: shape}, {BatchNorm running buffer: shape}), in order."""
    params: Dict[str, tuple] = {}
    buffers: Dict[str, tuple] = {}

    def bn(name, c):
        params[f"{prefix}{name}.scale"] = (c,)
        params[f"{prefix}{name}.bias"] = (c,)
        buffers[f"{prefix}{name}.mean"] = (c,)
        buffers[f"{prefix}{name}.var"] = (c,)

    params[f"{prefix}stem_conv.kernel"] = (stem_width(variant), in_channels, 3, 3)
    bn("stem_bn", stem_width(variant))
    for i, b in enumerate(blocks(variant)):
        p, e = f"block_{i}", b.expanded
        if b.expand != 1:
            params[f"{prefix}{p}.expand_conv.kernel"] = (e, b.cin, 1, 1)
            bn(f"{p}.bn0", e)
        params[f"{prefix}{p}.depthwise_conv.kernel"] = (e, 1, b.kernel, b.kernel)
        bn(f"{p}.bn1", e)
        params[f"{prefix}{p}.se.reduce.kernel"] = (b.squeeze, e, 1, 1)
        params[f"{prefix}{p}.se.reduce.bias"] = (b.squeeze,)
        params[f"{prefix}{p}.se.expand.kernel"] = (e, b.squeeze, 1, 1)
        params[f"{prefix}{p}.se.expand.bias"] = (e,)
        params[f"{prefix}{p}.project_conv.kernel"] = (b.cout, e, 1, 1)
        bn(f"{p}.bn2", b.cout)
    params[f"{prefix}head_conv.kernel"] = (head_width(variant), blocks(variant)[-1].cout, 1, 1)
    bn("head_bn", head_width(variant))
    return params, buffers


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class Tower:
    """The tower's forward over weights ``w`` (names with ``prefix``) in
    precision ``prec``. ``stats`` (a list), when given, collects every train-mode
    BatchNorm's batch (mean, var) in order."""

    def __init__(self, w: Dict[str, torch.Tensor], variant: str, prec: Precision,
                 prefix: str = "image_encoder.", drop_connect_rate: float = 0.2,
                 stats: Optional[list] = None):
        self.w, self.variant, self.prec, self.prefix = w, variant, prec, prefix
        self.blocks = blocks(variant)
        self.drop_connect_rate = drop_connect_rate
        self.stats = stats

    def _w(self, name):
        return self.w[self.prefix + name]

    def conv(self, x, name, k, stride=1, groups=1, bias=False):
        kern = self.prec.operand(self._w(name + ".kernel"))
        b = self._w(name + ".bias") if bias else None
        y = F.conv2d(same_pad(self.prec.operand(x), k, stride), kern, b, stride, 0, 1, groups)
        return self.prec.result(y)

    def bn(self, x, name, train):
        c = (1, -1, 1, 1)
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            if self.stats is not None:
                self.stats.append((mean.detach(), var.detach()))
        else:
            mean, var = self._w(name + ".mean"), self._w(name + ".var")
        y = (x - mean.view(c)) * torch.rsqrt(var + BN_EPS).view(c)
        return y * self._w(name + ".scale").view(c) + self._w(name + ".bias").view(c)

    def block(self, i, x, delta, train):
        b, p = self.blocks[i], f"block_{i}"
        inputs = x
        if b.expand != 1:
            x = F.silu(self.bn(self.conv(x, f"{p}.expand_conv", 1), f"{p}.bn0", train))
        x = self.conv(x, f"{p}.depthwise_conv", b.kernel, b.stride, groups=b.expanded)
        x = F.silu(self.bn(x, f"{p}.bn1", train))
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.conv(F.silu(self.conv(s, f"{p}.se.reduce", 1, bias=True)), f"{p}.se.expand", 1,
                      bias=True)
        x = x * torch.sigmoid(s)
        x = self.bn(self.conv(x, f"{p}.project_conv", 1), f"{p}.bn2", train)
        if b.residual:
            if delta is not None:
                x = x * delta.view(-1, 1, 1, 1)
            x = x + inputs
        return x

    def drop_rates(self) -> List[float]:
        n = len(self.blocks)
        return [self.drop_connect_rate * i / n for i in range(n)]

    def __call__(self, images: torch.Tensor, train: bool,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC images -> (N, head width) pooled features. In train mode each
        residual block with a drop rate draws its (N,) keep mask from
        ``generator`` before it runs, in block order."""
        x = images.permute(0, 3, 1, 2).float()
        x = F.silu(self.bn(self.conv(x, "stem_conv", 3, 2), "stem_bn", train))
        n = x.shape[0]
        for i, (b, rate) in enumerate(zip(self.blocks, self.drop_rates())):
            delta = None
            if train and rate > 0.0 and b.residual:
                keep = 1.0 - rate
                u = torch.rand(n, generator=generator, device=x.device)
                delta = (u < keep).float() / keep
            if train and self.stats is None:
                x = checkpoint(self.block, i, x, delta, train, use_reentrant=False)
            else:
                x = self.block(i, x, delta, train)
        x = F.silu(self.bn(self.conv(x, "head_conv", 1), "head_bn", train))
        return x.mean(dim=(2, 3))
