"""EfficientNet-B0..B7 in PyTorch, the reference-exact path of
``mammo_clip_tpu/models/efficientnet.py``.

TF "SAME" asymmetric padding, SE blocks, swish, per-sample stochastic depth
scaled by block index, train-mode BatchNorm with Flax semantics: momentum 0.99
in the TF convention (torch momentum 0.01) and running variance updated with
the BIASED batch variance. Parameter and buffer names follow the Flax tree
(``block_4.bn1.scale``, ``block_4.bn1.var``...), with conv kernels stored in
torch's OIHW layout, so ``convert/from_jax.py`` maps one onto the other.

Images enter NHWC as in the JAX package; inside, tensors are NCHW. The encoder
returns ``{"pooled", "features", "endpoints"}`` with ``features`` and the
endpoints NHWC. ``fused_mbconv`` routes the k=3, stride-1 blocks with an
expanded width <= 256 through ``ops/mbconv6.fused_mbconv_e6`` in train mode
(the CUDA kernel on a card), padding H/W once per run of fused blocks.
``feature_taps`` (block indices) adds ``"taps"``: those blocks' outputs,
NHWC, in block order, the detector's C3/C4 (``default_detector_taps``).
The flagship ``tpu_*`` options, ``s2d_exec``, ``quant_int8_k5`` and
``packed_residuals`` belong to later slices.

Running statistics: each block computes its forward as a pure function that
returns its batch statistics, and the block applies the momentum update after
it. Under ``torch.utils.checkpoint`` the recomputation reruns only the pure
part, so statistics are updated once per call, in call order (two tower passes
in one step update twice, as the Flax module does).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.mbconv import BN_EPS, MBConvParams
from ..ops.mbconv6 import MBConv6Params, fused_mbconv_e6, pick_h_pad, pick_w_pad
from ..ops.pooling import gem_pool, global_avg_pool
from ..ops.stochastic import drop_delta

# (num_repeat, kernel, stride, expand_ratio, in_filters, out_filters, se_ratio)
_BASE_BLOCKS: Tuple[Tuple[int, int, int, int, int, int, float], ...] = (
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
)

# variant -> (width_mult, depth_mult, train_res, dropout)
_VARIANTS: Dict[str, Tuple[float, float, int, float]] = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5),
    "b7": (2.0, 3.1, 600, 0.5),
}

BN_MOMENTUM = 0.99  # TF convention (torch equivalent: momentum=0.01)
FUSED_MAX_EXPANDED = 256


def round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    """TF channel rounding: scale, snap to multiple of 8, never drop below 90%."""
    filters *= width_mult
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


@dataclasses.dataclass(frozen=True)
class BlockArgs:
    kernel: int
    stride: int
    expand_ratio: int
    in_filters: int
    out_filters: int
    se_ratio: float

    @property
    def expanded(self) -> int:
        return self.in_filters * self.expand_ratio


def scaled_block_args(variant: str) -> List[BlockArgs]:
    """Fully-unrolled per-block args for a variant (after width/depth scaling)."""
    width, depth, _, _ = _VARIANTS[variant]
    out: List[BlockArgs] = []
    for (r, k, s, e, i, o, se) in _BASE_BLOCKS:
        i_s, o_s = round_filters(i, width), round_filters(o, width)
        for j in range(round_repeats(r, depth)):
            out.append(BlockArgs(kernel=k, stride=s if j == 0 else 1, expand_ratio=e,
                                 in_filters=i_s if j == 0 else o_s, out_filters=o_s,
                                 se_ratio=se))
    return out


def stem_filters(variant: str) -> int:
    return round_filters(32, _VARIANTS[variant][0])


def head_filters(variant: str) -> int:
    return round_filters(1280, _VARIANTS[variant][0])


def default_detector_taps(variant: str) -> Tuple[int, int]:
    """Block indices tapped (block OUTPUT) as C3/C4 by the RetinaNet; C5 is the
    conv-head output.

    Reference: detector_model.py:374-391 hardcodes b5 source_layer_indexes
    [26,37] (channels 176/512) and b2 [15,21] (channels 120/352). Other
    variants take the analogous positions: the last block of the 112-filter
    stage and the last block of the 320-filter stage.
    """
    if variant == "b5":
        return (26, 37)
    if variant == "b2":
        return (15, 21)
    args = scaled_block_args(variant)
    s5_out = round_filters(112, _VARIANTS[variant][0])
    last_s5 = max(i for i, a in enumerate(args) if a.out_filters == s5_out)
    return (last_s5, len(args) - 1)


def tap_channels(variant: str, taps: Sequence[int]) -> List[int]:
    """Channels of the tapped blocks' outputs, then of the conv head."""
    args = scaled_block_args(variant)
    return [args[t].out_filters for t in taps] + [head_filters(variant)]


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TF/XLA 'SAME' padding for a k x k window at stride s (extra pixel at the end)."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad order: W then H
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class Conv(nn.Module):
    """Bias-optional conv with a Flax-named ``kernel`` in OIHW and SAME padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
                 bias: bool = False):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        self.kernel = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.conv2d(same_pad(x, self.k, self.stride), self.kernel.to(dt), bias,
                        self.stride, 0, 1, self.groups)


class BatchNorm(nn.Module):
    """Flax-semantics BatchNorm over NCHW: ``scale``/``bias`` params and
    ``mean``/``var`` running buffers. ``forward`` is pure and returns the
    batch (mean, var) in train mode; ``update`` applies the momentum step."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool):
        xf = x.float()
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            stats = (mean.detach(), var.detach())
        else:
            mean, var, stats = self.mean, self.var, None
        c = (1, -1, 1, 1)
        y = (xf - mean.view(c)) * (torch.rsqrt(var + BN_EPS) * self.scale).view(c) \
            + self.bias.view(c)
        return y.to(x.dtype), stats

    @torch.no_grad()
    def update(self, stats):
        mean, var = stats
        self.mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
        self.var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)


class SqueezeExcite(nn.Module):
    """SE block; the squeeze width comes from the block's INPUT filters."""

    def __init__(self, channels: int, squeezed: int):
        super().__init__()
        self.reduce = Conv(channels, squeezed, 1, bias=True)
        self.expand = Conv(squeezed, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class MBConvBlock(nn.Module):
    """One MBConv block. ``forward`` returns the output and applies this call's
    running-statistics update; ``pure_forward`` is the side-effect-free part."""

    def __init__(self, args: BlockArgs, drop_rate: float):
        super().__init__()
        a = args
        self.args, self.drop_rate = a, drop_rate
        e = a.expanded
        if e != a.in_filters:
            self.expand_conv = Conv(a.in_filters, e, 1)
            self.bn0 = BatchNorm(e)
        self.depthwise_conv = Conv(e, e, a.kernel, a.stride, groups=e)
        self.bn1 = BatchNorm(e)
        self.se = SqueezeExcite(e, max(1, int(a.in_filters * a.se_ratio)))
        self.project_conv = Conv(e, a.out_filters, 1)
        self.bn2 = BatchNorm(a.out_filters)

    @property
    def residual(self) -> bool:
        a = self.args
        return a.stride == 1 and a.in_filters == a.out_filters

    def _bns(self):
        return ([self.bn0] if hasattr(self, "bn0") else []) + [self.bn1, self.bn2]

    def fused_params(self):
        """The raw kernel parameters (views of this block's tensors)."""
        mat = lambda conv: conv.kernel[:, :, 0, 0].t()  # (Cout, Cin, 1, 1) -> (Cin, Cout)
        common = dict(
            dw_kernel=self.depthwise_conv.kernel[:, 0],
            gamma1=self.bn1.scale, beta1=self.bn1.bias,
            se_w1=mat(self.se.reduce), se_b1=self.se.reduce.bias,
            se_w2=mat(self.se.expand), se_b2=self.se.expand.bias,
            wp=mat(self.project_conv), gamma2=self.bn2.scale, beta2=self.bn2.bias)
        if hasattr(self, "bn0"):
            return MBConv6Params(we=mat(self.expand_conv), gamma0=self.bn0.scale,
                                 beta0=self.bn0.bias, **common)
        return MBConvParams(**common)

    def pure_forward(self, x, train: bool, delta, valid_hw: Optional[Tuple[int, int]],
                     fused: bool):
        """x NCHW (zero-padded beyond ``valid_hw`` on the fused route).
        Returns (out, [batch stats per BN] or None)."""
        if fused and train:
            vh, vw = valid_hw or x.shape[2:]
            out, stats = fused_mbconv_e6(x, self.fused_params(), delta, vh, vw, BN_EPS)
            return out, [stats[i:i + 2] for i in range(0, len(stats), 2)]
        if fused and valid_hw is not None:  # eval on the fused route: keep the zero pads
            hp, wp = x.shape[2:]
            out, stats = self._unfused(x[:, :, :valid_hw[0], :valid_hw[1]], train, delta)
            return F.pad(out, (0, wp - valid_hw[1], 0, hp - valid_hw[0])), stats
        return self._unfused(x, train, delta)

    def _unfused(self, x, train: bool, delta):
        stats = []

        def bn(mod, t):
            y, s = mod(t, train)
            stats.append(s)
            return y

        inputs = x
        if hasattr(self, "bn0"):
            x = F.silu(bn(self.bn0, self.expand_conv(x)))
        x = F.silu(bn(self.bn1, self.depthwise_conv(x)))
        x = self.se(x)
        x = bn(self.bn2, self.project_conv(x))
        if self.residual:
            if train and self.drop_rate > 0.0:
                x = x * delta.view(-1, 1, 1, 1).to(x.dtype)
            x = x + inputs
        return x, (stats if train else None)

    def forward(self, x, train: bool, delta, valid_hw=None, fused: bool = False,
                remat: bool = False):
        if remat and train:
            out, stats = checkpoint(self.pure_forward, x, train, delta, valid_hw, fused,
                                    use_reentrant=False)
        else:
            out, stats = self.pure_forward(x, train, delta, valid_hw, fused)
        if stats is not None:
            for mod, s in zip(self._bns(), stats):
                mod.update(s)
        return out


class EfficientNet(nn.Module):
    """Headless EfficientNet feature extractor (see module docstring)."""

    def __init__(self, variant: str = "b5", in_channels: int = 1,
                 drop_connect_rate: float = 0.2, remat: bool = False,
                 remat_max_reduction: int = 16, fused_mbconv: bool = False,
                 pooling: str = "avg", dtype: torch.dtype = torch.float32,
                 feature_taps: Sequence[int] = ()):
        super().__init__()
        self.variant, self.in_channels = variant, in_channels
        self.feature_taps = tuple(feature_taps)
        self.drop_connect_rate = drop_connect_rate
        self.remat, self.remat_max_reduction = remat, remat_max_reduction
        self.fused_mbconv, self.pooling, self.dtype = fused_mbconv, pooling, dtype
        self.block_args = scaled_block_args(variant)
        n = len(self.block_args)
        self.stem_conv = Conv(in_channels, stem_filters(variant), 3, 2)
        self.stem_bn = BatchNorm(stem_filters(variant))
        for idx, a in enumerate(self.block_args):
            self.add_module(f"block_{idx}", MBConvBlock(a, drop_connect_rate * idx / n))
        self.head_conv = Conv(self.block_args[-1].out_filters, head_filters(variant), 1)
        self.head_bn = BatchNorm(head_filters(variant))

    @property
    def out_dim(self) -> int:
        return head_filters(self.variant)

    def fused_ok(self, a: BlockArgs) -> bool:
        return (self.fused_mbconv and a.kernel == 3 and a.stride == 1
                and a.in_filters * a.expand_ratio <= FUSED_MAX_EXPANDED)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict:
        if x.dim() != 4 or x.shape[-1] != self.in_channels:
            raise ValueError(f"expected NHWC with C={self.in_channels}, got {tuple(x.shape)}")
        x = x.permute(0, 3, 1, 2).contiguous().to(self.dtype)
        x, stats = self.stem_bn(self.stem_conv(x), train)
        if stats is not None:
            self.stem_bn.update(stats)
        x = F.silu(x)

        nhwc = lambda t: t.permute(0, 2, 3, 1)
        endpoints: Dict[str, torch.Tensor] = {}
        taps: List[torch.Tensor] = []
        cur_h, cur_w = x.shape[2:]
        pad_hw = None  # (hpad, wpad) while x carries the fused run's zero pads
        unpadded = lambda t: t[:, :, :cur_h, :cur_w] if pad_hw is not None else t
        prev = x
        scale = 2
        n_blocks = len(self.block_args)
        for idx, a in enumerate(self.block_args):
            block = getattr(self, f"block_{idx}")
            use_remat = self.remat and scale <= self.remat_max_reduction
            use_fused = self.fused_ok(a)
            if use_fused:
                hp, wp = pick_h_pad(cur_h), pick_w_pad(cur_w)
                if (hp, wp) != (cur_h, cur_w):
                    if pad_hw != (hp, wp):
                        x = F.pad(unpadded(x), (0, wp - cur_w, 0, hp - cur_h))
                    pad_hw = (hp, wp)
                else:
                    x, pad_hw = unpadded(x), None
            elif pad_hw is not None:
                x, pad_hw = unpadded(x), None
            x = x.contiguous()
            rate = block.drop_rate if train else 0.0
            if not (use_fused or block.residual):
                rate = 0.0  # the unfused path drops only residual branches
            delta = drop_delta(x.shape[0], rate, generator, x.device)
            x = block(x, train, delta,
                      valid_hw=(cur_h, cur_w) if pad_hw is not None else None,
                      fused=use_fused, remat=use_remat and not use_fused)
            scale *= a.stride
            cur_h, cur_w = -(-cur_h // a.stride), -(-cur_w // a.stride)
            if a.stride > 1:
                endpoints[f"reduction_{len(endpoints) + 1}"] = nhwc(prev)
            elif idx == n_blocks - 1:
                endpoints[f"reduction_{len(endpoints) + 1}"] = nhwc(unpadded(x))
            if idx in self.feature_taps:
                taps.append(nhwc(unpadded(x)))
            prev = unpadded(x)
        x = unpadded(x)
        x, stats = self.head_bn(self.head_conv(x), train)
        if stats is not None:
            self.head_bn.update(stats)
        x = F.silu(x)
        endpoints[f"reduction_{len(endpoints) + 1}"] = nhwc(x)
        pooled = gem_pool(x, p=3.0) if self.pooling == "gem" else global_avg_pool(x)
        return {"pooled": pooled, "features": nhwc(x), "endpoints": endpoints,
                "taps": tuple(taps)}
