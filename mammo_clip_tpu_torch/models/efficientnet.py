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

``tpu_optimized`` builds the flagship layout of the JAX package: the stem and
every block above 1/4 scale give way to space-to-depth(4) of the image, a 3x3
conv to 128 channels (``tpu_stem_conv``, ``tpu_stem_bn``) and
``tpu_front_blocks`` MBConv blocks of 128 channels at 1/4 scale
(``tpu_front_block_{j}``, expand ratio ``tpu_front_expand``, no stochastic
depth, never rematerialised). The deep blocks keep their names, and their
drop rates and tap indices count from the original block 0; their widths come
from ``tpu_optimized_block_args`` (``tpu_dense_widths``, ``tpu_slim_stage3..7``).
The endpoints are renumbered from the first reduction after the front
(``reduction_1`` is the 1/4 map entering the first deep block). The fused
route is its own layout regime and is refused with it, as in JAX.

``quant_int8_k5`` runs the 1x1 expand (where the block has one) and project
convs of every k=5 block as int8 matmuls with straight-through gradients
(``ops/quant.py``), with the same parameters; it composes with
``tpu_optimized``, as in JAX. ``s2d_exec`` is a lane layout of the TPU
(``mammo_clip_tpu/ops/s2d_exec.py``: the same network function with the same
parameters, over space-to-depth(2) tensors); NCHW has no lanes to fill, so the
option runs the standard path. What it changes in JAX beyond the layout is
kept: the blocks it takes (``s2d_taken``) are not quantised, and it is refused
with ``fused_mbconv`` and with ``tpu_optimized``.

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
from ..ops.quant import int8_conv1x1
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
    expand_filters: int = 0  # explicit expanded width; 0 = in_filters * expand_ratio
    #   (the tpu_optimized width remap decouples it from the block's I/O widths)

    @property
    def expanded(self) -> int:
        return self.expand_filters or self.in_filters * self.expand_ratio


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


def _nearest128(c: int) -> int:
    lo = max(128, (c // 128) * 128)
    return lo if (c - lo) <= (lo + 128 - c) else lo + 128


def tpu_optimized_block_args(variant: str, dense_widths: bool = True, slim_stage3: int = 0,
                             slim_stage5: int = 0, slim_stage6: int = 0, slim_stage4: int = 0,
                             slim_stage7: int = 0) -> Tuple[List[BlockArgs], int]:
    """Deep-stage BlockArgs of the ``tpu_optimized`` layout, and the number of
    shallow blocks the space-to-depth front replaces (``skip``).

    The first surviving block takes C=128 at expand ratio 2; ``dense_widths``
    snaps every I/O width and every expanded width to the nearest multiple of
    128 (never below 128); ``slim_stageN`` overrides the expanded width of the
    blocks that stage's B5 width picks out (k5 at 384; k3 at 768; k5 at 1024,
    1056 without the dense remap; k5 at 1792 / 1824; k3 at 3072)."""
    args = scaled_block_args(variant)
    sc, skip = 2, 0
    for a in args:
        if sc > 4 or (sc == 4 and a.stride > 1):
            break
        sc *= a.stride
        skip += 1
    args = [dataclasses.replace(args[skip], in_filters=128, expand_ratio=2)] + args[skip + 1:]
    if dense_widths:
        args = [dataclasses.replace(a, in_filters=_nearest128(a.in_filters),
                                    out_filters=_nearest128(a.out_filters),
                                    expand_filters=_nearest128(a.expanded)) for a in args]
    slims = ((slim_stage3, 5, (384,)),
             (slim_stage5, 5, (1024,) if dense_widths else (1056,)),
             (slim_stage6, 5, (1792,) if dense_widths else (1824,)),
             (slim_stage4, 3, (768,)),
             (slim_stage7, 3, (3072,)))
    for width, kernel, targets in slims:  # in JAX's order: each sees the ones before
        if width:
            args = [dataclasses.replace(a, expand_filters=width)
                    if (a.kernel == kernel and a.expanded in targets) else a for a in args]
    return args, skip


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


def same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """TF/XLA 'SAME' padding for a k x k window at stride s (extra pixel at the
    end), filled with ``value``."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad order: W then H
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


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


class _TrainBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over NCHW, computed in fp32, returning y in x's type
    and the batch (mean, biased var). It keeps x (in its own type) and two
    per-channel vectors for the backward, which recomputes the normalised x:
    the composition of autograd ops keeps two fp32 copies of x instead (8 bytes
    an element where a bf16 x takes 2), which at the flagship's widths without
    remat does not fit a step at batch 8 on one 80 GB card."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        c = (1, -1, 1, 1)
        y = (xf - mean.view(c)) * (invstd * scale).view(c) + bias.view(c)
        ctx.save_for_backward(x, scale, mean, invstd)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, invstd = ctx.saved_tensors
        c = (1, -1, 1, 1)
        xhat = (x.float() - mean.view(c)) * invstd.view(c)
        dyf = dy.float()
        m = x.numel() // x.shape[1]
        sum_dy = dyf.sum(dim=(0, 2, 3))
        sum_dy_xhat = (dyf * xhat).sum(dim=(0, 2, 3))
        dx = (invstd * scale).view(c) * (dyf - (sum_dy / m).view(c)
                                         - xhat * (sum_dy_xhat / m).view(c))
        return dx.to(x.dtype), sum_dy_xhat, sum_dy, None


class BatchNorm(nn.Module):
    """Flax-semantics BatchNorm over NCHW: ``scale``/``bias`` params and
    ``mean``/``var`` running buffers. ``forward`` is pure and returns the
    batch (mean, var) in train mode; ``update`` applies the momentum step.
    ``eps`` and ``momentum`` (Flax's convention) default to EfficientNet's."""

    def __init__(self, features: int, eps: float = BN_EPS, momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool):
        if train:
            y, mean, var = _TrainBatchNorm.apply(x, self.scale, self.bias, self.eps)
            return y, (mean, var)
        c = (1, -1, 1, 1)
        y = (x.float() - self.mean.view(c)) * (torch.rsqrt(self.var + self.eps)
                                                * self.scale).view(c) + self.bias.view(c)
        return y.to(x.dtype), None

    @torch.no_grad()
    def update(self, stats):
        mean, var = stats
        self.mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
        self.var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)


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
                     fused: bool, quant: bool = False):
        """x NCHW (zero-padded beyond ``valid_hw`` on the fused route); ``quant``
        runs the 1x1 convs in int8 (unfused route). Returns (out, [batch stats
        per BN] or None)."""
        if fused and train:
            vh, vw = valid_hw or x.shape[2:]
            out, stats = fused_mbconv_e6(x, self.fused_params(), delta, vh, vw, BN_EPS)
            return out, [stats[i:i + 2] for i in range(0, len(stats), 2)]
        if fused and valid_hw is not None:  # eval on the fused route: keep the zero pads
            hp, wp = x.shape[2:]
            out, stats = self._unfused(x[:, :, :valid_hw[0], :valid_hw[1]], train, delta)
            return F.pad(out, (0, wp - valid_hw[1], 0, hp - valid_hw[0])), stats
        return self._unfused(x, train, delta, quant)

    def _unfused(self, x, train: bool, delta, quant: bool = False):
        stats = []

        def conv1x1(conv, t):
            return int8_conv1x1(t, conv.kernel, t.dtype) if quant else conv(t)

        def bn(mod, t):
            y, s = mod(t, train)
            stats.append(s)
            return y

        inputs = x
        if hasattr(self, "bn0"):
            x = F.silu(bn(self.bn0, conv1x1(self.expand_conv, x)))
        x = F.silu(bn(self.bn1, self.depthwise_conv(x)))
        x = self.se(x)
        x = bn(self.bn2, conv1x1(self.project_conv, x))
        if self.residual:
            if train and self.drop_rate > 0.0:
                x = x * delta.view(-1, 1, 1, 1).to(x.dtype)
            x = x + inputs
        return x, (stats if train else None)

    def forward(self, x, train: bool, delta, valid_hw=None, fused: bool = False,
                remat: bool = False, quant: bool = False):
        if remat and train:
            out, stats = checkpoint(self.pure_forward, x, train, delta, valid_hw, fused, quant,
                                    use_reentrant=False)
        else:
            out, stats = self.pure_forward(x, train, delta, valid_hw, fused, quant)
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
                 feature_taps: Sequence[int] = (),
                 tpu_optimized: bool = False, tpu_front_blocks: int = 2,
                 tpu_front_expand: int = 1, tpu_dense_widths: bool = True,
                 tpu_slim_stage3: int = 0, tpu_slim_stage4: int = 0,
                 tpu_slim_stage5: int = 0, tpu_slim_stage6: int = 0,
                 tpu_slim_stage7: int = 0, quant_int8_k5: bool = False,
                 s2d_exec: bool = False):
        super().__init__()
        self.variant, self.in_channels = variant, in_channels
        self.feature_taps = tuple(feature_taps)
        self.drop_connect_rate = drop_connect_rate
        self.remat, self.remat_max_reduction = remat, remat_max_reduction
        self.fused_mbconv, self.pooling, self.dtype = fused_mbconv, pooling, dtype
        self.tpu_optimized = tpu_optimized
        self.quant_int8_k5, self.s2d_exec = quant_int8_k5, s2d_exec
        n = len(scaled_block_args(variant))  # drop rates count the original blocks
        if tpu_optimized and (fused_mbconv or s2d_exec):
            raise ValueError("tpu_optimized is its own layout regime: fused_mbconv and "
                             "s2d_exec cannot be combined with it")
        if s2d_exec and fused_mbconv:
            raise ValueError("s2d_exec is its own layout regime: fused_mbconv cannot be "
                             "combined with it")
        if tpu_optimized:
            self.block_args, self.skip = tpu_optimized_block_args(
                variant, dense_widths=tpu_dense_widths, slim_stage3=tpu_slim_stage3,
                slim_stage5=tpu_slim_stage5, slim_stage6=tpu_slim_stage6,
                slim_stage4=tpu_slim_stage4, slim_stage7=tpu_slim_stage7)
            if any(t < self.skip for t in self.feature_taps):
                raise ValueError(f"tpu_optimized replaces blocks < {self.skip}; feature_taps "
                                 f"{self.feature_taps} reach into the removed front")
            self.tpu_stem_conv = Conv(16 * in_channels, 128, 3)
            self.tpu_stem_bn = BatchNorm(128)
            front = BlockArgs(kernel=3, stride=1, expand_ratio=tpu_front_expand,
                              in_filters=128, out_filters=128, se_ratio=0.25)
            self.front_blocks = [f"tpu_front_block_{j}" for j in range(tpu_front_blocks)]
            for name in self.front_blocks:
                self.add_module(name, MBConvBlock(front, 0.0))
        else:
            self.block_args, self.skip, self.front_blocks = scaled_block_args(variant), 0, []
            self.stem_conv = Conv(in_channels, stem_filters(variant), 3, 2)
            self.stem_bn = BatchNorm(stem_filters(variant))
        for idx0, a in enumerate(self.block_args):
            idx = idx0 + self.skip
            self.add_module(f"block_{idx}", MBConvBlock(a, drop_connect_rate * idx / n))
        self.head_conv = Conv(self.block_args[-1].out_filters, head_filters(variant), 1)
        self.head_bn = BatchNorm(head_filters(variant))

    def tap_channels(self) -> List[int]:
        """Channels of this encoder's tapped blocks' outputs, then of its head."""
        return ([self.block_args[t - self.skip].out_filters for t in self.feature_taps]
                + [head_filters(self.variant)])

    @property
    def out_dim(self) -> int:
        return head_filters(self.variant)

    def fused_ok(self, a: BlockArgs) -> bool:
        return (self.fused_mbconv and a.kernel == 3 and a.stride == 1
                and a.in_filters * a.expand_ratio <= FUSED_MAX_EXPANDED)

    def s2d_taken(self, a: BlockArgs, h: int, w: int) -> bool:
        """Whether JAX's ``s2d_exec`` runs this block over space-to-depth(2)
        tensors (``s2d_ok`` of its ``EfficientNet.__call__``) at an (h, w) input:
        even maps, and a stride-2 block or a narrow one (4 * E <= 128)."""
        return (self.s2d_exec and a.kernel in (3, 5) and h % 2 == 0 and w % 2 == 0
                and (a.stride == 2 or 4 * a.in_filters * a.expand_ratio <= 128))

    def quant_ok(self, a: BlockArgs, h: int, w: int) -> bool:
        """JAX's ``quant_int8`` of a block: k=5, on neither the fused nor the
        space-to-depth layout (the fused route takes only k=3 blocks here)."""
        return self.quant_int8_k5 and a.kernel == 5 and not self.s2d_taken(a, h, w)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict:
        if x.dim() != 4 or x.shape[-1] != self.in_channels:
            raise ValueError(f"expected NHWC with C={self.in_channels}, got {tuple(x.shape)}")

        def stem(conv, bn, t):
            t, stats = bn(conv(t), train)
            if stats is not None:
                bn.update(stats)
            return F.silu(t)

        if self.tpu_optimized:
            n, h, w, c = x.shape
            if h % 4 or w % 4:
                raise ValueError(f"space-to-depth(4) needs /4 dims, got {tuple(x.shape)}")
            # space-to-depth(4) with JAX's channel order (dy, dx, c)
            x = x.reshape(n, h // 4, 4, w // 4, 4, c).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(n, h // 4, w // 4, 16 * c).permute(0, 3, 1, 2).contiguous()
            x = stem(self.tpu_stem_conv, self.tpu_stem_bn, x.to(self.dtype))
            ones = drop_delta(n, 0.0, None, x.device)
            for name in self.front_blocks:
                x = getattr(self, name)(x, train, ones)
            scale = 4
        else:
            x = x.permute(0, 3, 1, 2).contiguous().to(self.dtype)
            x = stem(self.stem_conv, self.stem_bn, x)
            scale = 2

        nhwc = lambda t: t.permute(0, 2, 3, 1)
        endpoints: Dict[str, torch.Tensor] = {}
        taps: List[torch.Tensor] = []
        cur_h, cur_w = x.shape[2:]
        pad_hw = None  # (hpad, wpad) while x carries the fused run's zero pads
        unpadded = lambda t: t[:, :, :cur_h, :cur_w] if pad_hw is not None else t
        prev = x
        n_blocks = len(self.block_args) + self.skip
        for idx0, a in enumerate(self.block_args):
            idx = idx0 + self.skip  # the original numbering
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
                      fused=use_fused, remat=use_remat and not use_fused,
                      quant=self.quant_ok(a, cur_h, cur_w))
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
