"""The standalone fused e=1 MBConv block (port of ``mammo_clip_tpu/ops/mbconv_pallas.py``),
and the pieces the e6 kernel (``ops/mbconv6.py``) shares with it.

``fused_mbconv_e1(x, params, delta)`` computes one whole e=1 block with exact
batch-statistics BatchNorm:

  x --dw3x3--> d --bn1,silu--> v --SE--> u --Wp--> y --bn2--> yhat ;
  out = delta * yhat [+ x]

and returns ``(out, (mean1, var1, mean2, var2))``. It is the function the e=1
form of ``fused_mbconv_e6`` (``ops/mbconv6.py``) computes on an image with no
pad region, so on a CUDA tensor it runs that form's hand-written passes of
``csrc/mbconv6_e6.cu`` with valid_h = H and valid_w = W: they keep only x, the
statistics and a few per-image vectors from forward to backward and recompute
the rest from x on chip, as the Pallas kernel does, with the same bits as
``fused_mbconv_e6(x, params, delta, H, W)``. Its own contract stays: H % 8 == 0
on every device (the Pallas kernel's tile), the zero gradient of delta, and its
own launch counts (``mbconv1.<direction>``). A CPU tensor takes the plain
PyTorch version (``plain_fused_mbconv_e1``). The model routes its e=1 blocks
through ``fused_mbconv_e6``, as the JAX model does, so nothing on the training
path calls this function.

``MBConvParams`` is the e=1 block's raw parameter set, ``_se_gate`` the SE MLP
that runs outside the kernels on (N, C) vectors, ``mbconv_e1_reference`` the
unfused train-mode math, and ``launches`` counts the kernel paths' calls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
E1_MAX_C = 64  # the e=1 form's kernels (ops/mbconv6.py): C (= E) and C2 at most


class MBConvParams(NamedTuple):
    """Raw parameters of an e=1 MBConv block, all fp32.

    dw_kernel: (C, 3, 3)  depthwise taps
    gamma1, beta1: (C,)   bn1 scale/bias
    se_w1: (C, S), se_b1: (S,), se_w2: (S, C), se_b2: (C,)
    wp: (C, C2)           project kernel (wp[c_in, c_out])
    gamma2, beta2: (C2,)  bn2 scale/bias
    """

    dw_kernel: torch.Tensor
    gamma1: torch.Tensor
    beta1: torch.Tensor
    se_w1: torch.Tensor
    se_b1: torch.Tensor
    se_w2: torch.Tensor
    se_b2: torch.Tensor
    wp: torch.Tensor
    gamma2: torch.Tensor
    beta2: torch.Tensor


def _se_gate(s_mean: torch.Tensor, p):
    """s_mean: (N, C) spatial mean -> gate (N, C) and the SE intermediates."""
    z1 = s_mean @ p.se_w1 + p.se_b1
    a1 = F.silu(z1)
    z2 = a1 @ p.se_w2 + p.se_b2
    return torch.sigmoid(z2), (z1, a1, z2)


def batch_stats(t: torch.Tensor):
    """Biased per-channel (mean, var) of an NCHW fp32 tensor, as E[t^2] - E[t]^2
    clamped at 0 (the formula the JAX kernels and Flax BatchNorm use)."""
    mean = t.mean(dim=(0, 2, 3))
    var = torch.clamp((t * t).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    return mean, var


def _bn(t, mean, var, gamma, beta, eps):
    c = (-1, 1, 1)
    return (t - mean.view(c)) * torch.rsqrt(var + eps).view(c) * gamma.view(c) + beta.view(c)


def bn_train(t, gamma, beta, eps, rank_sum=None):
    """Train-mode BatchNorm of NCHW fp32 ``t``: (bn(t), mean, var) with t's batch
    statistics, or with those of every data-parallel rank's batch when
    ``rank_sum`` (``core/mesh.py::RankSum``) is given (``ops/batchnorm.py``,
    whose backward sums over the ranks too)."""
    if rank_sum is None:
        mean, var = batch_stats(t)
        return _bn(t, mean, var, gamma, beta, eps), mean, var
    from .batchnorm import TrainBatchNorm

    return TrainBatchNorm.apply(t, gamma, beta, eps, rank_sum)


def _tail(x, xf, d, p, delta, eps, rank_sum=None):
    """bn1 -> silu -> SE -> project -> bn2 -> x delta [-> + x], shared by both forms."""
    b1, mean1, var1 = bn_train(d, p.gamma1, p.beta1, eps, rank_sum)
    v = F.silu(b1)
    gate, _ = _se_gate(v.mean(dim=(2, 3)), p)
    u = v * gate[:, :, None, None]
    y = torch.einsum("nehw,ec->nchw", u, p.wp)
    b2, mean2, var2 = bn_train(y, p.gamma2, p.beta2, eps, rank_sum)
    out = delta[:, None, None, None] * b2
    if p.wp.shape[1] == x.shape[1]:  # residual iff C_in == C_out (stride is 1)
        out = out + xf
    return out.to(x.dtype), (mean1, var1, mean2, var2)


def depthwise3x3(t: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """SAME-padded 3x3 depthwise conv of NCHW ``t`` with taps ``k`` (C, 3, 3)."""
    return F.conv2d(t, k[:, None], padding=1, groups=t.shape[1])


def mbconv_e1_reference(x, p: MBConvParams, delta, eps: float = BN_EPS, rank_sum=None):
    """Unfused NCHW reference of the e=1 block math (train-mode BN, over every
    rank's batch with ``rank_sum``)."""
    xf = x.float()
    return _tail(x, xf, depthwise3x3(xf, p.dw_kernel), p, delta, eps, rank_sum)


class LaunchCounter:
    """Calls of the kernel paths, by key; here ``mbconv6.<form>.<direction>`` for
    the e6 kernel in each block form and ``mbconv1.<direction>`` for the e1
    kernel (``ops/flash_attention.py`` and ``ops/probes.py`` keep their own)."""

    KEYS = ("mbconv6.e6.forward", "mbconv6.e6.backward", "mbconv6.e1.forward",
            "mbconv6.e1.backward", "mbconv1.forward", "mbconv1.backward")

    def __init__(self, keys=None):
        if keys is not None:
            self.KEYS = tuple(keys)
        self.reset()

    def reset(self):
        self.counts = dict.fromkeys(self.KEYS, 0)

    def add(self, key: str):
        self.counts[key] += 1

    def total(self, kernel: str, direction: str) -> int:
        return sum(v for k, v in self.counts.items()
                   if k.startswith(kernel + ".") and k.endswith("." + direction))


launches = LaunchCounter()


# ----------------------------------------------------------------------------
# fused_mbconv_e1: plain version
# ----------------------------------------------------------------------------


def plain_fused_mbconv_e1(x, params: MBConvParams, delta, eps: float = BN_EPS, rank_sum=None):
    """The e1 kernel's function in plain PyTorch (fp32 inside): the reference
    with the kernel's gradient contract. The stats are detached (their
    cotangents are ignored) and delta gets no gradient (the JAX VJP returns
    zeros for it: it is a random draw, not a parameter)."""
    out, stats = mbconv_e1_reference(x, params, delta.detach(), eps, rank_sum)
    return out, tuple(s.detach() for s in stats)


# ----------------------------------------------------------------------------
# fused_mbconv_e1: kernel path (the e=1 form's passes of csrc/mbconv6_e6.cu)
# ----------------------------------------------------------------------------


class _FusedMBConvE1(torch.autograd.Function):
    """The block over the whole image: ``ops/mbconv6.py``'s ``_e1_forward`` and
    ``_e1_backward`` with valid_h = H and valid_w = W (imported at call time:
    mbconv6 imports this module)."""

    @staticmethod
    def forward(ctx, x, delta, eps, rank_sum, *flat):
        from .mbconv6 import _e1_forward

        p = MBConvParams(*flat)
        out, stats, kept = _e1_forward(x, p, delta, x.shape[2], x.shape[3], eps, rank_sum)
        launches.add("mbconv1.forward")
        ctx.eps, ctx.rank_sum = eps, rank_sum
        ctx.save_for_backward(x, delta, *flat, *stats, *kept)
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, g, *_stat_grads):  # stat cotangents are ignored (mbconv_pallas.py:579)
        from .mbconv6 import _e1_backward

        x, delta, *rest = ctx.saved_tensors
        p = MBConvParams(*rest[:10])
        stats, kept = rest[10:14], rest[14:]
        dx, dp = _e1_backward(x, p, delta, x.shape[2], x.shape[3], ctx.eps,
                              g.to(x.dtype).contiguous(), stats, kept, ctx.rank_sum)
        launches.add("mbconv1.backward")
        return (dx, torch.zeros_like(delta), None, None, *dp)


def _validate_e1(x, p: MBConvParams, delta):
    """Raise on what the e1 kernel does not take (its CPU plain version too, for H)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    N, C, H, W = x.shape
    if H % 8:
        raise ValueError(f"H={H} not divisible by a supported tile height (mult of 8)")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv_e1 runs on CUDA or CPU tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NCHW)")
    C2, S = p.wp.shape[1], p.se_w1.shape[1]
    if not (C <= E1_MAX_C and C2 <= E1_MAX_C):
        raise ValueError(f"the e1 kernel takes at most {E1_MAX_C} channels, got {C} -> {C2}")
    expect = dict(dw_kernel=(C, 3, 3), gamma1=(C,), beta1=(C,), se_w1=(C, S), se_b1=(S,),
                  se_w2=(S, C), se_b2=(C,), wp=(C, C2), gamma2=(C2,), beta2=(C2,))
    for name, t in zip(p._fields, p):
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"{name} must be {expect[name]}, got {tuple(t.shape)}")
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"param {name} must be float32 on {x.device}")
    if (delta.shape != (N,) or delta.dtype != torch.float32 or delta.device != x.device
            or not delta.is_contiguous()):
        raise ValueError("delta must be a contiguous float32 (N,) tensor on x's device")


def fused_mbconv_e1(x, params: MBConvParams, delta, eps: float = BN_EPS, rank_sum=None):
    """x: (N, C, H, W) float32 or bfloat16 with H % 8 == 0; params: MBConvParams
    (fp32; C_in -> C2 <= 64 channels on the card); delta: (N,) per-image
    drop-connect scale. Returns (out (N, C2, H, W) in x's dtype, (mean1, var1,
    mean2, var2)); the residual is added iff C2 == C. The stats carry no
    gradient and delta's gradient is zero. ``rank_sum`` (None: this batch
    alone) sums the batch sums over data-parallel ranks, as in
    ``ops/mbconv6.py::fused_mbconv_e6``."""
    _validate_e1(x, params, delta)
    if x.device.type == "cpu":
        return plain_fused_mbconv_e1(x, params, delta, eps, rank_sum)
    out, *stats = _FusedMBConvE1.apply(x, delta, eps, rank_sum, *params)
    return out, tuple(stats)
