"""The standalone fused e=1 MBConv block (port of ``mammo_clip_tpu/ops/mbconv_pallas.py``),
and the pieces the e6 kernel (``ops/mbconv6.py``) shares with it.

``fused_mbconv_e1(x, params, delta)`` computes one whole e=1 block with exact
batch-statistics BatchNorm:

  x --dw3x3--> d --bn1,silu--> v --SE--> u --Wp--> y --bn2--> yhat ;
  out = delta * yhat [+ x]

and returns ``(out, (mean1, var1, mean2, var2))``. On a CUDA tensor it runs the
hand-written kernels of ``csrc/mbconv1.cu``, which keep only x and a few
per-channel and per-image vectors from forward to backward and recompute the
rest in 3 forward and 3 backward passes, as the Pallas kernel does; the BN2
stats come analytically from the per-image second moments M = sum v v^T. A CPU
tensor takes the plain PyTorch version (``plain_fused_mbconv_e1``). The model
routes its e=1 blocks through ``fused_mbconv_e6``, as the JAX model does, so
nothing on the training path calls this function.

``MBConvParams`` is the e=1 block's raw parameter set, ``_se_gate`` the SE MLP
that runs outside the kernels on (N, C) vectors, ``mbconv_e1_reference`` the
unfused train-mode math, and ``launches`` counts the kernel paths' calls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-3


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


def _tail(x, xf, d, p, delta, eps):
    """bn1 -> silu -> SE -> project -> bn2 -> x delta [-> + x], shared by both forms."""
    mean1, var1 = batch_stats(d)
    v = F.silu(_bn(d, mean1, var1, p.gamma1, p.beta1, eps))
    gate, _ = _se_gate(v.mean(dim=(2, 3)), p)
    u = v * gate[:, :, None, None]
    y = torch.einsum("nehw,ec->nchw", u, p.wp)
    mean2, var2 = batch_stats(y)
    out = delta[:, None, None, None] * _bn(y, mean2, var2, p.gamma2, p.beta2, eps)
    if p.wp.shape[1] == x.shape[1]:  # residual iff C_in == C_out (stride is 1)
        out = out + xf
    return out.to(x.dtype), (mean1, var1, mean2, var2)


def depthwise3x3(t: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """SAME-padded 3x3 depthwise conv of NCHW ``t`` with taps ``k`` (C, 3, 3)."""
    return F.conv2d(t, k[:, None], padding=1, groups=t.shape[1])


def mbconv_e1_reference(x, p: MBConvParams, delta, eps: float = BN_EPS):
    """Unfused NCHW reference of the e=1 block math (train-mode BN)."""
    xf = x.float()
    return _tail(x, xf, depthwise3x3(xf, p.dw_kernel), p, delta, eps)


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


def plain_fused_mbconv_e1(x, params: MBConvParams, delta, eps: float = BN_EPS):
    """The e1 kernel's function in plain PyTorch (fp32 inside): the reference
    with the kernel's gradient contract. The stats are detached (their
    cotangents are ignored) and delta gets no gradient (the JAX VJP returns
    zeros for it: it is a random draw, not a parameter)."""
    out, stats = mbconv_e1_reference(x, params, delta.detach(), eps)
    return out, tuple(s.detach() for s in stats)


# ----------------------------------------------------------------------------
# fused_mbconv_e1: kernel path (csrc/mbconv1.cu)
# ----------------------------------------------------------------------------


def _mm(a, b):
    """``a @ b`` for the small host-side products (vectors of N or C entries),
    as a broadcast multiply and a sum: no cuBLAS call."""
    return (a.unsqueeze(-1) * b).sum(-2)


def _se_forward(s_mean, p: MBConvParams):
    z1 = _mm(s_mean, p.se_w1) + p.se_b1
    a1 = F.silu(z1)
    z2 = _mm(a1, p.se_w2) + p.se_b2
    return torch.sigmoid(z2), (z1, a1, z2)


def _dsilu(t):
    s = torch.sigmoid(t)
    return s * (1.0 + t * (1.0 - s))


def _ptrs(ts):
    """Device pointers of contiguous copies of ``ts``, and the copies: the caller
    holds them until the launch is enqueued, so no two share freed memory."""
    ts = [t.contiguous() for t in ts]
    return [t.data_ptr() for t in ts], ts


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


class E1Passes:
    """The passes of ``csrc/mbconv1.cu`` for one call's shapes, at the tensor level:
    p1..p3 and b1..b3 return the reductions (per image and in total) or the
    tensors that ``_e1_forward`` and ``_e1_backward`` combine."""

    def __init__(self, lib, x, C2: int):
        self.lib, self.x = lib, x
        self.N, self.C, self.H, self.W = x.shape
        self.C2 = C2
        self.nt = self.H // lib.mb1_rows()
        self.bf16 = int(x.dtype == torch.bfloat16)
        self.residual = int(C2 == self.C)
        self.stream = torch.cuda.current_stream(x.device).cuda_stream if x.is_cuda else None

    def _part(self, K):
        return torch.empty(self.N * self.nt, K, device=self.x.device, dtype=torch.float32)

    def _sums(self, part):
        """(per-image (N, K), total (K,)) sums of a pass's per-block partials."""
        K = part.shape[1]
        out_n = torch.empty(self.N, K, device=part.device, dtype=torch.float32)
        out = torch.empty(K, device=part.device, dtype=torch.float32)
        _check(self.lib.mb1_reduce_tiles(part.data_ptr(), out_n.data_ptr(), out.data_ptr(),
                                         self.N, self.nt, K, self.stream), "mb1_reduce_tiles")
        return out_n, out

    def p1(self, k9):
        part = self._part(2 * self.C)
        (k9p,), _keep = _ptrs([k9])
        _check(self.lib.mb1_p1(self.x.data_ptr(), self.bf16, k9p, part.data_ptr(), self.N,
                               self.C, self.H, self.W, self.stream), "mb1_p1")
        return self._sums(part)[1]

    def p2(self, *vecs):  # k9, m1, a1, b1
        part = self._part(self.C + self.C * self.C)
        ptrs, _keep = _ptrs(vecs)
        _check(self.lib.mb1_p2(self.x.data_ptr(), self.bf16, *ptrs, part.data_ptr(), self.N,
                               self.C, self.H, self.W, self.stream), "mb1_p2")
        return self._sums(part)[0]

    def p3(self, *vecs):  # k9, m1, a1, b1, gate, wp, m2, a2, b2, delta
        out = torch.empty(self.N, self.C2, self.H, self.W, device=self.x.device,
                          dtype=self.x.dtype)
        ptrs, _keep = _ptrs(vecs)
        _check(self.lib.mb1_p3(self.x.data_ptr(), self.bf16, *ptrs, self.residual,
                               out.data_ptr(), self.N, self.C, self.C2, self.H, self.W,
                               self.stream), "mb1_p3")
        return out

    def b1(self, g, *vecs):  # k9, m1, a1, b1, gate, wp, m2, inv2, delta
        part = self._part(2 * self.C2 + 2 * self.C * self.C2)
        ptrs, _keep = _ptrs(vecs)
        _check(self.lib.mb1_b1(self.x.data_ptr(), g.data_ptr(), self.bf16, *ptrs,
                               part.data_ptr(), self.N, self.C, self.C2, self.H, self.W,
                               self.stream), "mb1_b1")
        return self._sums(part)

    def b2(self, g, *vecs):
        part = self._part(2 * self.C + self.C * self.C2 + 27 * self.C)
        ptrs, _keep = _ptrs(vecs)
        _check(self.lib.mb1_b2(self.x.data_ptr(), g.data_ptr(), self.bf16, *ptrs,
                               part.data_ptr(), self.N, self.C, self.C2, self.H, self.W,
                               self.stream), "mb1_b2")
        return self._sums(part)[1]

    def b3(self, g, *vecs):
        dx = torch.empty_like(self.x)
        ptrs, _keep = _ptrs(vecs)
        _check(self.lib.mb1_b3(self.x.data_ptr(), g.data_ptr(), self.bf16, *ptrs,
                               self.residual, dx.data_ptr(), self.N, self.C, self.C2, self.H,
                               self.W, self.stream), "mb1_b3")
        return dx


def _e1_forward(k: E1Passes, x, p: MBConvParams, delta, eps):
    """P1, P2, P3 with the host-side stats between them (mbconv_pallas.py:483-569).
    Returns (out, (mean1, var1, mean2, var2), (s_mean, gate))."""
    N, C, H, W = x.shape
    hw, nhw = H * W, N * H * W
    k9 = p.dw_kernel.reshape(C, 9)
    s1 = k.p1(k9)
    mean1 = s1[:C] / nhw
    var1 = torch.clamp(s1[C:] / nhw - mean1 * mean1, min=0.0)
    a1 = p.gamma1 * torch.rsqrt(var1 + eps)
    sn = k.p2(k9, mean1, a1, p.beta1)
    s_sum, m_img = sn[:, :C], sn[:, C:].view(N, C, C)
    s_mean = s_sum / hw
    gate, _ = _se_forward(s_mean, p)
    # BN2 stats analytically: y = (v * gate) Wp is linear in v (mbconv_pallas.py:536-542)
    mean2 = _mm((gate * s_sum).sum(0), p.wp) / nhw
    gg_m = (gate[:, :, None] * gate[:, None, :] * m_img).sum(0)
    ey2 = (p.wp[:, None, :] * gg_m[:, :, None] * p.wp[None, :, :]).sum((0, 1)) / nhw
    var2 = torch.clamp(ey2 - mean2 * mean2, min=0.0)
    a2 = p.gamma2 * torch.rsqrt(var2 + eps)
    out = k.p3(k9, mean1, a1, p.beta1, gate, p.wp, mean2, a2, p.beta2, delta)
    return out, (mean1, var1, mean2, var2), (s_mean, gate)


def _e1_backward(k: E1Passes, x, p: MBConvParams, delta, stats, s_mean, gate, g, eps):
    """B1, B2, B3 with the host-side SE backward and dK between them
    (mbconv_pallas.py:577-742). Returns (dx, parameter gradients)."""
    N, C, H, W = x.shape
    C2 = p.wp.shape[1]
    hw, nhw = H * W, N * H * W
    mean1, var1, mean2, var2 = stats
    inv1, inv2 = torch.rsqrt(var1 + eps), torch.rsqrt(var2 + eps)
    a1, k2 = p.gamma1 * inv1, p.gamma2 * inv2
    k9 = p.dw_kernel.reshape(C, 9)
    tn, r2 = k.b1(g, k9, mean1, a1, p.beta1, gate, p.wp, mean2, inv2, delta)
    r2 = r2[:2 * C2]
    t1 = tn[:, 2 * C2:2 * C2 + C * C2].view(N, C, C2)
    t2 = tn[:, 2 * C2 + C * C2:].view(N, C, C2)
    alpha, beta_r = k2 * r2[:C2] / nhw, k2 * r2[C2:] / nhw

    # SE backward from the bilinear sums T1, T2 (mbconv_pallas.py:638-659)
    dg = (((p.wp * k2) * t1).sum(-1) - (p.wp * alpha).sum(-1) * (s_mean * hw)
          - ((p.wp * beta_r) * t2).sum(-1))
    _, (z1, act1, z2) = _se_forward(s_mean, p)
    sig2 = torch.sigmoid(z2)
    dz2 = dg * sig2 * (1.0 - sig2)
    dz1 = _mm(dz2, p.se_w2.t()) * _dsilu(z1)
    ds_hw = _mm(dz1, p.se_w1.t()) / hw

    bn2 = (p.wp, mean2, inv2, k2, alpha, beta_r)
    tot = k.b2(g, k9, mean1, inv1, a1, p.beta1, gate, *bn2, ds_hw, delta)
    r1 = tot[:2 * C]
    dwp = tot[2 * C:2 * C + C * C2].view(C, C2)
    taps = tot[2 * C + C * C2:].view(C, 9, 3)  # [channel, tap, (x, x*dbar, x*ddhat)]
    r1a, r1b = a1 * r1[:C] / nhw, a1 * r1[C:] / nhw
    dk = a1[:, None] * taps[:, :, 2] - r1a[:, None] * taps[:, :, 0] - r1b[:, None] * taps[:, :, 1]
    dx = k.b3(g, k9, mean1, inv1, a1, p.beta1, gate, *bn2, ds_hw, r1a, r1b, delta)
    grads = MBConvParams(
        dw_kernel=dk.view(C, 3, 3), gamma1=r1[C:], beta1=r1[:C],
        se_w1=(s_mean[:, :, None] * dz1[:, None, :]).sum(0), se_b1=dz1.sum(0),
        se_w2=(act1[:, :, None] * dz2[:, None, :]).sum(0), se_b2=dz2.sum(0),
        wp=dwp, gamma2=r2[C2:], beta2=r2[:C2])
    return dx, grads


class _FusedMBConvE1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delta, eps, *flat):
        p = MBConvParams(*flat)
        with torch.cuda.device(x.device):
            passes = E1Passes(_lib(), x, p.wp.shape[1])
            out, stats, (s_mean, gate) = _e1_forward(passes, x, p, delta, eps)
        launches.add("mbconv1.forward")
        ctx.eps = eps
        ctx.save_for_backward(x, delta, *flat, *stats, s_mean, gate)
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, g, *_stat_grads):  # stat cotangents are ignored (:579)
        x, delta, *rest = ctx.saved_tensors
        p = MBConvParams(*rest[:10])
        stats, (s_mean, gate) = tuple(rest[10:14]), rest[14:]
        g = g.to(x.dtype).contiguous()
        with torch.cuda.device(x.device):
            passes = E1Passes(_lib(), x, p.wp.shape[1])
            dx, dp = _e1_backward(passes, x, p, delta, stats, s_mean, gate, g, ctx.eps)
        launches.add("mbconv1.backward")
        return (dx, torch.zeros_like(delta), None, *dp)


def _lib():
    from .cuda_lib import load

    return load()


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
    cmax = _lib().mb1_max_channels()
    if not (C <= cmax and C2 <= cmax):
        raise ValueError(f"the e1 kernel takes at most {cmax} channels, got {C} -> {C2}")
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


def fused_mbconv_e1(x, params: MBConvParams, delta, eps: float = BN_EPS):
    """x: (N, C, H, W) float32 or bfloat16 with H % 8 == 0; params: MBConvParams
    (fp32; C_in -> C2 <= 64 channels on the card); delta: (N,) per-image
    drop-connect scale. Returns (out (N, C2, H, W) in x's dtype, (mean1, var1,
    mean2, var2)); the residual is added iff C2 == C. The stats carry no
    gradient and delta's gradient is zero."""
    _validate_e1(x, params, delta)
    if x.device.type == "cpu":
        return plain_fused_mbconv_e1(x, params, delta, eps)
    out, *stats = _FusedMBConvE1.apply(x, delta, eps, *params)
    return out, tuple(stats)
