"""Fused train-mode MBConv block (port of ``mammo_clip_tpu/ops/mbconv6_pallas.py``).

``fused_mbconv_e6(x, params, delta, valid_h, valid_w)`` computes one whole
MBConv block with exact batch-statistics BatchNorm:

  x --We--> z --bn0,silu--> w --dw3x3--> d --bn1,silu--> v --SE--> u --Wp--> y
    --bn2--> yhat ;  out = [x +] delta * yhat

over an NCHW input whose region outside ``valid_h`` x ``valid_w`` is zero, and
returns ``out`` with that pad region zero (so fused blocks chain) plus the
biased batch (mean, var) of each BatchNorm. ``MBConv6Params`` selects the
expanding form; ``MBConvParams`` (ops/mbconv.py) the e=1 form, which runs the
depthwise directly on x and returns 4 stats instead of 6.

On a CUDA tensor the forward and the backward are the hand-written kernels of
``csrc/mbconv6.cu``, sequenced here; a CPU tensor takes the plain PyTorch
version of the same function (``plain_fused_mbconv_e6``), and any other device
raises. ``launches`` (ops/mbconv.py) counts the kernel path's forward and backward
calls under ``mbconv6.<form>.<direction>``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .mbconv import (
    BN_EPS,
    MBConvParams,
    _bn,
    _lib,
    _se_gate,
    _tail,
    batch_stats,
    depthwise3x3,
    launches,
    mbconv_e1_reference,
)


class MBConv6Params(NamedTuple):
    """Raw parameters of an expanding MBConv block, all fp32.

    we: (C, E)            expand 1x1 kernel
    gamma0, beta0: (E,)   bn0 (post-expand) scale/bias
    dw_kernel: (E, 3, 3)  depthwise taps
    gamma1, beta1: (E,)   bn1 (post-depthwise) scale/bias
    se_w1: (E, S), se_b1: (S,), se_w2: (S, E), se_b2: (E,)   [S = C * se_ratio]
    wp: (E, C2)           project kernel
    gamma2, beta2: (C2,)  bn2 scale/bias
    """

    we: torch.Tensor
    gamma0: torch.Tensor
    beta0: torch.Tensor
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


PAD_MULTIPLE = 8


def pick_w_pad(w: int) -> int:
    """Padded width: a multiple of 8, so every bf16 row starts 16-byte aligned."""
    return -(-w // PAD_MULTIPLE) * PAD_MULTIPLE


def pick_h_pad(h: int) -> int:
    """Padded height: a multiple of the depthwise kernels' 8-row tile."""
    return -(-h // PAD_MULTIPLE) * PAD_MULTIPLE


# ----------------------------------------------------------------------------
# plain PyTorch version (CPU path, and the yardstick the kernels are held to)
# ----------------------------------------------------------------------------


def mbconv_e6_reference(x, p: MBConv6Params, delta, eps: float = BN_EPS):
    """Unfused NCHW reference of the expanding block (train-mode BN) on the
    exact, unpadded image."""
    xf = x.float()
    z = torch.einsum("nchw,ce->nehw", xf, p.we)
    mean0, var0 = batch_stats(z)
    w = F.silu(_bn(z, mean0, var0, p.gamma0, p.beta0, eps))
    out, stats = _tail(x, xf, depthwise3x3(w, p.dw_kernel), p, delta, eps)
    return out, (mean0, var0) + stats


def plain_fused_mbconv_e6(x, params, delta, valid_h: int, valid_w: int,
                          eps: float = BN_EPS):
    """The kernel's function in plain PyTorch: the reference on the valid
    region, zero-padded back to x's shape. Stats are returned detached (they
    only feed running averages; the kernel's backward ignores them too)."""
    H, W = x.shape[2:]
    ref = mbconv_e6_reference if isinstance(params, MBConv6Params) else mbconv_e1_reference
    out, stats = ref(x[:, :, :valid_h, :valid_w], params, delta, eps)
    out = F.pad(out, (0, W - valid_w, 0, H - valid_h))
    return out, tuple(s.detach() for s in stats)


# ----------------------------------------------------------------------------
# kernel path
# ----------------------------------------------------------------------------


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


class _Ctx:
    """Per-call shapes and the library handle shared by the kernel stages."""

    def __init__(self, lib, x, E, C2, valid_h, valid_w):
        self.lib = lib
        self.N, self.C, self.H, self.W = x.shape
        self.E, self.C2 = E, C2
        self.vh, self.vw = valid_h, valid_w
        self.P = self.H * self.W
        self.cnt = self.N * valid_h * valid_w
        self.bf16 = int(x.dtype == torch.bfloat16)
        self.dev = x.device
        self.stream = (torch.cuda.current_stream(x.device).cuda_stream
                       if x.is_cuda else None)

    def empty(self, *shape):
        return torch.empty(shape, device=self.dev, dtype=torch.float32)

    def dims(self, ch):
        return (self.N, ch, self.H, self.W, self.vh, self.vw)

    def sums(self, a, b=None, mb=None, ib=None):
        """Per-(image, channel) and per-channel [sum a, sum a*b'] over the
        valid region (see reduce_partial_kernel); returns ((N, Ch, 2), (Ch, 2))."""
        lib, ch = self.lib, a.shape[1]
        nchunk = -(-self.P // lib.mbc_red_chunk())
        part = self.empty(self.N, ch, nchunk, 2)
        _check(lib.mbc_reduce_partial(_ptr(a), _ptr(b), _ptr(mb), _ptr(ib), _ptr(part),
                                      *self.dims(ch), self.stream), "reduce_partial")
        return self._final(part, ch, nchunk, 2)

    def _final(self, part, ch, nchunk, k):
        out_n, out = self.empty(self.N, ch, k), self.empty(ch, k)
        _check(self.lib.mbc_reduce_final(_ptr(part), _ptr(out_n), _ptr(out), self.N, ch,
                                         nchunk, k, self.stream), "reduce_final")
        return out_n, out

    def mix(self, inp, w, scale=None):
        """out[n, co, p] = sum_ci w[ci, co] * inp[n, ci, p] * scale[n, ci]."""
        ci, co = w.shape
        out = self.empty(self.N, co, self.H, self.W)
        in_bf16 = int(inp.dtype == torch.bfloat16)
        _check(self.lib.mbc_mix(_ptr(inp), in_bf16, _ptr(w), _ptr(scale), _ptr(out), self.N,
                                ci, co, self.P, self.stream), "mix")
        return out

    def pgemm(self, a, b):
        """(N, M, K): sum over positions of a[n, m, p] * b[n, k, p]."""
        lib, M, K = self.lib, a.shape[1], b.shape[1]
        nchunk = -(-self.P // lib.mbc_pg_chunk())
        part = self.empty(self.N, M * K, nchunk, 1)
        _check(lib.mbc_pgemm(_ptr(a), int(a.dtype == torch.bfloat16), _ptr(b), _ptr(part),
                             self.N, M, K, self.P, self.stream), "pgemm")
        out_n, _ = self._final(part, M * K, nchunk, 1)
        return out_n.view(self.N, M, K)

    def taps(self, dd, src, bn0):
        """(E, 9): sum over images and valid positions of dd * shifted w."""
        lib, E = self.lib, self.E
        nchunk = -(-self.H // lib.mbc_dw_rows())
        part = self.empty(self.N, E, nchunk, 9)
        m0, a0, b0 = bn0
        _check(lib.mbc_dw_bwd_k(_ptr(dd), _ptr(src), int(src.dtype == torch.bfloat16),
                                _ptr(m0), _ptr(a0), _ptr(b0), _ptr(part), self.N, E,
                                self.H, self.W, self.vh, self.vw, self.stream), "dw_bwd_k")
        _, out = self._final(part, E, nchunk, 9)
        return out


def _bn_coeffs(s, cnt, gamma, beta, eps):
    """(mean, var, inv, gamma*inv) from the per-channel [sum, sum of squares]."""
    mean = s[:, 0] / cnt
    var = torch.clamp(s[:, 1] / cnt - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    return mean, var, inv, gamma * inv


_NO_BN0 = (None, None, None)


def _forward_kernels(lib, x, p, delta, valid_h, valid_w, eps):
    """Forward on the kernel library. Returns (out, stats, saved)."""
    expand = isinstance(p, MBConv6Params)
    E = p.we.shape[1] if expand else x.shape[1]
    C2 = p.wp.shape[1]
    c = _Ctx(lib, x, E, C2, valid_h, valid_w)
    k9 = p.dw_kernel.reshape(E, 9).contiguous()
    stats = ()
    if expand:
        z = c.mix(x, p.we.contiguous())
        _, s0 = c.sums(z)
        mean0, var0, inv0, a0 = _bn_coeffs(s0, c.cnt, p.gamma0, p.beta0, eps)
        bn0 = (mean0, a0, p.beta0.contiguous())
        src, stats = z, (mean0, var0)
    else:
        z, inv0, bn0, src = None, None, _NO_BN0, x
    d = c.empty(c.N, E, c.H, c.W)
    _check(lib.mbc_dw_fwd(_ptr(src), int(src.dtype == torch.bfloat16), _ptr(k9),
                          *map(_ptr, bn0), _ptr(d), c.N, E, c.H, c.W, valid_h, valid_w,
                          c.stream), "dw_fwd")
    _, s1 = c.sums(d)
    mean1, var1, inv1, a1 = _bn_coeffs(s1, c.cnt, p.gamma1, p.beta1, eps)
    be1 = p.beta1.contiguous()
    v = c.empty(c.N, E, c.H, c.W)
    _check(lib.mbc_bn_act(_ptr(d), _ptr(mean1), _ptr(a1), _ptr(be1), _ptr(v),
                          *c.dims(E), c.stream), "bn_act")
    sv_n, _ = c.sums(v)
    s_mean = sv_n[:, :, 0] / (valid_h * valid_w)
    gate, _ = _se_gate(s_mean, p)
    gate = gate.contiguous()
    y = c.mix(v, p.wp.contiguous(), gate)
    _, s2 = c.sums(y)
    mean2, var2, inv2, a2 = _bn_coeffs(s2, c.cnt, p.gamma2, p.beta2, eps)
    out = torch.empty((c.N, C2, c.H, c.W), device=x.device, dtype=x.dtype)
    residual = int(C2 == c.C)
    _check(lib.mbc_out_fwd(_ptr(x), c.bf16, _ptr(y), _ptr(mean2), _ptr(a2),
                           _ptr(p.beta2.contiguous()),
                           _ptr(delta), residual, _ptr(out), *c.dims(C2), c.stream),
           "out_fwd")
    stats = stats + (mean1, var1, mean2, var2)
    saved = dict(z=z, d=d, v=v, y=y, gate=gate, s_mean=s_mean, inv0=inv0, mean1=mean1,
                 inv1=inv1, a1=a1, be1=be1, mean2=mean2, inv2=inv2, bn0=bn0)
    return out, stats, saved


# What the forward keeps for the backward, besides the bn0 triple (which is
# (None, None, None) in the e=1 form).
_SAVED = ("z", "d", "v", "y", "gate", "s_mean", "inv0", "mean1", "inv1", "a1", "be1",
          "mean2", "inv2")


def _backward_kernels(lib, x, p, delta, valid_h, valid_w, g, sv):
    """Backward on the kernel library: (dx, parameter gradients as p's type)."""
    expand = isinstance(p, MBConv6Params)
    E = p.we.shape[1] if expand else x.shape[1]
    C2 = p.wp.shape[1]
    c = _Ctx(lib, x, E, C2, valid_h, valid_w)
    hw = valid_h * valid_w
    g = g.contiguous()
    gate, d, v, y = sv["gate"], sv["d"], sv["v"], sv["y"]

    # bn2 backward: dyhat = g * delta, then dy (C2 channels)
    dy = c.empty(c.N, C2, c.H, c.W)
    _check(lib.mbc_scale_rows(_ptr(g), int(g.dtype == torch.bfloat16), _ptr(delta), _ptr(dy),
                              *c.dims(C2), c.stream), "scale_rows")
    _, r2 = c.sums(dy, y, sv["mean2"], sv["inv2"])
    k1 = p.gamma2 * sv["inv2"]
    alpha2, beta2r = k1 * r2[:, 0] / c.cnt, k1 * r2[:, 1] / c.cnt
    _check(lib.mbc_bn_bwd(_ptr(dy), _ptr(y), _ptr(sv["mean2"]), _ptr(sv["inv2"]), _ptr(k1),
                          _ptr(alpha2), _ptr(beta2r), _ptr(dy), *c.dims(C2), c.stream),
           "bn_bwd")

    # T[n, e, c2] = sum_p v dy: gives dWp (through the gate) and the SE cotangent
    t = c.pgemm(v, dy)
    dwp = torch.einsum("ne,nec->ec", gate, t)
    dgate = torch.einsum("ec,nec->ne", p.wp, t)
    with torch.enable_grad():
        se_in = [sv["s_mean"], p.se_w1, p.se_b1, p.se_w2, p.se_b2]
        se_in = [a.detach().requires_grad_(True) for a in se_in]
        se_p = MBConvParams(*([None] * 3), *se_in[1:], None, None, None)
        gate_re, _ = _se_gate(se_in[0], se_p)
        ds, dse_w1, dse_b1, dse_w2, dse_b2 = torch.autograd.grad(gate_re, se_in, dgate)

    # du = Wp dy, then the SE/silu/bn1 backward to dd (E channels, in place)
    du = c.mix(dy, p.wp.t().contiguous())
    ds_hw = (ds / hw).contiguous()
    _check(lib.mbc_dv_bwd(_ptr(du), _ptr(d), _ptr(sv["mean1"]), _ptr(sv["a1"]), _ptr(sv["be1"]),
                          _ptr(gate), _ptr(ds_hw), _ptr(du), *c.dims(E), c.stream), "dv_bwd")
    _, r1 = c.sums(du, d, sv["mean1"], sv["inv1"])
    k1 = p.gamma1 * sv["inv1"]
    r1a, r1b = k1 * r1[:, 0] / c.cnt, k1 * r1[:, 1] / c.cnt
    _check(lib.mbc_bn_bwd(_ptr(du), _ptr(d), _ptr(sv["mean1"]), _ptr(sv["inv1"]), _ptr(k1),
                          _ptr(r1a), _ptr(r1b), _ptr(du), *c.dims(E), c.stream), "bn_bwd")
    dd = du
    src = sv["z"] if expand else x
    ddw = c.taps(dd, src, sv["bn0"]).view(E, 3, 3)

    # transposed stencil: dL/dw (e=1: dL/dx's chain term), times silu'(bn0) when expanding
    k9 = p.dw_kernel.reshape(E, 9).contiguous()
    dw = c.empty(c.N, E, c.H, c.W)
    zz = sv["z"] if expand else None
    _check(lib.mbc_dw_bwd_x(_ptr(dd), _ptr(k9), _ptr(zz), *map(_ptr, sv["bn0"]), _ptr(dw),
                            c.N, E, c.H, c.W, valid_h, valid_w, c.stream), "dw_bwd_x")
    grads = dict(dw_kernel=ddw, gamma1=r1[:, 1], beta1=r1[:, 0], se_w1=dse_w1,
                 se_b1=dse_b1, se_w2=dse_w2, se_b2=dse_b2, wp=dwp, gamma2=r2[:, 1],
                 beta2=r2[:, 0])
    if expand:
        z, (mean0, _, _), inv0 = sv["z"], sv["bn0"], sv["inv0"]
        _, r0 = c.sums(dw, z, mean0, inv0)
        k1 = p.gamma0 * inv0
        alpha0, beta0r = k1 * r0[:, 0] / c.cnt, k1 * r0[:, 1] / c.cnt
        _check(lib.mbc_bn_bwd(_ptr(dw), _ptr(z), _ptr(mean0), _ptr(inv0), _ptr(k1),
                              _ptr(alpha0), _ptr(beta0r), _ptr(dw), *c.dims(E), c.stream),
               "bn_bwd")
        dwe = c.pgemm(x, dw).sum(dim=0)
        dxf = c.mix(dw, p.we.t().contiguous())
        grads.update(we=dwe, gamma0=r0[:, 1], beta0=r0[:, 0])
        dparams = MBConv6Params(**grads)
    else:
        dxf = dw
        dparams = MBConvParams(**grads)
    dx = torch.empty_like(x)
    res = g if C2 == c.C else None
    _check(lib.mbc_finish(_ptr(dxf), _ptr(res), c.bf16, _ptr(dx), *c.dims(c.C), c.stream),
           "finish")
    return dx, dparams


class _FusedMBConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delta, valid_h, valid_w, eps, form, *flat):
        p = form(*flat)
        with torch.cuda.device(x.device):
            out, stats, saved = _forward_kernels(_lib(), x, p, delta, valid_h, valid_w, eps)
        launches.add(f"mbconv6.{_form_name(form)}.forward")
        # The fp32 intermediates go through save_for_backward too, so saved-tensor
        # hooks (checkpointing, offload) see them.
        ctx.meta = (valid_h, valid_w, form, len(flat))
        ctx.save_for_backward(x, delta, *flat, *saved["bn0"], *(saved[k] for k in _SAVED))
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, g, *_stat_grads):
        valid_h, valid_w, form, nflat = ctx.meta
        x, delta, *rest = ctx.saved_tensors
        p = form(*rest[:nflat])
        saved = dict(zip(_SAVED, rest[nflat + 3:]), bn0=tuple(rest[nflat:nflat + 3]))
        with torch.cuda.device(x.device):
            dx, dp = _backward_kernels(_lib(), x, p, delta, valid_h, valid_w, g, saved)
        launches.add(f"mbconv6.{_form_name(form)}.backward")
        return (dx, None, None, None, None, None, *dp)


def _form_name(form) -> str:
    return "e6" if form is MBConv6Params else "e1"


def _validate(x, p, delta, valid_h, valid_w):
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NCHW)")
    N, C, H, W = x.shape
    if not (0 < valid_h <= H and 0 < valid_w <= W):
        raise ValueError(f"valid region {valid_h}x{valid_w} outside {H}x{W}")
    E = p.we.shape[1] if isinstance(p, MBConv6Params) else C
    expect = {"dw_kernel": (E, 3, 3), "wp": (E, p.wp.shape[1])}
    if isinstance(p, MBConv6Params):
        expect["we"] = (C, E)
    for name, shape in expect.items():
        if tuple(getattr(p, name).shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(getattr(p, name).shape)}")
    for name, t in zip(p._fields, p):
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"param {name} must be float32 on {x.device}")
    if (delta.shape != (N,) or delta.dtype != torch.float32 or delta.device != x.device
            or not delta.is_contiguous()):
        raise ValueError("delta must be a contiguous float32 (N,) tensor on x's device")
    if W > _lib().mbc_dw_max_width():
        raise ValueError(f"width {W} exceeds the depthwise kernels' limit")


def fused_mbconv_e6(x, params, delta, valid_h: int, valid_w: int,
                    eps: float = BN_EPS) -> Tuple[torch.Tensor, tuple]:
    """x: (N, C, H, W) float32 or bfloat16, zero outside the valid region.

    params: MBConv6Params (expanding form) or MBConvParams (e=1 form), fp32.
    delta: (N,) per-image drop-connect scale (0 drops the residual branch).

    Returns (out (N, C2, H, W) in x's dtype with a zero pad region, stats): stats
    is (mean0, var0, mean1, var1, mean2, var2) for the expanding form and
    (mean1, var1, mean2, var2) for e=1; they carry no gradient."""
    if x.device.type == "cpu":
        return plain_fused_mbconv_e6(x, params, delta, valid_h, valid_w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv_e6 runs on CUDA or CPU tensors, got {x.device}")
    _validate(x, params, delta, valid_h, valid_w)
    out, *stats = _FusedMBConv.apply(x, delta, valid_h, valid_w, eps, type(params),
                                     *params)
    return out, tuple(stats)
