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

On a CUDA tensor both forms run the kernels of ``csrc/mbconv6_e6.cu``:
passes that read x (and the cotangent) and recompute the block on chip with
its channel products on the tensor cores; the forward keeps only x, the
statistics and the (N, E) SE vectors for the backward. Within one call the
expanding form writes d once and reads it back in the passes after it; the
e=1 form recomputes d, a stencil on x, in every pass. Both write y (C2
channels, fp32) within a call for the pass after the one that forms it. The
passes are sequenced here (``_e6_forward``, ``_e6_backward``, ``_e1_forward``,
``_e1_backward``), one ``cuda_lib.launcher`` call each; the analytic
per-channel combinations between them run in the kernels, with their plain
versions here (``bn0_stats``, ``bn1_backward_sums``, ``dwe_from_moments``,
``dx_terms``, ``se_cotangent``, ``dx_from_dd``, ``dk_taps``), and the SE MLP
and its backward are torch ops on (N, E) vectors. A CPU tensor takes the plain
PyTorch version of the same function (``plain_fused_mbconv_e6``), and any other
device raises. ``launches`` (ops/mbconv.py) counts the kernel path's forward
and backward calls under ``mbconv6.<form>.<direction>``.

Data parallelism: given a ``rank_sum`` hook (``core/mesh.py::RankSum``), the
batch sums that a later pass consumes are summed over the ranks between the
passes (x's moments before bn0, bn1's and bn2's sums after F2 and F4, bn2's
backward sums after B1, bn1's before bwd_x, bn0's before bn0_bwd) and the
kernels divide by every rank's count; the per-image sums and the parameter
gradients stay the rank's own. The plain version takes the same hook. Without
one, the passes are the one-process function, bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .cuda_lib import launcher
from .mbconv import (
    BN_EPS,
    E1_MAX_C,
    MBConvParams,
    _se_gate,
    _tail,
    bn_train,
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


def mbconv_e6_reference(x, p: MBConv6Params, delta, eps: float = BN_EPS, rank_sum=None):
    """Unfused NCHW reference of the expanding block (train-mode BN, over every
    rank's batch with ``rank_sum``) on the exact, unpadded image."""
    xf = x.float()
    z = torch.einsum("nchw,ce->nehw", xf, p.we)
    b0, mean0, var0 = bn_train(z, p.gamma0, p.beta0, eps, rank_sum)
    w = F.silu(b0)
    out, stats = _tail(x, xf, depthwise3x3(w, p.dw_kernel), p, delta, eps, rank_sum)
    return out, (mean0, var0) + stats


def plain_fused_mbconv_e6(x, params, delta, valid_h: int, valid_w: int,
                          eps: float = BN_EPS, rank_sum=None):
    """The kernel's function in plain PyTorch: the reference on the valid
    region, zero-padded back to x's shape. Stats are returned detached (they
    only feed running averages; the kernel's backward ignores them too).
    ``rank_sum`` sums the batch sums over data-parallel ranks (forward and
    backward), as the kernel path does."""
    H, W = x.shape[2:]
    ref = mbconv_e6_reference if isinstance(params, MBConv6Params) else mbconv_e1_reference
    out, stats = ref(x[:, :, :valid_h, :valid_w], params, delta, eps, rank_sum)
    out = F.pad(out, (0, W - valid_w, 0, H - valid_h))
    return out, tuple(s.detach() for s in stats)


# ----------------------------------------------------------------------------
# expanding form: the recompute passes of csrc/mbconv6_e6.cu
# ----------------------------------------------------------------------------


def _up(a: int, m: int) -> int:
    return -(-a // m) * m


def bn0_stats(sx, sxx, we, cnt):
    """bn0's biased batch (mean, var) from x's moments: z = x We is linear in x,
    so E[z] = sx We / cnt and E[z^2] = diag(We^T sxx We) / cnt, with sx the sum
    of x over the valid positions (C,) and sxx the sum of x x^T (C, C). Computed
    in float64 (var = max(E[z^2] - E[z]^2, 0), the plain version's formula).
    The plain version of csrc/mbconv6_e6.cu's bn0_kernel, which the bn0 pass
    runs on the card after the moments pass."""
    we64 = we.double()
    mean = sx.double() @ we64 / cnt
    ez2 = ((sxx.double() @ we64) * we64).sum(0) / cnt
    return mean.to(we.dtype), (ez2 - mean * mean).clamp(min=0.0).to(we.dtype)


def bn1_backward_sums(q, gate, ds_hw):
    """(sum db1h, sum db1h * dbar) per channel, where db1h = (du gate + ds_hw) s'
    is the cotangent of bn1's output (s' = silu'(bn1(d)), dbar = (d - mean1)
    inv1), from the backward sweep's per-image sums
    q (N, 5, E) = [sum v du, sum du s', sum s', sum du s' dbar, sum s' dbar]:
    db1h is affine in the per-image gate and ds_hw, which the SE backward gives
    only after that sweep. The plain version of what bwd_x_kernel's prologue
    (csrc/mbconv6_e6.cu, fill_coef) forms on the card."""
    return ((gate * q[:, 1] + ds_hw * q[:, 2]).sum(0),
            (gate * q[:, 3] + ds_hw * q[:, 4]).sum(0))


def dwe_from_moments(t3, sx, sxx, we, mean0, inv0, alpha0, beta0r):
    """dWe = sum_p x (x) dz with dz = t - alpha0 - zbar0 beta0r the bn0 backward
    (t = gamma0 inv0 dz0hat, zbar0 = (x We - mean0) inv0), from
    t3 = sum_p x (x) t (C, E) and x's moments: sum_p x (x) zbar0 =
    (sxx We - sx (x) mean0) inv0. Computed in float64; the plain version of
    csrc/mbconv6_e6.cu's bn0_bwd_kernel."""
    d = lambda a: a.double()
    sxz = d(sxx) @ d(we) - d(sx)[:, None] * d(mean0)[None, :]
    dwe = d(t3) - d(sx)[:, None] * d(alpha0)[None, :] - sxz * d(inv0 * beta0r)[None, :]
    return dwe.to(we.dtype)


def dx_terms(we, mean0, inv0, alpha0, beta0r):
    """(M, k) with dz We^T = dxa - x M + k, where dxa = (gamma0 inv0 dz0hat) We^T:
    the bn0 backward's other terms are affine in x, M = We diag(inv0 beta0r) We^T
    (C, C) and k = We (mean0 inv0 beta0r - alpha0) (C,). Computed in float64; the
    plain version of csrc/mbconv6_e6.cu's bn0_bwd_kernel."""
    we64, ib = we.double(), (inv0 * beta0r).double()
    m = (we64 * ib[None, :]) @ we64.t()
    k = we64 @ (mean0.double() * ib - alpha0.double())
    return m.to(we.dtype).contiguous(), k.to(we.dtype)


def se_cotangent(v, du):
    """The SE gate's cotangent (N, E): the per-image sum over positions of v du,
    with v = silu(bn1(d)) and du the cotangent of u = v gate. The plain version
    of bwd_v_kernel's first per-image sum (csrc/mbconv6_e6.cu)."""
    return (v * du).sum(dim=(2, 3))


def dx_from_dd(dd, dw_kernel, g=None):
    """The e=1 form's dx from dd, the cotangent of d = dw3x3(x): the stencil's
    transpose, a correlation with the taps turned by 180 degrees (SAME
    padding), plus dout ``g`` where the block has its residual. The plain
    version of what csrc/mbconv6_e6.cu's bwd_x1 writes."""
    dx = F.conv2d(dd, dw_kernel.flip(1, 2)[:, None], padding=1, groups=dd.shape[1])
    return dx if g is None else dx + g


def dk_taps(dd, x):
    """dL/dw_kernel (E, 3, 3) of d = dw3x3(x) from dd: tap (a, b) is the sum over
    images and positions of dd times x shifted by (a - 1, b - 1), zero outside
    the image. The plain version of bwd_x's 9 tap sums (csrc/mbconv6_e6.cu)."""
    H, W = x.shape[2:]
    xp = F.pad(x, (1, 1, 1, 1))
    return torch.stack([(dd * xp[:, :, a:a + H, b:b + W]).sum(dim=(0, 2, 3))
                        for a in range(3) for b in range(3)], 1).view(-1, 3, 3)


# pass ids of m6_pass (csrc/mbconv6_e6.cu), and the pointers it takes in order
MOMENTS, F2, F3, F4, B1, OUT, BWD_V, BWD_X, DX, BN0, BN0_BWD = range(11)
_PTRS = ("x", "g", "out", "we", "wp", "k9", "m0", "v0", "g0", "b0", "s1", "g1", "b1",
         "s2", "g2", "b2", "s3", "gate", "ds", "q", "sb1", "delta", "mom", "xm", "kv", "wf", "y",
         "d", "dxa", "dwe", "part", "red", "red_n", "stats")
_INDEX = {k: i for i, k in enumerate(_PTRS)}
E6_MAX_C, E6_MAX_E = 48, 256  # the expanding form's limits on C and C2, and on E
_FRAG_FLOATS = 24 * 32 * 4  # the weights' B fragments per chunk of 16 channels (prep_kernel)
_m6_pass = launcher("m6_pass")


@functools.lru_cache(maxsize=64)
def _scratch_floats(ints) -> int:
    from . import cuda_lib

    return cuda_lib.load().m6_scratch(*ints)


class _E6:
    """One call of either form: its shapes, the tensors its passes use (kept
    alive here) and their pointers in ``_PTRS`` order, and ``run(pass,
    **tensors)``, which sets tensors and launches one pass."""

    def __init__(self, x, p, delta, valid_h, valid_w, eps, rank_sum=None):
        expand = isinstance(p, MBConv6Params)
        self.rank_sum = rank_sum
        self.ranks = 1 if rank_sum is None else int(rank_sum.ranks)
        self.N, self.C, self.H, self.W = x.shape
        self.E, self.C2 = p.wp.shape
        self.Cp, self.Ep, self.C2p = _up(self.C, 16), _up(self.E, 16), _up(self.C2, 8)
        self.hw = valid_h * valid_w
        self.cnt = self.N * self.hw
        self.eps = eps
        self.dev = x.get_device()
        self.ints = (int(expand), int(x.dtype == torch.bfloat16), self.N, self.C, self.E,
                     self.C2, self.H, self.W, valid_h, valid_w)
        self.new = functools.partial(torch.empty, device=x.device, dtype=torch.float32)
        self.t, self.args = {}, [None] * len(_PTRS)
        c = lambda a: a.contiguous()
        self.set(x=x, delta=delta, wp=c(p.wp), k9=c(p.dw_kernel), g1=c(p.gamma1),
                 b1=c(p.beta1), g2=c(p.gamma2), b2=c(p.beta2),
                 part=self.new(_scratch_floats(self.ints)),
                 wf=self.new(self.Ep // 16 * _FRAG_FLOATS))
        if expand:
            self.set(we=c(p.we), g0=c(p.gamma0), b0=c(p.beta0))

    def set(self, **tensors):
        for k, v in tensors.items():
            self.t[k] = v
            self.args[_INDEX[k]] = v.data_ptr() if v is not None else None

    def run(self, pass_id, **tensors):
        self.set(**tensors)
        _m6_pass(self.dev, pass_id, *self.args, self.eps, *self.ints, self.ranks)

    def summed(self, t, copy: bool = False):
        """``t`` summed over the data-parallel ranks (in place, or into a copy
        where this rank's sums are kept too); ``t`` itself without them."""
        if self.rank_sum is None:
            return t
        return self.rank_sum(t.clone() if copy else t)


def _e6_forward(x, p, delta, valid_h, valid_w, eps, rank_sum=None):
    """Forward of the expanding form: (out, the 6 stats, what the backward keeps:
    bn1's and bn2's sums, s_mean, gate and this rank's moments of x [sum x |
    sum x x^T]). With ``rank_sum`` the batch sums are summed over the ranks
    between the passes: the moments (into a copy) before bn0, bn1's after F2,
    bn2's after F4."""
    k = _E6(x, p, delta, valid_h, valid_w, eps, rank_sum)
    C, E, C2, Cp = k.C, k.E, k.C2, k.Cp
    mom, stats0 = k.new(Cp + Cp * Cp), k.new(2 * E)
    k.run(MOMENTS, red=mom)
    k.run(BN0, red=k.summed(mom, copy=True), stats=stats0)  # bn0's statistics (bn0_kernel)
    mean0, var0 = stats0[:E], stats0[E:]
    s1 = k.new(2 * k.Ep)
    k.run(F2, m0=mean0, v0=var0, red=s1, d=k.new(k.N, k.Ep, k.H, k.W))
    k.summed(s1)
    s_mean = k.new(k.N, k.Ep)
    k.run(F3, s1=s1, red=None, red_n=s_mean)  # the per-image sums of v over vh * vw
    s_mean = s_mean[:, :E]
    gate = _se_gate(s_mean, p)[0].contiguous()
    y, s2 = k.new(k.N, C2, k.H, k.W), k.new(2 * k.C2p)
    k.run(F4, gate=gate, y=y, red=s2, red_n=None)
    k.summed(s2)
    out = torch.empty((k.N, C2, k.H, k.W), device=x.device, dtype=x.dtype)
    stats = k.new(2 * E + 2 * C2)
    k.run(OUT, s2=s2, out=out, stats=stats)
    return out, (mean0, var0, *stats.split([E, E, C2, C2])), (s1, s2, s_mean, gate, mom)


def _se_backward(s_mean, p, dgate):
    """(dL/ds_mean, dse_w1, dse_b1, dse_w2, dse_b2) of the SE MLP, by autograd."""
    with torch.enable_grad():
        se_in = [a.detach().requires_grad_(True)
                 for a in (s_mean, p.se_w1, p.se_b1, p.se_w2, p.se_b2)]
        se_p = MBConvParams(*([None] * 3), *se_in[1:], None, None, None)
        gate_re, _ = _se_gate(se_in[0], se_p)
        return torch.autograd.grad(gate_re, se_in, dgate)


def _bn1_sums(k, q, gate, ds_hw):
    """bn1's backward sums over every rank (``bn1_backward_sums``, 2 x E) for
    bwd_x's coefficients, or None (bwd_x forms this rank's from q)."""
    if k.rank_sum is None:
        return None
    qe = q.view(k.N, 5, k.Ep)[:, :, :k.E]
    return k.summed(torch.cat(bn1_backward_sums(qe, gate, ds_hw)).contiguous())


def _e6_backward(x, p, delta, valid_h, valid_w, eps, g, stats, kept, rank_sum=None):
    """Backward of the expanding form: (dx, parameter gradients as MBConv6Params).
    bn1's backward sums (``bn1_backward_sums``) are formed in bwd_x's prologue
    and bn0's backward (``dwe_from_moments``, ``dx_terms``) by bn0_bwd_kernel.
    With ``rank_sum`` the batch sums the later passes read are summed over the
    ranks (bn2's after B1, bn1's before bwd_x, bn0's before bn0_bwd); the
    parameter gradients stay this rank's."""
    s1, s2, s_mean, gate, mom = kept
    mean0, var0 = stats[:2]
    k = _E6(x, p, delta, valid_h, valid_w, eps, rank_sum)
    C, E, C2, Cp, Ep, C2p, N = k.C, k.E, k.C2, k.Cp, k.Ep, k.C2p, k.N
    k.set(g=g, m0=mean0, v0=var0, s1=s1, s2=s2, gate=gate, mom=mom, d=k.new(N, Ep, k.H, k.W))
    y, s3 = k.new(N, C2, k.H, k.W), k.new(2 * C2p)
    k.run(B1, y=y, red=s3)
    q, dwp = k.new(N, 5 * Ep), k.new(Ep * C2p)
    k.run(BWD_V, s3=k.summed(s3, copy=True), red_n=q, red=dwp)
    ds, dse_w1, dse_b1, dse_w2, dse_b2 = _se_backward(s_mean, p, q.view(N, 5, Ep)[:, 0, :E])
    ds_hw = (ds / k.hw).contiguous()
    red, sdb = k.new(11 * Ep + Cp * Ep), k.new(2 * E)
    dwe, xm, kv = k.new(C, E), k.new(C, C), k.new(C)
    k.run(BWD_X, ds=ds_hw, q=q, sb1=_bn1_sums(k, q, gate, ds_hw), dxa=k.new(N, C, k.H, k.W),
          red=red, red_n=None, stats=sdb, dwe=dwe, xm=xm, kv=kv)
    if rank_sum is not None:  # every rank's [sum dz0hat | sum dz0hat zbar0], this one's T3
        k.run(BN0_BWD, red=torch.cat([k.summed(red[:2 * Ep].clone()), red[2 * Ep:]]))
    else:
        k.run(BN0_BWD)
    dx = torch.empty_like(x)
    k.run(DX, g=g if C2 == C else None, out=dx)
    grads = MBConv6Params(
        we=dwe, gamma0=red[Ep:Ep + E], beta0=red[:E],
        dw_kernel=red[2 * Ep:11 * Ep].view(9, Ep)[:, :E].t().reshape(E, 3, 3),
        gamma1=sdb[E:], beta1=sdb[:E], se_w1=dse_w1, se_b1=dse_b1, se_w2=dse_w2,
        se_b2=dse_b2, wp=dwp.view(Ep, C2p)[:E, :C2], gamma2=s3[C2p:C2p + C2], beta2=s3[:C2])
    return dx, grads


# ----------------------------------------------------------------------------
# e=1 form: the same passes of csrc/mbconv6_e6.cu, d recomputed from x in each
# ----------------------------------------------------------------------------


def _e1_forward(x, p, delta, valid_h, valid_w, eps, rank_sum=None):
    """Forward of the e=1 form: (out, the 4 stats, what the backward keeps:
    bn1's and bn2's sums, s_mean and gate); with ``rank_sum`` bn1's and bn2's
    sums are summed over the ranks after F2 and F4."""
    k = _E6(x, p, delta, valid_h, valid_w, eps, rank_sum)
    E, C2 = k.E, k.C2
    s1 = k.new(2 * k.Ep)
    k.run(F2, red=s1)  # and Wp's fragments for F4
    k.summed(s1)
    s_mean = k.new(k.N, k.Ep)
    k.run(F3, s1=s1, red=None, red_n=s_mean)  # the per-image sums of v over vh * vw
    s_mean = s_mean[:, :E]
    gate = _se_gate(s_mean, p)[0].contiguous()
    y, s2 = k.new(k.N, C2, k.H, k.W), k.new(2 * k.C2p)
    k.run(F4, gate=gate, y=y, red=s2, red_n=None)
    k.summed(s2)
    out = torch.empty((k.N, C2, k.H, k.W), device=x.device, dtype=x.dtype)
    stats = k.new(2 * E + 2 * C2)
    k.run(OUT, s2=s2, out=out, stats=stats)
    return out, tuple(stats.split([E, E, C2, C2])), (s1, s2, s_mean, gate)


def _e1_backward(x, p, delta, valid_h, valid_w, eps, g, stats, kept, rank_sum=None):
    """Backward of the e=1 form: (dx, parameter gradients as MBConvParams). bn1's
    backward sums (``bn1_backward_sums``) are formed in bwd_x's prologue, which
    then writes dx = [g +] ``dx_from_dd`` and the taps (``dk_taps``). With
    ``rank_sum`` bn2's backward sums (after B1) and bn1's (before bwd_x) are
    summed over the ranks; the parameter gradients stay this rank's."""
    s1, s2, s_mean, gate = kept
    k = _E6(x, p, delta, valid_h, valid_w, eps, rank_sum)
    E, C2, Ep, C2p, N = k.E, k.C2, k.Ep, k.C2p, k.N
    k.set(g=g, s1=s1, s2=s2, gate=gate)
    y, s3 = k.new(N, C2, k.H, k.W), k.new(2 * C2p)
    k.run(B1, y=y, red=s3)
    q, dwp = k.new(N, 5 * Ep), k.new(Ep * C2p)
    k.run(BWD_V, s3=k.summed(s3, copy=True), red_n=q, red=dwp)
    ds, dse_w1, dse_b1, dse_w2, dse_b2 = _se_backward(s_mean, p, q.view(N, 5, Ep)[:, 0, :E])
    ds_hw = (ds / k.hw).contiguous()
    taps, sdb = k.new(9 * Ep), k.new(2 * E)
    dx = torch.empty_like(x)
    k.run(BWD_X, ds=ds_hw, q=q, sb1=_bn1_sums(k, q, gate, ds_hw), red=taps, red_n=None,
          stats=sdb, out=dx)
    grads = MBConvParams(
        dw_kernel=taps.view(9, Ep)[:, :E].t().reshape(E, 3, 3), gamma1=sdb[E:], beta1=sdb[:E],
        se_w1=dse_w1, se_b1=dse_b1, se_w2=dse_w2, se_b2=dse_b2,
        wp=dwp.view(Ep, C2p)[:E, :C2], gamma2=s3[C2p:C2p + C2], beta2=s3[:C2])
    return dx, grads


class _FusedMBConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delta, valid_h, valid_w, eps, form, rank_sum, *flat):
        p = form(*flat)
        expand = form is MBConv6Params
        out, stats, kept = (_e6_forward if expand else _e1_forward)(
            x, p, delta, valid_h, valid_w, eps, rank_sum)
        ctx.meta = (valid_h, valid_w, eps, form, len(flat), len(stats), rank_sum)
        ctx.save_for_backward(x, delta, *flat, *stats, *kept)
        launches.add(f"mbconv6.{_form_name(form)}.forward")
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, g, *_stat_grads):
        valid_h, valid_w, eps, form, nflat, nstats, rank_sum = ctx.meta
        x, delta, *rest = ctx.saved_tensors
        p = form(*rest[:nflat])
        stats, kept = rest[nflat:nflat + nstats], rest[nflat + nstats:]
        bwd = _e6_backward if form is MBConv6Params else _e1_backward
        dx, dp = bwd(x, p, delta, valid_h, valid_w, eps, g.contiguous(), stats, kept, rank_sum)
        launches.add(f"mbconv6.{_form_name(form)}.backward")
        return (dx, None, None, None, None, None, None, *dp)


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
    expand = isinstance(p, MBConv6Params)
    E = p.we.shape[1] if expand else C
    expect = {"dw_kernel": (E, 3, 3), "wp": (E, p.wp.shape[1])}
    if expand:
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
    C2 = p.wp.shape[1]
    if expand and (max(C, C2) > E6_MAX_C or E > E6_MAX_E):
        raise ValueError(f"the expanding form's kernels take C, C2 <= {E6_MAX_C} and "
                         f"E <= {E6_MAX_E}, got C={C}, C2={C2}, E={E}")
    if not expand and max(C, C2) > E1_MAX_C:
        raise ValueError(f"the e=1 form's kernels take C, C2 <= {E1_MAX_C}, got C={C}, "
                         f"C2={C2}")


def fused_mbconv_e6(x, params, delta, valid_h: int, valid_w: int,
                    eps: float = BN_EPS, rank_sum=None) -> Tuple[torch.Tensor, tuple]:
    """x: (N, C, H, W) float32 or bfloat16, zero outside the valid region.

    params: MBConv6Params (expanding form) or MBConvParams (e=1 form), fp32.
    delta: (N,) per-image drop-connect scale (0 drops the residual branch).

    rank_sum: None (the batch is x's), or the sum over data-parallel ranks
    (``core/mesh.py::RankSum``: ``rank_sum(t)`` sums t in place over its
    ``ranks`` ranks, each holding N images of the same shape); the statistics
    are then those of every rank's batch, forward and backward, and the
    parameter gradients stay this rank's.

    Returns (out (N, C2, H, W) in x's dtype with a zero pad region, stats): stats
    is (mean0, var0, mean1, var1, mean2, var2) for the expanding form and
    (mean1, var1, mean2, var2) for e=1; they carry no gradient."""
    if x.device.type == "cpu":
        return plain_fused_mbconv_e6(x, params, delta, valid_h, valid_w, eps, rank_sum)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv_e6 runs on CUDA or CPU tensors, got {x.device}")
    _validate(x, params, delta, valid_h, valid_w)
    out, *stats = _FusedMBConv.apply(x, delta, valid_h, valid_w, eps, type(params), rank_sum,
                                     *params)
    return out, tuple(stats)
