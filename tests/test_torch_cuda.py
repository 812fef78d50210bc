"""The port's hand-written CUDA kernels (``fused_mbconv_e6`` and
``fused_mbconv_e1``) against their plain PyTorch versions, on a card. Every test here is marked ``cuda`` and skips itself without a card.

This file imports neither JAX nor the JAX package, so it also runs on a card
machine that has only PyTorch: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest`` because tests/conftest.py sets up JAX).

Tolerances are relative to the largest entry of each tensor: 1e-4 for fp32
outputs and stats (same fp32 math, other summation order), 1e-3 for
gradients (long reassociated sums and BatchNorm backward cancellation), 1e-2
for bf16 outputs and dx (one bf16 rounding, 2^-8, of the same fp32 value).
"""

import pytest
import torch

from mammo_clip_tpu_torch.ops.mbconv import (
    MBConvParams,
    fused_mbconv_e1,
    launches,
    plain_fused_mbconv_e1,
)
from mammo_clip_tpu_torch.ops.mbconv6 import MBConv6Params, fused_mbconv_e6, plain_fused_mbconv_e6

N, C, H, W = 2, 8, 44, 12
HPAD, WPAD = 48, 16
CASES = [("e6", C), ("e6", 6), ("e1", C), ("e1", 6)]


def _case(form, c2, device):
    g = torch.Generator(device="cpu").manual_seed(0)
    f = lambda *s: 0.5 * torch.randn(*s, generator=g)
    e = 4 * C if form == "e6" else C
    sq = max(1, C // 4)
    p = dict(dw_kernel=f(e, 3, 3), gamma1=1 + 0.1 * f(e), beta1=0.1 * f(e),
             se_w1=f(e, sq), se_b1=0.1 * f(sq), se_w2=f(sq, e), se_b2=0.1 * f(e),
             wp=0.5 * f(e, c2), gamma2=1 + 0.1 * f(c2), beta2=0.1 * f(c2))
    cls = MBConvParams
    if form == "e6":
        p.update(we=0.5 * f(C, e), gamma0=1 + 0.1 * f(e), beta0=0.1 * f(e))
        cls = MBConv6Params
    x = torch.zeros(N, C, HPAD, WPAD)
    x[:, :, :H, :W] = torch.randn(N, C, H, W, generator=g)
    gout = torch.zeros(N, c2, HPAD, WPAD)
    gout[:, :, :H, :W] = torch.randn(N, c2, H, W, generator=g)
    params = cls(**{k: p[k].to(device) for k in cls._fields})
    return x.to(device), params, torch.tensor([1.25, 0.0], device=device), gout.to(device)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form,c2", CASES)
def test_cuda_kernel_matches_plain(form, c2, dtype):
    """Forward, stats, zero pads, dx and every parameter gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    x0, p0, delta, gout = _case(form, c2, "cuda")
    runs = []
    for fn in (fused_mbconv_e6, plain_fused_mbconv_e6):
        x = x0.to(dt).clone().requires_grad_(True)
        p = type(p0)(*[t.clone().requires_grad_(True) for t in p0])
        out, stats = fn(x, p, delta, H, W)
        out.backward(gout.to(dt))
        torch.cuda.synchronize()
        runs.append((out.detach().float().clone(), stats, x.grad.float().clone(),
                     [t.grad for t in p]))
    (ok, sk, dxk, gk), (op, sp, dxp, gp) = runs
    bf16 = dtype == "bfloat16"
    assert _rel(ok, op) < (1e-2 if bf16 else 1e-4)
    assert ok[:, :, H:].abs().max() == 0 and ok[:, :, :, W:].abs().max() == 0
    assert dxk[:, :, H:].abs().max() == 0 and dxk[:, :, :, W:].abs().max() == 0
    for a, b in zip(sk, sp):
        assert _rel(a, b) < 1e-4
    assert _rel(dxk, dxp) < (1e-2 if bf16 else 1e-3)
    for name, a, b in zip(type(p0)._fields, gk, gp):
        assert _rel(a, b) < 1e-3, name


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x, p, delta, _ = _case("e6", C, "cuda")
    with pytest.raises(TypeError):
        fused_mbconv_e6(x.half(), p, delta, H, W)
    with pytest.raises(ValueError):
        fused_mbconv_e6(x.transpose(2, 3), p, delta, H, W)
    with pytest.raises(TypeError):
        fused_mbconv_e6(x, type(p)(*[t.cpu() for t in p]), delta, H, W)


def _e1_case(c1, c2, h, w, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    f = lambda *s: 0.5 * torch.randn(*s, generator=g)
    sq = max(1, c1 // 4)
    p = MBConvParams(dw_kernel=f(c1, 3, 3), gamma1=1 + 0.1 * f(c1), beta1=0.1 * f(c1),
                     se_w1=f(c1, sq), se_b1=0.1 * f(sq), se_w2=f(sq, c1), se_b2=0.1 * f(c1),
                     wp=f(c1, c2), gamma2=1 + 0.1 * f(c2), beta2=0.1 * f(c2))
    x = torch.randn(N, c1, h, w, generator=g)
    gout = torch.randn(N, c2, h, w, generator=g)
    p = MBConvParams(*[t.cuda() for t in p])
    return x.cuda(), p, torch.tensor([1.25, 0.0], device="cuda"), gout.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c1,c2,h,w", [(8, 8, 48, 12), (16, 8, 48, 12), (24, 24, 16, 70)])
def test_cuda_e1_kernel_matches_plain(c1, c2, h, w, dtype):
    """fused_mbconv_e1 (csrc/mbconv1.cu) against its plain version: out, stats,
    dx and every parameter gradient, with and without the residual, with a
    width that is not a multiple of the kernel's 32-column chunk. Same
    tolerances as the e6 kernel (module docstring)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    x0, p0, delta, gout = _e1_case(c1, c2, h, w)
    runs = []
    for fn in (fused_mbconv_e1, plain_fused_mbconv_e1):
        before = launches.total("mbconv1", "forward")
        x = x0.to(dt).clone().requires_grad_(True)
        p = MBConvParams(*[t.clone().requires_grad_(True) for t in p0])
        out, stats = fn(x, p, delta)
        out.backward(gout.to(dt))
        torch.cuda.synchronize()
        runs.append((out.detach().float().clone(), stats, x.grad.float().clone(),
                     [t.grad for t in p], launches.total("mbconv1", "forward") - before))
    (ok, sk, dxk, gk, nk), (op, sp, dxp, gp, npl) = runs
    assert (nk, npl) == (1, 0)
    assert ok.dtype == op.dtype and out.dtype == dt
    bf16 = dtype == "bfloat16"
    assert _rel(ok, op) < (1e-2 if bf16 else 1e-4)
    for a, b in zip(sk, sp):
        assert _rel(a, b) < 1e-4
    assert _rel(dxk, dxp) < (1e-2 if bf16 else 1e-3)
    for name, a, b in zip(MBConvParams._fields, gk, gp):
        assert _rel(a, b) < 1e-3, name


@pytest.mark.cuda
def test_cuda_e1_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x, p, delta, _ = _e1_case(8, 8, 16, 12)
    with pytest.raises(ValueError):
        fused_mbconv_e1(x[:, :, :12].contiguous(), p, delta)  # H % 8 != 0
    with pytest.raises(TypeError):
        fused_mbconv_e1(x.half(), p, delta)
    with pytest.raises(ValueError):
        fused_mbconv_e1(x.transpose(2, 3), p, delta)
    with pytest.raises(TypeError):
        fused_mbconv_e1(x, MBConvParams(*[t.cpu() for t in p]), delta)
    wide, pw, _, _ = _e1_case(72, 8, 16, 12)
    with pytest.raises(ValueError):
        fused_mbconv_e1(wide, pw, delta)  # more channels than the kernel takes
