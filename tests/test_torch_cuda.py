"""The port's hand-written CUDA kernels (``fused_mbconv_e6``, ``fused_mbconv_e1``,
flash attention and the probe kernels) against their plain PyTorch versions, on a card. Every test here is marked ``cuda`` and skips itself without a card.
The paths that run no hand kernel (the embedding extractor, a classifier's
lp step, the NMS, a RetinaNet's forward, ``detect`` and train step) are held
on the card against the same computation on the CPU.

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


def _case(form, c2, device, n=N):
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
    x = torch.zeros(n, C, HPAD, WPAD)
    x[:, :, :H, :W] = torch.randn(n, C, H, W, generator=g)
    gout = torch.zeros(n, c2, HPAD, WPAD)
    gout[:, :, :H, :W] = torch.randn(n, c2, H, W, generator=g)
    params = cls(**{k: p[k].to(device) for k in cls._fields})
    delta = torch.tensor(([1.25, 0.0, 1.0, 1.25] * n)[:n], device=device)
    return x.to(device), params, delta, gout.to(device)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form,c2", CASES)
def test_cuda_kernel_matches_plain(form, c2, dtype):
    """Forward, stats, zero pads, dx and every parameter gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _check_kernel(form, c2, dtype, N)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["e6", "e1"])
def test_cuda_kernel_matches_plain_at_the_classifier_batch(form):
    """The ft arm of the classifier runs the kernel at batch 8 in fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _check_kernel(form, C, "float32", 8)


def _check_kernel(form, c2, dtype, n):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    x0, p0, delta, gout = _case(form, c2, "cuda", n)
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


# (C, E, C2, H, W, valid_h, valid_w): edges the expanding form's tiles must
# mask. C and E not multiples of 16 (the mma steps), two 32-column tiles with
# a ragged valid width and a valid height off the 8-row tile, C2 != C (no
# residual), and block 4's channel widths on a small image.
E6_EDGES = [(6, 36, 6, 24, 40, 21, 37), (6, 36, 4, 24, 40, 21, 37),
            (40, 240, 40, 16, 40, 11, 38)]


def _e6_case(c, e, c2, h, w, vh, vw, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    f = lambda *s: 0.5 * torch.randn(*s, generator=g)
    sq = max(1, c // 4)
    p = MBConv6Params(we=f(c, e), gamma0=1 + 0.1 * f(e), beta0=0.1 * f(e), dw_kernel=f(e, 3, 3),
                      gamma1=1 + 0.1 * f(e), beta1=0.1 * f(e), se_w1=f(e, sq), se_b1=0.1 * f(sq),
                      se_w2=f(sq, e), se_b2=0.1 * f(e), wp=f(e, c2) * 2 / e ** 0.5,
                      gamma2=1 + 0.1 * f(c2), beta2=0.1 * f(c2))
    x = torch.zeros(N, c, h, w)
    x[:, :, :vh, :vw] = torch.randn(N, c, vh, vw, generator=g)
    gout = torch.zeros(N, c2, h, w)
    gout[:, :, :vh, :vw] = torch.randn(N, c2, vh, vw, generator=g)
    p = MBConv6Params(*[t.cuda() for t in p])
    return x.cuda(), p, torch.tensor([1.25, 0.0], device="cuda"), gout.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", E6_EDGES)
def test_cuda_e6_form_masks_the_tiles_edges(shape, dtype):
    """The expanding form's recompute kernels (csrc/mbconv6_e6.cu) against the
    plain version where the tiles and the mma steps have ragged edges: out,
    stats, zero pads, dx and every parameter gradient, at the tolerances of
    test_cuda_kernel_matches_plain; delta drops the second image."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    c, e, c2, h, w, vh, vw = shape
    x0, p0, delta, gout = _e6_case(c, e, c2, h, w, vh, vw)
    runs = []
    for fn in (fused_mbconv_e6, plain_fused_mbconv_e6):
        x = x0.to(dt).clone().requires_grad_(True)
        p = MBConv6Params(*[t.clone().requires_grad_(True) for t in p0])
        out, stats = fn(x, p, delta, vh, vw)
        out.backward(gout.to(dt))
        torch.cuda.synchronize()
        runs.append((out.detach().float().clone(), stats, x.grad.float().clone(),
                     [t.grad for t in p]))
    (ok, sk, dxk, gk), (op, sp, dxp, gp) = runs
    bf16 = dtype == "bfloat16"
    assert _rel(ok, op) < (1e-2 if bf16 else 1e-4)
    assert ok[:, :, vh:].abs().max() == 0 and ok[:, :, :, vw:].abs().max() == 0
    assert dxk[:, :, vh:].abs().max() == 0 and dxk[:, :, :, vw:].abs().max() == 0
    for a, b in zip(sk, sp):
        assert _rel(a, b) < 1e-4
    assert _rel(dxk, dxp) < (1e-2 if bf16 else 1e-3)
    for name, a, b in zip(MBConv6Params._fields, gk, gp):
        assert _rel(a, b) < 1e-3, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_e6_backward_gives_the_same_bits_twice(dtype):
    """No float atomics: two backward passes of the expanding form on the same
    inputs give the same bits in dx and every parameter gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.ops.mbconv6 import _e6_backward, _e6_forward

    c, e, c2, h, w, vh, vw = E6_EDGES[2]
    x, p, delta, gout = _e6_case(c, e, c2, h, w, vh, vw, seed=1)
    dt = getattr(torch, dtype)
    x, gout = x.to(dt), gout.to(dt)
    _, stats, kept = _e6_forward(x, p, delta, vh, vw, 1e-3)
    runs = [_e6_backward(x, p, delta, vh, vw, 1e-3, gout, stats, kept) for _ in range(2)]
    torch.cuda.synchronize()
    (dx1, g1), (dx2, g2) = runs
    assert torch.equal(dx1, dx2)
    for name, a, b in zip(MBConv6Params._fields, g1, g2):
        assert torch.equal(a, b), name


# (C, C2, H, W, valid_h, valid_w): edges the e=1 form's tiles must mask. B5's
# block 0 (48 -> 24) and blocks 1-2 (24 -> 24, with the residual), b7's block 0
# (64 -> 32, the widest the model routes), C = 6 (past C in the 16-channel
# chunks); ragged valid regions off the 8-row and 32-column tiles, and one
# whose padded height has rows no tile covers (dx written 0 there apart).
E1_EDGES = [(48, 24, 24, 40, 21, 37), (24, 24, 24, 40, 21, 37), (64, 32, 16, 40, 11, 38),
            (6, 6, 24, 40, 21, 37), (24, 24, 32, 40, 11, 38)]


def _e1_form_case(c, c2, h, w, vh, vw, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    f = lambda *s: 0.5 * torch.randn(*s, generator=g)
    sq = max(1, c // 4)
    p = MBConvParams(dw_kernel=f(c, 3, 3), gamma1=1 + 0.1 * f(c), beta1=0.1 * f(c),
                     se_w1=f(c, sq), se_b1=0.1 * f(sq), se_w2=f(sq, c), se_b2=0.1 * f(c),
                     wp=f(c, c2) * 2 / c ** 0.5, gamma2=1 + 0.1 * f(c2), beta2=0.1 * f(c2))
    x = torch.zeros(N, c, h, w)
    x[:, :, :vh, :vw] = torch.randn(N, c, vh, vw, generator=g)
    gout = torch.zeros(N, c2, h, w)
    gout[:, :, :vh, :vw] = torch.randn(N, c2, vh, vw, generator=g)
    p = MBConvParams(*[t.cuda() for t in p])
    return x.cuda(), p, torch.tensor([1.25, 0.0], device="cuda"), gout.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", E1_EDGES)
def test_cuda_e1_form_masks_the_tiles_edges(shape, dtype):
    """The e=1 form's recompute passes (csrc/mbconv6_e6.cu) against the plain
    version where the tiles and the mma steps have ragged edges: out, stats,
    zero pads, dx and every parameter gradient, at the tolerances of
    test_cuda_kernel_matches_plain; delta drops the second image."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    c, c2, h, w, vh, vw = shape
    x0, p0, delta, gout = _e1_form_case(c, c2, h, w, vh, vw)
    runs = []
    for fn in (fused_mbconv_e6, plain_fused_mbconv_e6):
        x = x0.to(dt).clone().requires_grad_(True)
        p = MBConvParams(*[t.clone().requires_grad_(True) for t in p0])
        out, stats = fn(x, p, delta, vh, vw)
        out.backward(gout.to(dt))
        torch.cuda.synchronize()
        runs.append((out.detach().float().clone(), stats, x.grad.float().clone(),
                     [t.grad for t in p]))
    (ok, sk, dxk, gk), (op, sp, dxp, gp) = runs
    bf16 = dtype == "bfloat16"
    assert _rel(ok, op) < (1e-2 if bf16 else 1e-4)
    assert ok[:, :, vh:].abs().max() == 0 and ok[:, :, :, vw:].abs().max() == 0
    assert dxk[:, :, vh:].abs().max() == 0 and dxk[:, :, :, vw:].abs().max() == 0
    for a, b in zip(sk, sp):
        assert _rel(a, b) < 1e-4
    assert _rel(dxk, dxp) < (1e-2 if bf16 else 1e-3)
    for name, a, b in zip(MBConvParams._fields, gk, gp):
        assert _rel(a, b) < 1e-3, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_e1_form_backward_gives_the_same_bits_twice(dtype):
    """No float atomics: two backward passes of the e=1 form on the same inputs
    give the same bits in dx and every parameter gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.ops.mbconv6 import _e1_backward, _e1_forward

    c, c2, h, w, vh, vw = E1_EDGES[0]
    x, p, delta, gout = _e1_form_case(c, c2, h, w, vh, vw, seed=1)
    dt = getattr(torch, dtype)
    x, gout = x.to(dt), gout.to(dt)
    _, stats, kept = _e1_forward(x, p, delta, vh, vw, 1e-3)
    runs = [_e1_backward(x, p, delta, vh, vw, 1e-3, gout, stats, kept) for _ in range(2)]
    torch.cuda.synchronize()
    (dx1, g1), (dx2, g2) = runs
    assert torch.equal(dx1, dx2)
    for name, a, b in zip(MBConvParams._fields, g1, g2):
        assert torch.equal(a, b), name


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
    """fused_mbconv_e1 (the e=1 form's passes of csrc/mbconv6_e6.cu over the
    whole image) against its plain version: out, stats, dx and every parameter
    gradient, with and without the residual, with a width that is not a
    multiple of the passes' 32-column tile. Same tolerances as the e6 kernel
    (module docstring)."""
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
@pytest.mark.parametrize("c1,c2,h,w", [(16, 8, 48, 12), (24, 24, 16, 70)])
def test_cuda_e1_entry_gives_the_bits_of_the_e1_form(c1, c2, h, w):
    """fused_mbconv_e1 runs the e=1 form of fused_mbconv_e6 over the whole image:
    the same bits for out, the stats, dx and every parameter gradient (bf16),
    counted under mbconv1.* only."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x0, p0, delta, gout = _e1_case(c1, c2, h, w, seed=2)
    runs = []
    for fn in (lambda x, p: fused_mbconv_e1(x, p, delta),
               lambda x, p: fused_mbconv_e6(x, p, delta, h, w)):
        before = dict(launches.counts)
        x = x0.bfloat16().requires_grad_(True)
        p = MBConvParams(*[t.clone().requires_grad_(True) for t in p0])
        out, stats = fn(x, p)
        out.backward(gout.bfloat16())
        torch.cuda.synchronize()
        runs.append(([out.detach(), *stats, x.grad, *[t.grad for t in p]],
                     {k: v - before[k] for k, v in launches.counts.items() if v != before[k]}))
    (a, na), (b, nb) = runs
    assert na == {"mbconv1.forward": 1, "mbconv1.backward": 1}
    assert nb == {"mbconv6.e1.forward": 1, "mbconv6.e1.backward": 1}
    for i, (u, v) in enumerate(zip(a, b)):
        assert torch.equal(u, v), i


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


# ----------------------------------------------------------------------------
# flash attention (csrc/flash_attention.cu) and the probe kernels (csrc/probes.cu)
# ----------------------------------------------------------------------------


def _qkv(shape, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(*shape, generator=g).to(dtype).cuda() for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 128, 64), (1, 2, 200, 32), (2, 2, 77, 64),
                                   (1, 1, 70, 128), (1, 2, 33, 48), (1, 2, 96, 36),
                                   (1, 2, 257, 64), (2, 3, 1000, 64)])
def test_cuda_flash_attention_matches_plain(shape, dtype):
    """Output and dq, dk, dv of the kernel against the plain version: fp32 within
    1e-4 (same math, other summation order); bf16 within 1e-2 (one bf16 rounding
    of each output, the bf16 P and dS operands of the tensor-core products, as
    the TPU kernel rounds them, and the backward's rowsum(dO * o) taken from the
    rounded o). D = 36 is not a multiple of 8, so the bf16 kernels copy their
    tiles element by element; S = 257 puts one key past a 64-row tile; S = 1000
    is a long sequence (16 tiles, the last of 40 rows), as ViT's 5416 is."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.ops.flash_attention import (
        flash_attention,
        launches as fa_launches,
        plain_flash_attention,
    )

    dt = getattr(torch, dtype)
    q0, k0, v0, go = _qkv(shape, dt)
    scale = shape[-1] ** -0.5
    runs = []
    for fn in (flash_attention, plain_flash_attention):
        before = dict(fa_launches.counts)
        q, k, v = [t.clone().requires_grad_(True) for t in (q0, k0, v0)]
        out = fn(q, k, v, scale)
        out.backward(go)
        torch.cuda.synchronize()
        runs.append((out.detach().float(), q.grad.float(), k.grad.float(), v.grad.float(),
                     {key: fa_launches.counts[key] - before[key] for key in before}))
        assert out.dtype == dt and q.grad.dtype == dt
    tol = 1e-2 if dtype == "bfloat16" else 1e-4
    for name, a, b in zip(("out", "dq", "dk", "dv"), runs[0][:4], runs[1][:4]):
        assert _rel(a, b) < tol, (name, _rel(a, b))
    assert list(runs[0][4].values()) == [1, 1] and list(runs[1][4].values()) == [0, 0]


@pytest.mark.cuda
def test_cuda_vit_attention_runs_the_flash_kernel():
    """A tiny ViT (2 layers, 4x6 grid + CLS: S = 25, D = 16) on the card against
    the CPU from the same weights, fp32 with TF32 off: every layer's attention
    launches the flash kernel forward and backward (the CPU takes its plain
    version), outputs within 1e-4 and gradients within 1e-3 of the largest."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.models import ViT, ViTConfig, init_parameters
    from mammo_clip_tpu_torch.ops.flash_attention import launches as fa_launches
    from mammo_clip_tpu_torch.utils.device import full_fp32

    cpu = ViT(ViTConfig.tiny())
    init_parameters(cpu, torch.Generator().manual_seed(0))
    card = ViT(ViTConfig.tiny()).cuda()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 32, 48, 1, generator=torch.Generator().manual_seed(1))
    res = []
    with full_fp32():
        for model, xd in ((card, x.cuda()), (cpu, x)):
            before = dict(fa_launches.counts)
            out = model(xd, train=True)
            (out["tokens"].float() ** 2).sum().backward()
            torch.cuda.synchronize()
            res.append((out["tokens"].detach().cpu(),
                        {n: p.grad.cpu() for n, p in model.named_parameters()},
                        [fa_launches.counts[k] - before[k] for k in before]))
    assert res[0][2] == [2, 2] and res[1][2] == [0, 0]
    assert _rel(res[0][0], res[1][0]) < 1e-4
    scale = max(float(g.abs().max()) for g in res[1][1].values())
    for name, g in res[1][1].items():
        assert float((res[0][1][name] - g).abs().max()) <= 1e-3 * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_single_key(dtype):
    """S = 1: the softmax over one key is 1, so o is v and dv is dO, bit for bit
    in both dtypes; dq and dk are zero in exact arithmetic and here only the
    difference of two fp32 sums of dO * v (dP and Dvec), so they are held within
    the dtype's tolerance of the largest entry of dO."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.ops.flash_attention import flash_attention

    dt = getattr(torch, dtype)
    q0, k0, v0, go = _qkv((2, 3, 1, 64), dt)
    q, k, v = [t.clone().requires_grad_(True) for t in (q0, k0, v0)]
    out = flash_attention(q, k, v, 0.125)
    out.backward(go)
    torch.cuda.synchronize()
    tol = 1e-2 if dtype == "bfloat16" else 1e-4
    assert torch.equal(out, v0) and torch.equal(v.grad, go)
    for grad in (q.grad, k.grad):
        assert float(grad.float().abs().max()) <= tol * float(go.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_backward_is_deterministic(dtype):
    """No float atomics and one writer per element: two backward passes on the
    same inputs give the same bits in dq, dk and dv."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.ops.flash_attention import flash_attention

    q0, k0, v0, go = _qkv((2, 3, 200, 64), getattr(torch, dtype))
    grads = []
    for _ in range(2):
        q, k, v = [t.clone().requires_grad_(True) for t in (q0, k0, v0)]
        flash_attention(q, k, v, 0.125).backward(go)
        grads.append((q.grad, k.grad, v.grad))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.ops.flash_attention import flash_attention

    q, k, v, _ = _qkv((1, 2, 16, 64), torch.float32)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half(), 0.125)
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v, 0.125)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3), k, v, 0.125)  # (B, N, D, S) view: wrong shape
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, 0.125)
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v, 0.125)
    wide = [torch.zeros(1, 1, 8, 160, device="cuda") for _ in range(3)]
    with pytest.raises(ValueError):
        flash_attention(*wide, 0.1)


def _grid_inputs(N=2, C=8, E=24, H=32, W=70, seed=0):
    import numpy as np

    r = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(r.standard_normal(s)).to(torch.bfloat16).cuda()
    return f(N, C, H, W), f(E, 9, W), f(E, 1, W), f(C, E)


# Gram cases: ("gram", C, R, W, L): the three probe shapes ((16, 8, 380-of-384) is
# concat_aligned's padded buffer read in place), C = 1, 5 and 40, and W = 379 of
# L = 383, which takes the kernel's 4-byte loads. Copy cases: ("copy", n, offset):
# n % 4 != 0, and a contiguous input one float into its buffer, whose 16-byte
# misalignment takes the 4-byte path.
LAYOUT_CASES = [("gram", 16, 8, 380, 384), ("gram", 16, 8, 384, 384), ("gram", 16, 10, 384, 384),
                ("gram", 1, 8, 384, 384), ("gram", 5, 8, 384, 384), ("gram", 40, 8, 384, 384),
                ("gram", 16, 8, 379, 383), ("copy", 61442, 0), ("copy", 61440, 1)]


def _layout_case(case):
    """One Gram or copy kernel call against its plain version: Gram within 1e-5
    of the largest entry (fp32 sums in another order), the copy bit-exact."""
    from mammo_clip_tpu_torch.ops import probes

    g = torch.Generator(device="cpu").manual_seed(2)
    before = dict(probes.launches.counts)
    if case[0] == "gram":
        _, C, R, W, L = case
        x = torch.randn(C, R, L, generator=g).cuda()
        got, want, key = probes.gram_rows(x, W), probes.plain_gram_rows(x, W), "probe_layout.gram"
        torch.cuda.synchronize()
        assert got.shape == (C, C) and got.dtype == torch.float32
        assert _rel(got, want) <= 1e-5, _rel(got, want)
        assert torch.equal(got, got.t())
    else:
        _, n, offset = case
        buf = torch.randn(n + offset, generator=g).cuda()
        x = buf[offset:]
        assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
        got, key = probes.copy_scale(x, (n,), 3.0), "probe_layout.copy_scale"
        torch.cuda.synchronize()
        assert torch.equal(got, probes.plain_copy_scale(x, (n,), 3.0))
    counts = {k: probes.launches.counts[k] - before[k] for k in before}
    assert counts == {**dict.fromkeys(counts, 0), key: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 24, 32, 70), (1, 40, 240, 16, 384), *LAYOUT_CASES])
def test_cuda_probe_kernels_match_plain(shape):
    """The four grid kernels and the three layout kernels against their plain
    versions: sums of many bf16 values in fp32 in another order, within 1e-4 of
    the largest entry; the compute chain's bf16 roundings may flip an ulp where
    z or SiLU sits on a rounding tie, hence 1e-3 there. The const output is
    mostly its bank term, which fp32 holds to far less than the x part, so the
    const kernel is also held with vec = -k[:, 0:1, :]: the bank cancels exactly
    and the x part must match the base sum alone. The Gram and copy cases
    (``LAYOUT_CASES``) hold those two kernels alone at more shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    if isinstance(shape[0], str):
        return _layout_case(shape)
    from mammo_clip_tpu_torch.ops import probes

    x, k, vec, we = _grid_inputs(*shape)
    before = dict(probes.launches.counts)
    pairs = [(probes.grid_base(x), probes.plain_grid_base(x), 1e-4),
             (probes.grid_halo(x), probes.plain_grid_halo(x), 1e-4),
             (probes.grid_const(x, k, vec), probes.plain_grid_const(x, k, vec), 1e-4),
             (probes.grid_const(x, k, (-k[:, 0:1, :]).contiguous()), probes.plain_grid_base(x),
              1e-4),
             (probes.grid_compute(x, we, k), probes.plain_grid_compute(x, we, k), 1e-3)]
    g = torch.Generator(device="cpu").manual_seed(1)
    xl = torch.randn(16, 8, 380, generator=g).cuda()
    wl = torch.randn(16, 16, generator=g).cuda()
    pairs += [(probes.gram_rows(xl), probes.plain_gram_rows(xl), 1e-5),
              (probes.gram_rows(xl, 300), probes.plain_gram_rows(xl, 300), 1e-5),
              (probes.copy_scale(xl, (16, 8 * 380), 2.0), probes.plain_copy_scale(xl, (16, 3040), 2.0),
               0.0),
              (probes.channel_mix(xl, wl), probes.plain_channel_mix(xl, wl), 1e-5)]
    torch.cuda.synchronize()
    for i, (got, want, tol) in enumerate(pairs):
        assert got.shape == want.shape and got.dtype == torch.float32, i
        assert _rel(got, want) <= tol, (i, _rel(got, want))
    counts = {key: probes.launches.counts[key] - before[key] for key in before}
    assert counts == {**dict.fromkeys(counts, 1), "probe_grid.const": 2, "probe_layout.gram": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("C,R,W,L", [(16, 8, 380, 384), (40, 10, 379, 383)])
def test_cuda_gram_kernel_gives_the_same_bits_on_every_call(C, R, W, L):
    """No float atomics: the slices and the cluster's blocks are added in a fixed
    order, so two calls on the same input agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.ops import probes

    x = torch.randn(C, R, L, generator=torch.Generator(device="cpu").manual_seed(3)).cuda()
    first, second = probes.gram_rows(x, W), probes.gram_rows(x, W)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_probe_kernels_run_on_the_callers_stream():
    """The launch path reads PyTorch's current stream: kernels launched inside
    ``torch.cuda.stream(s)`` land on s, so their results are there after
    ``s.synchronize()`` alone, read back by copies on s, while the default
    stream is still held by a sleep kernel (a launch on the default stream
    would still be waiting behind it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.ops import probes

    g = torch.Generator(device="cpu").manual_seed(4)
    x_cpu = torch.randn(16, 10, 384, generator=g)
    xg_cpu = torch.randn(2, 8, 32, 70, generator=g).bfloat16()
    x, xg = x_cpu.cuda(), xg_cpu.cuda()
    calls = (lambda: probes.gram_rows(x, 380), lambda: probes.copy_scale(x, (16, 3840), 2.0),
             lambda: probes.grid_base(xg))
    for call in calls:  # builds the library and loads the kernels before the sleep
        call()
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    torch.cuda._sleep(200_000_000)  # holds the default stream for ~0.1 s
    with torch.cuda.stream(s):
        outs = [call() for call in calls]
        s.synchronize()
        gram, copy, base = (t.cpu() for t in outs)  # copies on s
    assert torch.cuda.current_stream().query() is False  # the sleep is still running
    torch.cuda.synchronize()
    assert _rel(gram, probes.plain_gram_rows(x_cpu, 380)) <= 1e-5
    assert torch.equal(copy, probes.plain_copy_scale(x_cpu, (16, 3840), 2.0))
    assert _rel(base, probes.plain_grid_base(xg_cpu)) <= 1e-4


@pytest.mark.cuda
def test_cuda_probe_kernels_run_on_a_tensor_of_another_device():
    """A tensor on a device other than the current one: the C launcher makes its
    device current for the launch and restores the caller's."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards")
    from mammo_clip_tpu_torch.ops import probes

    x_cpu = torch.randn(16, 8, 384, generator=torch.Generator(device="cpu").manual_seed(5))
    x = x_cpu.to("cuda:1")
    xg, k, vec, _ = (t.to("cuda:1") for t in _grid_inputs())
    with torch.cuda.device(0):
        gram, copy = probes.gram_rows(x), probes.copy_scale(x, (16, 3072), 2.0)
        const = probes.grid_const(xg, k, vec)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(1)
    assert gram.device == x.device and copy.device == x.device and const.device == x.device
    assert _rel(const, probes.plain_grid_const(xg, k, vec)) <= 1e-4
    assert _rel(gram.cpu(), probes.plain_gram_rows(x_cpu)) <= 1e-5
    assert torch.equal(copy.cpu(), probes.plain_copy_scale(x_cpu, (16, 3072), 2.0))


# (N, C, E, H, W): W not a multiple of the 64-column range (70, 38; 4-byte loads),
# E not a multiple of the 64-channel group (24, 72, and E = C = 8), C = 40 padded
# to K = 48 (the probe's channels, 16-byte loads at W = 384), one row tile (H = 8)
GRID_COMPUTE_CASES = [(2, 8, 24, 32, 70), (1, 8, 8, 16, 38), (1, 40, 240, 16, 384),
                      (2, 40, 72, 8, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GRID_COMPUTE_CASES)
def test_cuda_grid_compute_kernel_matches_plain_on_every_channel(shape):
    """The compute kernel's sums for all E expanded channels against the plain
    version within 1e-3 of the largest (a bf16 rounding of z or SiLU may flip
    one ulp; fp32 sums in another order), the probe's output as their first C,
    and two calls with the same bits (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.ops import probes

    N, C, E, H, W = shape
    x, k, _, we = _grid_inputs(*shape, seed=7)
    before = probes.launches.counts["probe_grid.compute"]
    first, second = (probes.grid_compute_channel_sums(x, we, k) for _ in range(2))
    out = probes.grid_compute(x, we, k)
    want = probes.plain_grid_compute_channel_sums(x, we, k)
    torch.cuda.synchronize()
    assert first.shape == (E,) and first.dtype == torch.float32
    assert _rel(first, want) <= 1e-3, _rel(first, want)
    assert torch.equal(first, second)
    assert torch.equal(out, first[:C].view(C, 1, 1))
    assert probes.launches.counts["probe_grid.compute"] - before == 3


# (N, C, E, H, W, offset): the probe's shape; one slab a plane (N = 1, H = 8); W % 8
# != 0 (24, 26); C = 3; E = 7, whose E W pairs split unevenly over the blocks' bank
# shares; x a view 2 bf16 (4 bytes) into its buffer, off 16-byte alignment, which
# takes the kernel's 4-byte register loads instead of the bulk-copy ring.
GRID_CONST_CASES = [(16, 40, 240, 232, 384, 0), (1, 8, 24, 8, 70, 0), (2, 8, 24, 32, 24, 0),
                    (2, 8, 24, 32, 26, 0), (2, 3, 24, 32, 384, 0), (2, 8, 7, 32, 70, 0),
                    (2, 8, 24, 32, 70, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GRID_CONST_CASES)
def test_cuda_grid_const_kernel_matches_plain(shape):
    """The const kernel (the bulk-copy ring, or the 4-byte register loads for an x
    off 16-byte alignment) against the plain version within 1e-4 of the largest entry (fp32 sums in another
    order), as is and with vec = -k[:, 0:1, :], which cancels the bank exactly so
    that the x part is held to the base sum alone; two calls give the same bits,
    and each call of the wrapper counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.ops import probes

    N, C, E, H, W, offset = shape
    x0, k, vec, _ = _grid_inputs(N, C, E, H, W, seed=9)
    x = torch.empty(x0.numel() + offset, dtype=x0.dtype, device="cuda")[offset:].view(x0.shape)
    x.copy_(x0)
    assert (x.data_ptr() % 16 == 0) == (offset == 0) and x.data_ptr() % 4 == 0
    vec0 = (-k[:, 0:1, :]).contiguous()
    want, base = probes.plain_grid_const(x, k, vec), probes.plain_grid_base(x)
    before = probes.launches.counts["probe_grid.const"]
    first, second = probes.grid_const(x, k, vec), probes.grid_const(x, k, vec)
    cancelled = probes.grid_const(x, k, vec0)
    torch.cuda.synchronize()
    assert probes.launches.counts["probe_grid.const"] - before == 3
    assert first.shape == (C, 1, 1) and first.dtype == torch.float32
    for got, ref in ((first, want), (cancelled, base)):
        assert _rel(got, ref) <= 1e-4, _rel(got, ref)
    assert torch.equal(first, second)


# (C, C2, H, W, offset): the probe's shape, C2 != C both ways, W % 4 != 0, and x a
# view one float into its buffer (4-byte aligned only): the last two take the
# value-by-value loads and stores.
CHANNEL_MIX_CASES = [(16, 16, 8, 384, 0), (16, 24, 8, 384, 0), (5, 3, 8, 384, 0),
                     (16, 16, 8, 381, 0), (16, 16, 8, 384, 1), (40, 70, 3, 130, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CHANNEL_MIX_CASES)
def test_cuda_channel_mix_kernel_matches_plain(shape):
    """The channel-mix kernel against the plain version within 1e-5 of the largest
    entry (fp32 sums in c order by fmaf, against the library's order), the same
    bits on two calls, one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.ops import probes

    C, C2, H, W, offset = shape
    g = torch.Generator(device="cpu").manual_seed(10)
    buf = torch.randn(C * H * W + offset, generator=g).cuda()
    x, w = buf[offset:].view(C, H, W), torch.randn(C, C2, generator=g).cuda()
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    before = probes.launches.counts["probe_layout.channel_mix"]
    first, second = probes.channel_mix(x, w), probes.channel_mix(x, w)
    want = probes.plain_channel_mix(x, w)
    torch.cuda.synchronize()
    assert first.shape == (H, C2, W) and first.dtype == torch.float32
    assert _rel(first, want) <= 1e-5, _rel(first, want)
    assert torch.equal(first, second)
    assert probes.launches.counts["probe_layout.channel_mix"] - before == 2


@pytest.mark.cuda
def test_cuda_tap_products_are_fp32_products_rounded_to_bf16():
    """The compute kernel's packed bf16 multiply against fp32 multiply then round,
    bit for bit: every finite bf16 value whose exponent keeps the products
    normal (|a| in [2^-60, 2^60)), each times 256 seeded values of either sign."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.ops.cuda_lib import launcher

    bits = torch.arange(1 << 16, dtype=torch.int32)
    expo = (bits >> 7) & 0xFF
    a = bits[(expo >= 127 - 60) & (expo < 127 + 60)].to(torch.int16).view(torch.bfloat16)
    g = torch.Generator(device="cpu").manual_seed(8)
    b = (torch.randn(256, generator=g) * torch.rand(256, generator=g) * 8).to(torch.bfloat16)
    a2 = a[:, None].expand(-1, 256).contiguous()
    b2 = b[None, :].expand(len(a), -1).contiguous()
    ac, bc = a2.cuda(), b2.cuda()
    got = torch.empty_like(ac)
    launcher("pr_bf16_mul")(0, ac.data_ptr(), bc.data_ptr(), got.data_ptr(), ac.numel() // 2)
    want = (a2.float() * b2.float()).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_cuda_probe_wrappers_reject_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.ops import probes

    x, k, vec, we = _grid_inputs()
    with pytest.raises(TypeError):
        probes.grid_base(x.float())
    # a contiguous view one bf16 past a 4-byte boundary: refused, not a misaligned load
    odd = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
    odd.copy_(x)
    for call in (lambda: probes.grid_base(odd), lambda: probes.grid_compute(odd, we, k),
                 lambda: probes.grid_const(odd, k, vec)):
        with pytest.raises(ValueError, match="4-byte"):
            call()
    got = probes.grid_base(x)  # the process's CUDA context is still usable
    torch.cuda.synchronize()
    assert _rel(got, probes.plain_grid_base(x)) <= 1e-4
    with pytest.raises(ValueError):
        probes.grid_halo(x[:, :, :12].contiguous())  # H % 8 != 0
    with pytest.raises(TypeError):
        probes.grid_const(x, k.float(), vec)
    for kk, vv in ((k[:, :8].contiguous(), vec), (k, vec[:, :, :8].contiguous()),
                   (k[:5].contiguous(), vec)):  # k not (E, 9, W), vec not (E, 1, W)
        with pytest.raises(ValueError):
            probes.grid_const(x, kk, vv)
    for kk, vv in ((k.cpu(), vec), (k, vec.cpu()), (k, vec.float())):  # k, vec off x's device
        with pytest.raises(TypeError):
            probes.grid_const(x, kk, vv)
    with pytest.raises(ValueError):
        probes.grid_compute(x, we[:, :4].contiguous(), k)  # E < C
    wide, _, _, we_wide = _grid_inputs(C=56, E=56)
    with pytest.raises(ValueError):
        probes.grid_compute(wide, we_wide, k[:1].expand(56, -1, -1).contiguous())  # C > 48
    with pytest.raises(TypeError):
        probes.gram_rows(x[0].float().bfloat16())
    with pytest.raises(TypeError):
        probes.channel_mix(x[0].float(), we.float().cpu()[:, :8])


@pytest.mark.cuda
@pytest.mark.parametrize("image_dtype", ["uint8", "float32"])
def test_cuda_embedding_extractor_matches_the_cpu(image_dtype):
    """The serving path (eval mode: the unfused blocks, no hand kernel) on the
    card against the same weights on the CPU: the tiny CLIP, N = 5 at batch 2,
    images and texts, within 1e-4 (fp32 with TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import numpy as np

    from mammo_clip_tpu_torch.core.config import tiny_test_config
    from mammo_clip_tpu_torch.eval.embeddings import EmbeddingExtractor
    from mammo_clip_tpu_torch.models import build_model

    cfg = tiny_test_config()
    cfg.model.image_encoder.fused_mbconv = True  # eval takes the unfused blocks all the same
    cpu = build_model(cfg.model.to_dict(), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = build_model(cfg.model.to_dict(), device="cuda")
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    h, w, s = cfg.data.image_size_h, cfg.data.image_size_w, cfg.data.text_max_length
    images = rng.integers(0, 256, (5, h, w, 1)).astype(image_dtype)
    mask = (np.arange(s)[None, :] < rng.integers(2, s + 1, 5)[:, None]).astype(np.int32)
    ids = rng.integers(4, cfg.model.text_encoder.vocab_size, (5, s)).astype(np.int32) * mask
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        before = dict(launches.counts)
        outs = []
        for model in (card, cpu):
            ex = EmbeddingExtractor(model, cfg.data.mean, cfg.data.std, batch_size=2)
            outs.append((ex.encode_images(images), ex.encode_texts(ids, mask)))
        assert launches.counts == before  # no fused-kernel launch while serving
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    (img_card, txt_card), (img_cpu, txt_cpu) = outs
    assert img_card.dtype == np.float32 and img_card.shape == (5, cfg.model.projection_head.proj_dim)
    np.testing.assert_allclose(img_card, img_cpu, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(txt_card, txt_cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_device_index_past_the_last_card_is_refused(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.cli import validate, zeroshot
    from mammo_clip_tpu_torch.utils.device import resolve_device

    missing = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(RuntimeError, match="only"):
        resolve_device(missing)
    with pytest.raises(RuntimeError, match="only"):
        zeroshot.main(["--checkpoint", str(tmp_path), "--csv", str(tmp_path / "none.csv"),
                       "--image-dir", "synthetic://", "--device", missing])
    with pytest.raises(RuntimeError, match="only"):
        validate.main(["--workdir", str(tmp_path), "--device", missing])
    assert resolve_device("cuda").type == "cuda"
    torch.zeros(1, device="cuda").sum().item()  # the process's CUDA context is still usable


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["lp", "ft"])
def test_cuda_classifier_step_matches_the_cpu(arch):
    """One train step of a tiny classifier (b0 at 64x48, fused route on, batch
    4, fp32 with TF32 off) on the card against the same step on the CPU from
    the same weights: loss, head gradient and the running statistics after
    the step. The ft step launches the fused kernel (b0's two fused blocks,
    forward and backward), the lp step and the eval step none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.downstream.classify import MammoClassifier
    from mammo_clip_tpu_torch.losses.classification import bce_with_logits_loss
    from mammo_clip_tpu_torch.models import init_parameters

    enc = {"name": "efficientnet-b0", "fused_mbconv": True, "drop_connect_rate": 0.0}
    cpu = MammoClassifier(enc, freeze_encoder=arch == "lp")
    init_parameters(cpu, torch.Generator().manual_seed(0))
    card = MammoClassifier(enc, freeze_encoder=arch == "lp").cuda()
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    images = torch.randn(4, 64, 48, 1, generator=g)
    labels = torch.tensor([0.0, 1.0, 1.0, 0.0])
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        results = []
        for model, device in ((card, "cuda"), (cpu, "cpu")):
            before = (launches.total("mbconv6", "forward"), launches.total("mbconv6", "backward"))
            loss = bce_with_logits_loss(model(images.to(device), train=True)["logits"][:, 0],
                                        labels.to(device), pos_weight=2.0)
            loss.backward()
            with torch.no_grad():
                model(images.to(device), train=False)
            after = (launches.total("mbconv6", "forward"), launches.total("mbconv6", "backward"))
            stats = {k: v.cpu() for k, v in model.state_dict().items()
                     if k.endswith(("mean", "var"))}
            results.append((loss.item(), model.head.kernel.grad.cpu(), stats,
                            (after[0] - before[0], after[1] - before[1])))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    (lk, gk, sk, nk), (lc, gc, sc, nc) = results
    assert abs(lk - lc) <= 1e-4 * max(1.0, abs(lc))
    assert _rel(gk, gc) < 1e-3
    for k in sc:  # some running means are 0 up to rounding: a floor of 1 on the scale
        assert (sk[k] - sc[k]).abs().max() <= 1e-4 * max(1.0, sc[k].abs().max().item()), k
    assert nk == ((2, 2) if arch == "ft" else (0, 0)) and nc == (0, 0)


def _det_pool(device, n_slates=6, A=400, seed=0):
    """A seeded candidate pool with distinct scores: clustered boxes (A, 4) and
    (n_slates, A) scores spread over [0, 1), a twentieth of them under the 0.05
    threshold."""
    g = torch.Generator().manual_seed(seed)
    centers = 20 + 200 * torch.rand(12, 2, generator=g)
    c = centers[torch.randint(0, 12, (A,), generator=g)] + 6 * torch.randn(A, 2, generator=g)
    wh = 16 + 24 * torch.rand(A, 2, generator=g)
    boxes = torch.cat([c - wh / 2, c + wh / 2], 1)
    scores = torch.randperm(n_slates * A, generator=g).float().reshape(n_slates, A)
    return boxes.to(device), (scores / (n_slates * A)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["hard", "gaussian", "linear"])
def test_cuda_nms_matches_the_cpu(mode):
    """The shape-static NMS on the card against the CPU, batched over 6 slates
    (top 100 of 400): the same valid slots and scores, boxes within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.ops.nms import soft_nms, static_nms

    out = []
    for device in ("cuda", "cpu"):
        boxes, scores = _det_pool(device)
        if mode == "hard":
            res = static_nms(boxes[None], scores, 0.5, 0.05, 100)
        else:
            res = soft_nms(boxes[None], scores, 0.5, 0.3, 0.05, 100, mode)
        out.append([t.cpu() for t in res])
    (bk, sk, vk), (bc, sc, vc) = out
    assert torch.equal(vk, vc) and vk.any() and not vk.all()
    assert (bk - bc).abs().max() <= 1e-4
    assert (sk - sc).abs().max() <= 1e-6


def _tiny_detector(freeze=False):
    from mammo_clip_tpu_torch.models import init_parameters
    from mammo_clip_tpu_torch.models.retinanet import RetinaNet, init_heads

    enc = {"name": "efficientnet-b0", "fused_mbconv": True, "drop_connect_rate": 0.0}
    model = RetinaNet(enc, 3, freeze_backbone=freeze)
    init_parameters(model, torch.Generator().manual_seed(0))
    init_heads(model, torch.Generator().manual_seed(1))
    return model


@pytest.mark.cuda
def test_cuda_retinanet_forward_and_detect_match_the_cpu():
    """A tiny RetinaNet (b0 at 64x64, 3 classes, fused route on) on the card
    against the CPU from the same weights, fp32 with TF32 off: class
    probabilities and deltas within 1e-4 of the largest; no fused launch (the
    backbone runs in eval mode); ``detect`` hard and soft on a seeded pool of
    distinct scores: the same valid slots, classes and scores, boxes within
    1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.models.retinanet import detect
    from mammo_clip_tpu_torch.ops.boxes import build_anchors
    from mammo_clip_tpu_torch.utils.device import full_fp32

    cpu = _tiny_detector()
    card = _tiny_detector().cuda()
    card.load_state_dict(cpu.state_dict())
    images = torch.randn(2, 64, 64, 1, generator=torch.Generator().manual_seed(2))
    before = launches.total("mbconv6", "forward")
    with full_fp32(), torch.no_grad():
        got, want = card(images.cuda()), cpu(images)
    assert launches.total("mbconv6", "forward") == before
    for k in ("class_probs", "box_deltas"):
        assert _rel(got[k].cpu(), want[k]) < 1e-4, k
    anchors = torch.from_numpy(build_anchors((64, 64)))
    g = torch.Generator().manual_seed(3)
    A = anchors.shape[0]
    pool = {"class_probs": torch.randperm(2 * A * 3, generator=g).float().reshape(2, A, 3)
            / (2 * A * 3), "box_deltas": 0.5 * torch.randn(2, A, 4, generator=g)}
    for mode in ("hard", "soft"):
        dk = detect({k: v.cuda() for k, v in pool.items()}, anchors.cuda(), (64, 64),
                    score_threshold=0.3, nms=mode)
        dc = detect(pool, anchors, (64, 64), score_threshold=0.3, nms=mode)
        assert torch.equal(dk["valid"].cpu(), dc["valid"]) and dc["valid"].any(), mode
        assert torch.equal(dk["classes"].cpu(), dc["classes"]), mode
        assert (dk["scores"].cpu() - dc["scores"]).abs().max() <= 1e-6, mode
        assert (dk["boxes"].cpu() - dc["boxes"]).abs().max() <= 1e-4, mode


@pytest.mark.cuda
def test_cuda_detector_step_matches_the_cpu():
    """One ``make_detector_steps`` train step (augmentation off, Adam with the
    CLI's clip, fp32 with TF32 off) on the card against the CPU from the same
    weights: the focal loss's parts within 1e-4 relative, the class head's
    gradient within 1e-3 of its largest entry, the backbone's running
    statistics unchanged, no fused launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.downstream.experiments import make_detector_steps
    from mammo_clip_tpu_torch.ops.augment import minmax_standardize
    from mammo_clip_tpu_torch.ops.boxes import build_anchors
    from mammo_clip_tpu_torch.train import build_optimizer, create_train_state
    from mammo_clip_tpu_torch.utils.device import full_fp32

    anchors = build_anchors((64, 64))
    g = torch.Generator().manual_seed(4)
    images = torch.randint(0, 256, (2, 64, 64, 1), generator=g, dtype=torch.uint8)
    ann = -torch.ones(2, 16, 5)
    ann[0, 0] = torch.tensor([*anchors[40], 0])
    ann[0, 1] = torch.tensor([5.0, 7.0, 30.0, 20.0, 2])
    ann[1, 0] = torch.tensor([*anchors[600], 1])
    pre = lambda b, gen: {**b, "images": minmax_standardize(b["images"], 0.3, 0.25)}
    cpu = _tiny_detector()
    results = []
    for device in ("cuda", "cpu"):
        model = _tiny_detector().to(device)
        model.load_state_dict(cpu.state_dict())
        stats = {k: v.clone() for k, v in model.named_buffers()}
        state = create_train_state(model, build_optimizer(
            {"name": "adam", "lr": 1e-4, "grad_clip_norm": 0.1}, lambda s: 1e-4,
            model.named_parameters()))
        grads = []
        step = state.apply_gradients
        state.apply_gradients = lambda: (grads.append(
            model.class_subnet.out.kernel.grad.detach().cpu().clone()), step())[1]
        train_step, _, _ = make_detector_steps(model, anchors, pre)
        before = launches.total("mbconv6", "forward") + launches.total("mbconv6", "backward")
        with full_fp32():
            state, ld = train_step(state, {"images": images.to(device),
                                           "annotations": ann.to(device)},
                                   torch.Generator(device=device), seed=0)
        n = launches.total("mbconv6", "forward") + launches.total("mbconv6", "backward") - before
        assert all(torch.equal(v, stats[k]) for k, v in model.named_buffers())
        results.append(({k: v.item() for k, v in ld.items()}, grads[0], n))
    (lk, gk, nk), (lc, gc, nc) = results
    for k in ("classification", "regression", "total"):
        assert abs(lk[k] - lc[k]) <= 1e-4 * max(1.0, abs(lc[k])), (k, lk[k], lc[k])
    assert lc["regression"] > 0
    assert _rel(gk, gc) < 1e-3
    assert nk == nc == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_operator_matches_plain(dtype):
    """The forward launch as the operator ``torch.ops.mammo_clip_tpu_torch.
    flash_forward``: its o against the plain version (fp32 1e-4, bf16 1e-2, the
    flash tolerances above), one counted launch a call, and its fake
    implementation's shapes and types equal to the real call's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from torch._subclasses.fake_tensor import FakeTensorMode

    from mammo_clip_tpu_torch.ops.flash_attention import launches as fa_launches
    from mammo_clip_tpu_torch.ops.flash_attention import plain_flash_attention

    dt = getattr(torch, dtype)
    q, k, v, _ = _qkv((2, 3, 77, 64), dt)
    before = fa_launches.counts["flash_attention.forward"]
    o, lse = torch.ops.mammo_clip_tpu_torch.flash_forward(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert fa_launches.counts["flash_attention.forward"] == before + 1
    assert _rel(o.float(), plain_flash_attention(q, k, v, 0.125).float()) < (
        1e-2 if dtype == "bfloat16" else 1e-4)
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        fo, flse = torch.ops.mammo_clip_tpu_torch.flash_forward(fq, fk, fv, 0.125)
    assert (fo.shape, fo.dtype, fo.device) == (o.shape, o.dtype, o.device)
    assert (flse.shape, flse.dtype, flse.device) == (lse.shape, lse.dtype, lse.device)
    assert fa_launches.counts["flash_attention.forward"] == before + 1


@pytest.mark.cuda
def test_cuda_vit_export_holds_the_flash_operator(tmp_path):
    """A tiny ViT CLIP exported on the card: both layers' attention are nodes of
    the flash operator in the image program (none in the text program), the
    manifest requires the module that registers it, and the loaded artifact
    launches the kernel (2 counted launches a call) and embeds as the eager
    model does (fp32, TF32 off: within 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import json

    from mammo_clip_tpu_torch.core.config import tiny_test_config
    from mammo_clip_tpu_torch.models import build_model
    from mammo_clip_tpu_torch.ops.flash_attention import launches as fa_launches
    from mammo_clip_tpu_torch.utils.device import full_fp32
    from mammo_clip_tpu_torch.utils.export import (
        ServingModule,
        export_clip_serving,
        package_operators,
    )

    cfg = tiny_test_config()
    cfg.model.image_encoder = {"name": "vit-tiny", "patch_size": 8, "hidden_size": 32,
                               "num_layers": 2, "num_heads": 2, "mlp_dim": 64, "base_grid": 4}
    model = build_model(cfg.model.to_dict(), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0)).eval()
    out = tmp_path / "serving"
    files = export_clip_serving(model, (64, 48), 16, batch=2, out_dir=str(out))
    program = torch.export.load(files["image_fn.cuda"])
    flash = [n for n in program.graph.nodes
             if "mammo_clip_tpu_torch.flash_forward" in str(n.target)]
    assert len(flash) == 2
    assert package_operators(program) == {"mammo_clip_tpu_torch::flash_forward"}
    assert package_operators(torch.export.load(files["text_fn.cuda"])) == set()
    manifest = json.loads((out / "serving.json").read_text())
    assert manifest["requires"] == {"cuda": ["mammo_clip_tpu_torch.ops.flash_attention"]}
    srv = ServingModule(str(out))
    x = torch.randn(2, 64, 48, 1, generator=torch.Generator().manual_seed(1)).cuda()
    before = fa_launches.counts["flash_attention.forward"]
    got = srv.embed_images(x)
    torch.cuda.synchronize()
    assert fa_launches.counts["flash_attention.forward"] == before + 2
    with torch.no_grad(), full_fp32():
        want = model.embed_image(x)
    assert _rel(got, want) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 5, 8, 64, 40), (4, 12, 7, 24, 36), (1, 2, 3, 1824, 8)])
def test_cuda_int8_dot_matches_the_cpu(shape):
    """``int8_dot`` and ``int8_conv1x1`` on the card against the CPU: the int8
    operands and the int32 product are exact on both (``torch._int_mm``, padded
    to its CUDA shape rules where M < 17 or K, N are not multiples of 8), so the
    fp32 output is equal up to 1 ulp; the straight-through gradients (bf16
    operands, fp32 sums) within 1e-5 of the largest (summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mammo_clip_tpu_torch.ops.quant import int8_conv1x1, int8_dot

    n, h, w, k, c = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(n, h, w, k, generator=g)
    wt = 0.05 * torch.randn(k, c, generator=g)
    go = torch.randn(n, h, w, c, generator=g)
    res = []
    for device in ("cuda", "cpu"):
        leaf = lambda t: t.to(device, copy=True).requires_grad_()
        xs, ws = leaf(x), leaf(wt)
        out = int8_dot(xs, ws, torch.float32)
        out.backward(go.to(device))
        xc = leaf(x.permute(0, 3, 1, 2).contiguous())
        kc = leaf(wt.t()[:, :, None, None].contiguous())
        outc = int8_conv1x1(xc, kc, torch.float32)
        outc.backward(go.permute(0, 3, 1, 2).to(device))
        res.append([t.detach().cpu() for t in (out, xs.grad, ws.grad, outc, xc.grad, kc.grad)])
    for name, a, b in zip(("out", "dx", "dw", "conv", "conv dx", "conv dk"), *res):
        tol = 1.2e-7 if name in ("out", "conv") else 1e-5
        assert _rel(a, b) <= tol, (name, _rel(a, b))
