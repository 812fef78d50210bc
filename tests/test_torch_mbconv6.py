"""The port's fused MBConv block (mammo_clip_tpu_torch/ops/mbconv6.py) against
the JAX package's Pallas kernel (interpret mode) and its unfused reference.

On the CPU the port's ``fused_mbconv_e6`` runs its plain PyTorch version; the
CUDA kernels it launches on a card are held to that plain version by
``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.
Inputs are made with numpy from a seed and handed to both packages.

Tolerances (fp32): forward and stats 1e-4, because both sides run the same
fp32 math with different summation orders (the Pallas kernel sums per row tile
and derives bn0's statistics analytically from x's moments). Gradients 1e-3
relative to the largest entry of each tensor, because the Pallas backward
reassociates long sums (dWe from the moments, the SE cotangent through the
bilinear T1/T2 expansion) and BatchNorm backward subtracts nearly equal terms.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mammo_clip_tpu.ops.mbconv6_pallas import MBConv6Params as JaxP6
from mammo_clip_tpu.ops.mbconv6_pallas import fused_mbconv_e6 as jax_fused
from mammo_clip_tpu.ops.mbconv6_pallas import mbconv_e6_reference as jax_ref6
from mammo_clip_tpu.ops.mbconv_pallas import MBConvParams as JaxP1
from mammo_clip_tpu.ops.mbconv_pallas import mbconv_e1_reference as jax_ref1
from mammo_clip_tpu_torch.ops import mbconv6
from mammo_clip_tpu_torch.ops.mbconv import MBConvParams
from mammo_clip_tpu_torch.ops.mbconv6 import (
    MBConv6Params,
    fused_mbconv_e6,
    pick_h_pad,
    pick_w_pad,
    plain_fused_mbconv_e6,
)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel
    processes, and torch's default of one thread per core in each oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


N, C, H, W = 2, 8, 44, 12  # H and W off the pad multiple: exercises pad + mask
HPAD, WPAD = 48, 16
EPS = 1e-3
CASES = [("e6", C), ("e6", 6), ("e1", C), ("e1", 6)]  # 6 != C: projecting, no residual


def _np_case(form, c2, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s: (r.standard_normal(s) * 0.5).astype(np.float32)
    e = 4 * C if form == "e6" else C
    sq = max(1, C // 4)
    p = dict(dw_kernel=f(e, 3, 3), gamma1=1 + 0.1 * f(e), beta1=0.1 * f(e),
             se_w1=f(e, sq), se_b1=0.1 * f(sq), se_w2=f(sq, e), se_b2=0.1 * f(e),
             wp=0.5 * f(e, c2), gamma2=1 + 0.1 * f(c2), beta2=0.1 * f(c2))
    if form == "e6":
        p.update(we=0.5 * f(C, e), gamma0=1 + 0.1 * f(e), beta0=0.1 * f(e))
    x = r.standard_normal((N, C, H, W)).astype(np.float32)
    delta = np.asarray([1.25, 0.0], np.float32)  # kept (scaled) + dropped
    w_out = r.standard_normal((N, c2, H, W)).astype(np.float32)
    return p, x, delta, w_out


def _jax_params(form, p):
    cls = JaxP6 if form == "e6" else JaxP1
    return cls(**{k: jnp.asarray(p[k]) for k in cls._fields})


def _torch_params(form, p, requires_grad=False):
    cls = MBConv6Params if form == "e6" else MBConvParams
    return cls(**{k: torch.tensor(p[k], requires_grad=requires_grad) for k in cls._fields})


def _pad_np(x):
    return np.pad(x, ((0, 0), (0, 0), (0, HPAD - H), (0, WPAD - W)))


@functools.lru_cache(maxsize=None)
def _jax_results(form, c2):
    """Forward (kernel and reference) and the kernel's gradients, as numpy."""
    p, x, delta, w_out = _np_case(form, c2)
    jp, jd = _jax_params(form, p), jnp.asarray(delta)
    ref = jax_ref6 if form == "e6" else jax_ref1
    out_k, stats_k = jax_fused(jnp.asarray(_pad_np(x)), jp, jd, H, W, EPS, True)
    out_r, stats_r = ref(jnp.asarray(x), jp, jd)

    def loss(x_, p_):
        o, _ = jax_fused(jnp.pad(x_, ((0, 0), (0, 0), (0, HPAD - H), (0, WPAD - W))),
                         p_, jd, H, W, EPS, True)
        return jnp.sum(o[:, :, :H, :W] * jnp.asarray(w_out))

    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jp)
    np_ = lambda t: np.asarray(t)
    return dict(out_k=np_(out_k), stats_k=[np_(s) for s in stats_k], out_r=np_(out_r),
                stats_r=[np_(s) for s in stats_r], gx=np_(gx),
                gp={k: np_(getattr(gp, k)) for k in gp._fields})


def _close_rel(a, b, tol, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
    assert err < tol, (name, err)


@pytest.mark.parametrize("form,c2", CASES)
def test_forward_and_stats_match_jax(form, c2):
    p, x, delta, _ = _np_case(form, c2)
    out, stats = fused_mbconv_e6(torch.from_numpy(_pad_np(x)), _torch_params(form, p),
                                 torch.from_numpy(delta), H, W, EPS)
    j = _jax_results(form, c2)
    assert out.shape == (N, c2, HPAD, WPAD) and len(stats) == (6 if form == "e6" else 4)
    out = out.numpy()
    np.testing.assert_allclose(out[:, :, :H, :W], j["out_k"][:, :, :H, :W], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out[:, :, :H, :W], j["out_r"], rtol=1e-4, atol=1e-4)
    assert np.abs(out[:, :, H:]).max() == 0.0 and np.abs(out[:, :, :, W:]).max() == 0.0
    for a, bk, br in zip(stats, j["stats_k"], j["stats_r"]):
        np.testing.assert_allclose(a.numpy(), bk, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a.numpy(), br, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("form,c2", CASES)
def test_gradients_match_jax_kernel(form, c2):
    p, x, delta, w_out = _np_case(form, c2)
    xt = torch.tensor(x, requires_grad=True)
    tp = _torch_params(form, p, requires_grad=True)
    out, _ = fused_mbconv_e6(torch.nn.functional.pad(xt, (0, WPAD - W, 0, HPAD - H)), tp,
                             torch.from_numpy(delta), H, W, EPS)
    (out[:, :, :H, :W] * torch.from_numpy(w_out)).sum().backward()
    j = _jax_results(form, c2)
    _close_rel(xt.grad.numpy(), j["gx"], 1e-3, "x")
    for name in type(tp)._fields:
        _close_rel(getattr(tp, name).grad.numpy(), j["gp"][name], 1e-3, name)


def test_bf16_io_within_bf16_of_fp32_reference():
    """bf16 in and out (the smoke's and the model's working type) stays within
    the JAX package's own bf16 bound of the fp32 reference."""
    p, x, delta, _ = _np_case("e6", C)
    out, _ = fused_mbconv_e6(torch.from_numpy(_pad_np(x)).to(torch.bfloat16),
                             _torch_params("e6", p), torch.from_numpy(delta), H, W, EPS)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out[:, :, :H, :W].float().numpy(), _jax_results("e6", C)["out_r"],
                               rtol=0.1, atol=0.2)


def test_cpu_tensor_takes_plain_version_without_launch():
    p, x, delta, _ = _np_case("e1", C)
    before = dict(mbconv6.launches.counts)
    a, _ = fused_mbconv_e6(torch.from_numpy(_pad_np(x)), _torch_params("e1", p),
                           torch.from_numpy(delta), H, W, EPS)
    b, _ = plain_fused_mbconv_e6(torch.from_numpy(_pad_np(x)), _torch_params("e1", p),
                                 torch.from_numpy(delta), H, W, EPS)
    assert torch.equal(a, b)
    assert mbconv6.launches.counts == before


def test_other_devices_raise():
    p, _, _, _ = _np_case("e1", C)
    x = torch.empty((N, C, HPAD, WPAD), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_mbconv_e6(x, _torch_params("e1", p), torch.ones(N), H, W, EPS)


def test_padding_keeps_the_valid_region_and_aligns():
    assert (pick_h_pad(380), pick_w_pad(228)) == (384, 232)
    assert (pick_h_pad(760), pick_w_pad(456)) == (760, 456)
    assert pick_h_pad(1) == 8 and pick_w_pad(9) == 16


# ----------------------------------------------------------------------------
# the expanding form's analytic combinations (ops/mbconv6.py), in float64
# ----------------------------------------------------------------------------


def _chain64(seed=1, n=2, c=5, e=12, c2=5, h=9, w=7):
    """The expanding block's reference math in float64 with its intermediates
    kept (the body of mbconv_e6_reference, opened up), and the cotangent of a
    random linear loss: x, params, the intermediates and their gradients."""
    from mammo_clip_tpu_torch.ops.mbconv import _bn, _se_gate, batch_stats, depthwise3x3

    r = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(r.standard_normal(s) * 0.5, dtype=torch.float64,
                                requires_grad=True)
    sq = 2
    p = MBConv6Params(we=f(c, e), gamma0=f(e), beta0=f(e), dw_kernel=f(e, 3, 3), gamma1=f(e),
                      beta1=f(e), se_w1=f(e, sq), se_b1=f(sq), se_w2=f(sq, e), se_b2=f(e),
                      wp=f(e, c2), gamma2=f(c2), beta2=f(c2))
    x = f(n, c, h, w)
    delta = torch.tensor([1.25, 0.5], dtype=torch.float64)
    z = torch.einsum("nchw,ce->nehw", x, p.we)
    mean0, var0 = batch_stats(z)
    zhat0 = _bn(z, mean0, var0, p.gamma0, p.beta0, EPS)
    zhat0.retain_grad()
    d = depthwise3x3(torch.nn.functional.silu(zhat0), p.dw_kernel)
    mean1, var1 = batch_stats(d)
    dhat = _bn(d, mean1, var1, p.gamma1, p.beta1, EPS)
    dhat.retain_grad()
    v = torch.nn.functional.silu(dhat)
    s_mean = v.mean(dim=(2, 3))
    s_mean.retain_grad()
    gate, _ = _se_gate(s_mean, p)
    gate.retain_grad()
    u = v * gate[:, :, None, None]
    u.retain_grad()
    y = torch.einsum("nehw,ec->nchw", u, p.wp)
    mean2, var2 = batch_stats(y)
    out = delta[:, None, None, None] * _bn(y, mean2, var2, p.gamma2, p.beta2, EPS) + x
    g = torch.tensor(r.standard_normal(out.shape), dtype=torch.float64)
    (out * g).sum().backward()
    return dict(x=x, p=p, g=g, z=z, mean0=mean0, var0=var0, zhat0=zhat0, d=d, mean1=mean1,
                var1=var1, dhat=dhat, v=v, s_mean=s_mean, gate=gate, u=u, delta=delta)


def test_bn0_stats_from_x_moments_match_batch_stats():
    """bn0's statistics from x's first two moments equal batch_stats of z = x We."""
    from mammo_clip_tpu_torch.ops.mbconv import batch_stats

    k = _chain64()
    x, we = k["x"].detach(), k["p"].we.detach()
    sx, sxx = x.sum(dim=(0, 2, 3)), torch.einsum("nchw,ndhw->cd", x, x)
    mean0, var0 = mbconv6.bn0_stats(sx, sxx, we, x.shape[0] * x.shape[2] * x.shape[3])
    ref_mean, ref_var = batch_stats(torch.einsum("nchw,ce->nehw", x, we))
    np.testing.assert_allclose(mean0.numpy(), ref_mean.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(var0.numpy(), ref_var.numpy(), rtol=1e-10, atol=1e-12)


def test_dwe_and_dx_from_t3_and_moments_match_autograd():
    """dWe from T3 = sum x (x) gamma0 inv0 dz0hat and x's moments, and the chain
    part of dx from dxa = (gamma0 inv0 dz0hat) We^T, M and k, equal autograd's
    dWe and dx (less the residual) of the reference, in float64."""
    k = _chain64()
    x, p = k["x"].detach(), k["p"]
    cnt = x.shape[0] * x.shape[2] * x.shape[3]
    inv0 = torch.rsqrt(k["var0"].detach() + EPS)
    mean0, gamma0 = k["mean0"].detach(), p.gamma0.detach()
    dz0hat = k["zhat0"].grad
    zbar0 = (k["z"].detach() - mean0[None, :, None, None]) * inv0[None, :, None, None]
    t = gamma0[None, :, None, None] * inv0[None, :, None, None] * dz0hat
    alpha0 = gamma0 * inv0 * dz0hat.sum(dim=(0, 2, 3)) / cnt
    beta0r = gamma0 * inv0 * (dz0hat * zbar0).sum(dim=(0, 2, 3)) / cnt
    t3 = torch.einsum("nchw,nehw->ce", x, t)
    sx, sxx = x.sum(dim=(0, 2, 3)), torch.einsum("nchw,ndhw->cd", x, x)
    we = p.we.detach()
    dwe = mbconv6.dwe_from_moments(t3, sx, sxx, we, mean0, inv0, alpha0, beta0r)
    np.testing.assert_allclose(dwe.numpy(), p.we.grad.numpy(), rtol=1e-9, atol=1e-10)
    m, kv = mbconv6.dx_terms(we, mean0, inv0, alpha0, beta0r)
    dxa = torch.einsum("nehw,ce->nchw", t, we)
    dx = dxa - torch.einsum("ndhw,dc->nchw", x, m) + kv[None, :, None, None]
    np.testing.assert_allclose(dx.numpy(), (k["x"].grad - k["g"]).numpy(), rtol=1e-9,
                               atol=1e-10)


def test_bn1_backward_sums_from_the_sweep_sums_match_autograd():
    """bn1's backward sums from the backward sweep's per-image sums and the SE
    cotangent, and the SE cotangent sum v du itself, equal autograd's."""
    k = _chain64()
    hw = k["x"].shape[2] * k["x"].shape[3]
    d, dhat, v = k["d"].detach(), k["dhat"].detach(), k["v"].detach()
    du = k["u"].grad
    sg = torch.sigmoid(dhat)
    sp = sg * (1 + dhat * (1 - sg))
    dbar = (d - k["mean1"].detach()[None, :, None, None]) * torch.rsqrt(
        k["var1"].detach() + EPS)[None, :, None, None]
    s = lambda a: a.sum(dim=(2, 3))
    q = torch.stack([s(v * du), s(du * sp), s(sp), s(du * sp * dbar), s(sp * dbar)], dim=1)
    np.testing.assert_allclose(q[:, 0].numpy(), k["gate"].grad.numpy(), rtol=1e-10, atol=1e-12)
    gate = k["gate"].detach()
    # ds_mean's cotangent through the SE MLP alone: the gate's gradient path
    ds = torch.autograd.grad(mbconv6._se_gate(k["s_mean"], k["p"])[0], k["s_mean"],
                             k["gate"].grad)[0]
    sdb, sdbd = mbconv6.bn1_backward_sums(q, gate, ds / hw)
    db1h = k["dhat"].grad
    np.testing.assert_allclose(sdb.detach().numpy(), db1h.sum(dim=(0, 2, 3)).numpy(),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(sdbd.detach().numpy(), (db1h * dbar).sum(dim=(0, 2, 3)).numpy(),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("src,prefix", [("mbconv6_e6.cu", "m6_")])
def test_mbconv6_launcher_signatures_match_the_c_interface(src, prefix):
    """Each C launcher of the fused block's source takes as many arguments as
    its ctypes signature declares; m6_pass takes the device index and the
    stream last, for cuda_lib.launcher."""
    import re

    from mammo_clip_tpu_torch.ops import cuda_lib

    text = (cuda_lib.CSRC_DIR / src).read_text()
    protos = dict(re.findall(rf"^int ({prefix}\w+)\(([^)]*)\)", text, re.M))
    assert set(protos) == {k for k in cuda_lib.SIGNATURES if k.startswith(prefix)}
    for name, params in protos.items():
        params = [q.strip() for q in params.split(",") if q.strip()]
        assert len(params) == len(cuda_lib.SIGNATURES[name]), name
    if prefix == "m6_":
        last = [" ".join(q.split()) for q in protos["m6_pass"].split(",")][-2:]
        assert last == ["int device", "void* stream"]
        assert len(mbconv6._PTRS) == 34 == cuda_lib.SIGNATURES["m6_pass"].count(
            cuda_lib.ctypes.c_void_p) - 1


# ----------------------------------------------------------------------------
# the e=1 form's analytic pieces (ops/mbconv6.py), in float64
# ----------------------------------------------------------------------------


def _e1_chain64(seed=2, n=2, c=5, c2=4, h=9, w=7):
    """The e=1 block's reference math in float64 with d, v, the gate and u kept,
    and the cotangent of a random linear loss, the residual included (c2 == c
    adds it)."""
    from mammo_clip_tpu_torch.ops.mbconv import _bn, _se_gate, batch_stats, depthwise3x3

    r = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(r.standard_normal(s) * 0.5, dtype=torch.float64,
                                requires_grad=True)
    p = MBConvParams(dw_kernel=f(c, 3, 3), gamma1=f(c), beta1=f(c), se_w1=f(c, 2), se_b1=f(2),
                     se_w2=f(2, c), se_b2=f(c), wp=f(c, c2), gamma2=f(c2), beta2=f(c2))
    x = f(n, c, h, w)
    d = depthwise3x3(x, p.dw_kernel)
    d.retain_grad()
    mean1, var1 = batch_stats(d)
    v = torch.nn.functional.silu(_bn(d, mean1, var1, p.gamma1, p.beta1, EPS))
    gate, _ = _se_gate(v.mean(dim=(2, 3)), p)
    gate.retain_grad()
    u = v * gate[:, :, None, None]
    u.retain_grad()
    y = torch.einsum("nehw,ec->nchw", u, p.wp)
    mean2, var2 = batch_stats(y)
    out = torch.tensor([1.25, 0.5], dtype=torch.float64)[:, None, None, None] * _bn(
        y, mean2, var2, p.gamma2, p.beta2, EPS)
    if c2 == c:
        out = out + x
    g = torch.tensor(r.standard_normal(out.shape), dtype=torch.float64)
    (out * g).sum().backward()
    return dict(x=x, p=p, g=g, d=d, v=v, gate=gate, u=u)


def test_se_cotangent_is_the_per_image_sum_of_v_du():
    """The SE cotangent that bwd_v sums on the card, sum over positions of v du,
    equals autograd's gradient of the gate, in float64."""
    k = _e1_chain64()
    ds = mbconv6.se_cotangent(k["v"].detach(), k["u"].grad)
    np.testing.assert_allclose(ds.numpy(), k["gate"].grad.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("c2", [5, 4])  # 5 == C: with the residual; 4: without
def test_e1_dx_and_taps_from_dd_match_autograd(c2):
    """The e=1 form's dx from dd (the stencil's transpose, plus dout with the
    residual) and the 9 dK tap sums equal autograd's dx and dw_kernel gradient
    of the reference, in float64."""
    k = _e1_chain64(c2=c2)
    dd, x = k["d"].grad, k["x"].detach()
    dx = mbconv6.dx_from_dd(dd, k["p"].dw_kernel.detach(), k["g"] if c2 == 5 else None)
    np.testing.assert_allclose(dx.numpy(), k["x"].grad.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(mbconv6.dk_taps(dd, x).numpy(), k["p"].dw_kernel.grad.numpy(),
                               rtol=1e-10, atol=1e-12)


def _block_params(a):
    """Parameters of the fused form of block args ``a`` (zeros, CPU, fp32)."""
    z = lambda *s: torch.zeros(s)
    c, e, c2, sq = a.in_filters, a.expanded, a.out_filters, max(1, int(a.in_filters * a.se_ratio))
    common = dict(dw_kernel=z(e, 3, 3), gamma1=z(e), beta1=z(e), se_w1=z(e, sq), se_b1=z(sq),
                  se_w2=z(sq, e), se_b2=z(e), wp=z(e, c2), gamma2=z(c2), beta2=z(c2))
    if a.expand_ratio == 1:
        return MBConvParams(**common)
    return MBConv6Params(we=z(c, e), gamma0=z(e), beta0=z(e), **common)


@pytest.mark.parametrize("variant", [f"b{i}" for i in range(8)])
def test_validate_takes_every_block_the_model_routes(variant):
    """Every block that EfficientNet.fused_ok sends to fused_mbconv_e6, in both
    forms (the e=1 blocks of b6 and b7 have C 56 and 64), is within the
    kernels' limits as _validate states them; a block just past the e=1 limit
    is refused. _validate reads no kernel library."""
    from types import SimpleNamespace

    from mammo_clip_tpu_torch.models.efficientnet import EfficientNet, scaled_block_args

    model = SimpleNamespace(fused_mbconv=True)
    routed = [a for a in scaled_block_args(variant) if EfficientNet.fused_ok(model, a)]
    assert any(a.expand_ratio == 1 for a in routed)
    for a in routed:
        x = torch.zeros(2, a.in_filters, 16, 16)
        mbconv6._validate(x, _block_params(a), torch.ones(2), 11, 13)
    wide = SimpleNamespace(in_filters=mbconv6.E1_MAX_C + 1, out_filters=32, expand_ratio=1,
                           expanded=mbconv6.E1_MAX_C + 1, se_ratio=0.25)
    with pytest.raises(ValueError, match="e=1 form"):
        mbconv6._validate(torch.zeros(2, wide.in_filters, 16, 16), _block_params(wide),
                          torch.ones(2), 11, 13)
