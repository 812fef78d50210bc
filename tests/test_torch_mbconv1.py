"""The port's ``fused_mbconv_e1`` (ops/mbconv.py) against the JAX package's
``fused_mbconv_e1`` run in Pallas interpret mode, at the shapes of
tests/test_mbconv_pallas.py, from the same seeded numpy inputs.

On CPU tensors the port's wrapper runs its plain version; its CUDA kernels
(csrc/mbconv1.cu) are held to that plain version on a card by
tests/test_torch_cuda.py and chip_smoke.py. The kernel path's host-side
arithmetic between the passes (the BN2 stats from the per-image second
moments, the SE backward from the bilinear sums T1/T2, dK from the 27 tap sums)
is checked here too: ``_e1_forward``/``_e1_backward`` run with ``TorchPasses``,
a plain-torch stand-in for the six passes that returns the same reductions.

Tolerances are the JAX test's: forward out and stats 2e-5, the loss and every
gradient 1e-4 (fp32, other summation order), bf16 I/O rtol 0.1 / atol 0.15.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mammo_clip_tpu.ops import mbconv_pallas as jax_e1
from mammo_clip_tpu_torch.ops.mbconv import (
    MBConvParams,
    _e1_backward,
    _e1_forward,
    depthwise3x3,
    fused_mbconv_e1,
)

N, H, W = 2, 48, 12
EPS = 1e-3
# (C_in, C_out): the residual block of test_mbconv_pallas.py and its projecting one
SHAPES = {"residual": (8, 8), "projecting": (16, 8)}


def _numpy_case(c1, c2, seed):
    r = np.random.default_rng(seed)
    f = lambda *s: (r.standard_normal(s) * 0.5).astype(np.float32)
    sq = max(1, c1 // 4)
    p = dict(dw_kernel=f(c1, 3, 3), gamma1=1.0 + 0.1 * f(c1), beta1=0.1 * f(c1),
             se_w1=f(c1, sq), se_b1=0.1 * f(sq), se_w2=f(sq, c1), se_b2=0.1 * f(c1),
             wp=f(c1, c2), gamma2=1.0 + 0.1 * f(c2), beta2=0.1 * f(c2))
    x = r.standard_normal((N, c1, H, W)).astype(np.float32)
    w_out = r.standard_normal((N, c2, H, W)).astype(np.float32)
    delta = np.asarray([1.25, 0.0], np.float32)  # drop-connect: kept (scaled) + dropped
    return x, MBConvParams(**p), delta, w_out


@pytest.fixture(scope="module")
def jax_results():
    """JAX interpret-mode outputs, stats, loss and gradients, once per case."""
    out = {}
    for name, (c1, c2) in SHAPES.items():
        x, p, delta, w_out = _numpy_case(c1, c2, seed=len(out))
        jp = jax_e1.MBConvParams(*[jnp.asarray(t) for t in p])

        def loss(xx, pp):
            o, _ = jax_e1.fused_mbconv_e1(xx, pp, jnp.asarray(delta), EPS, True)
            return jnp.sum(o * jnp.asarray(w_out))

        o, stats = jax_e1.fused_mbconv_e1(jnp.asarray(x), jp, jnp.asarray(delta), EPS, True)
        lv, (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(x), jp)
        out[name] = dict(out=np.asarray(o), stats=[np.asarray(s) for s in stats],
                         loss=float(lv), dx=np.asarray(gx),
                         grads=[np.asarray(g) for g in gp])
    x, p, delta, _ = _numpy_case(*SHAPES["residual"], seed=0)
    jp = jax_e1.MBConvParams(*[jnp.asarray(t) for t in p])
    o, _ = jax_e1.fused_mbconv_e1(jnp.asarray(x).astype(jnp.bfloat16), jp,
                                  jnp.asarray(delta), EPS, True)
    out["bf16"] = np.asarray(o.astype(jnp.float32))
    return out


def _torch_case(name, seed):
    x, p, delta, w_out = _numpy_case(*SHAPES[name], seed)
    tp = MBConvParams(*[torch.tensor(t, requires_grad=True) for t in p])
    return torch.tensor(x, requires_grad=True), tp, torch.tensor(delta), torch.tensor(w_out)


@pytest.mark.parametrize("name,seed", [("residual", 0), ("projecting", 1)])
def test_forward_matches_jax(jax_results, name, seed):
    x, p, delta, _ = _torch_case(name, seed)
    out, stats = fused_mbconv_e1(x, p, delta, EPS)
    want = jax_results[name]
    assert out.shape == (N, SHAPES[name][1], H, W) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), want["out"], rtol=2e-5, atol=2e-5)
    assert len(stats) == 4
    for a, b in zip(stats, want["stats"]):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name,seed", [("residual", 0), ("projecting", 1)])
def test_gradients_match_jax(jax_results, name, seed):
    """The loss sum(out * w) and its gradient in x and in all 10 MBConvParams fields."""
    x, p, delta, w_out = _torch_case(name, seed)
    delta.requires_grad_(True)
    out, _ = fused_mbconv_e1(x, p, delta, EPS)
    loss = (out * w_out).sum()
    loss.backward()
    want = jax_results[name]
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), want["dx"], rtol=1e-4, atol=1e-4)
    for field, t, g in zip(MBConvParams._fields, p, want["grads"]):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-4, atol=1e-4, err_msg=field)
    assert delta.grad is None or not delta.grad.any()  # delta's gradient is zero


def test_bf16_io_matches_jax(jax_results):
    x, p, delta, _ = _torch_case("residual", 0)
    out, _ = fused_mbconv_e1(x.detach().to(torch.bfloat16), p, delta, EPS)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().detach().numpy(), jax_results["bf16"], rtol=0.1,
                               atol=0.15)


def test_height_not_multiple_of_8_raises_in_both():
    x, p, delta, _ = _numpy_case(8, 8, seed=0)
    x = x[:, :, :44]
    with pytest.raises(ValueError):
        jax_e1.fused_mbconv_e1(jnp.asarray(x), jax_e1.MBConvParams(*map(jnp.asarray, p)),
                               jnp.asarray(delta), EPS, True)
    with pytest.raises(ValueError):
        fused_mbconv_e1(torch.tensor(x), MBConvParams(*map(torch.tensor, p)),
                        torch.tensor(delta), EPS)


class TorchPasses:
    """Plain-torch stand-in for ``ops.mbconv.E1Passes``: each pass's reductions
    computed from whole fp32 tensors, in the layout the kernels return."""

    def __init__(self, x, c2):
        self.x, self.c2 = x.float(), c2
        self.dtype = x.dtype
        self.C = x.shape[1]

    def _v(self, k9, m1, a1, b1):
        d = depthwise3x3(self.x, k9.reshape(self.C, 3, 3))
        dhat = (d - m1[:, None, None]) * a1[:, None, None] + b1[:, None, None]
        return d, dhat, F.silu(dhat)

    def _dy(self, g, k9, m1, a1, b1, gate, wp, m2, inv2, k2, alpha, beta_r, delta):
        d, dhat, v = self._v(k9, m1, a1, b1)
        u = v * gate[:, :, None, None]
        ybar = (torch.einsum("nchw,cd->ndhw", u, wp) - m2[:, None, None]) * inv2[:, None, None]
        dyh = g.float() * delta[:, None, None, None]
        dy = k2[:, None, None] * dyh - alpha[:, None, None] - ybar * beta_r[:, None, None]
        return d, dhat, u, dy

    def _dd_hat(self, g, k9, m1, inv1, a1, b1, gate, wp, m2, inv2, k2, alpha, beta_r, ds_hw,
                delta):
        d, dhat, u, dy = self._dy(g, k9, m1, a1, b1, gate, wp, m2, inv2, k2, alpha, beta_r,
                                  delta)
        du = torch.einsum("ndhw,cd->nchw", dy, wp)
        s = torch.sigmoid(dhat)
        ddh = (du * gate[:, :, None, None] + ds_hw[:, :, None, None]) * s * (1 + dhat * (1 - s))
        dbar = (d - m1[:, None, None]) * inv1[:, None, None]
        return u, dy, ddh, dbar

    def p1(self, k9):
        d = depthwise3x3(self.x, k9.reshape(self.C, 3, 3))
        return torch.cat([d.sum((0, 2, 3)), (d * d).sum((0, 2, 3))])

    def p2(self, k9, m1, a1, b1):
        _, _, v = self._v(k9, m1, a1, b1)
        m = torch.einsum("nchw,nehw->nce", v, v).flatten(1)
        return torch.cat([v.sum((2, 3)), m], 1)

    def p3(self, k9, m1, a1, b1, gate, wp, m2, a2, b2, delta):
        _, _, v = self._v(k9, m1, a1, b1)
        y = torch.einsum("nchw,cd->ndhw", v * gate[:, :, None, None], wp)
        out = delta[:, None, None, None] * ((y - m2[:, None, None]) * a2[:, None, None]
                                            + b2[:, None, None])
        if self.c2 == self.C:
            out = out + self.x
        return out.to(self.dtype)

    def b1(self, g, k9, m1, a1, b1, gate, wp, m2, inv2, delta):
        _, _, v = self._v(k9, m1, a1, b1)
        y = torch.einsum("nchw,cd->ndhw", v * gate[:, :, None, None], wp)
        ybar = (y - m2[:, None, None]) * inv2[:, None, None]
        dyh = g.float() * delta[:, None, None, None]
        tn = torch.cat([dyh.sum((2, 3)), (dyh * ybar).sum((2, 3)),
                        torch.einsum("nchw,ndhw->ncd", v, dyh).flatten(1),
                        torch.einsum("nchw,ndhw->ncd", v, ybar).flatten(1)], 1)
        return tn, tn.sum(0)

    def b2(self, g, k9, m1, inv1, a1, b1, gate, wp, m2, inv2, k2, alpha, beta_r, ds_hw, delta):
        u, dy, ddh, dbar = self._dd_hat(g, k9, m1, inv1, a1, b1, gate, wp, m2, inv2, k2, alpha,
                                        beta_r, ds_hw, delta)
        H, W = self.x.shape[2:]
        xp = F.pad(self.x, (1, 1, 1, 1))
        taps = []
        for a in range(3):
            for b in range(3):
                xs = xp[:, :, a:a + H, b:b + W]
                taps.append(torch.stack([xs.sum((0, 2, 3)), (xs * dbar).sum((0, 2, 3)),
                                         (xs * ddh).sum((0, 2, 3))], 1))
        return torch.cat([ddh.sum((0, 2, 3)), (ddh * dbar).sum((0, 2, 3)),
                          torch.einsum("nchw,ndhw->cd", u, dy).flatten(),
                          torch.stack(taps, 1).flatten()])

    def b3(self, g, k9, m1, inv1, a1, b1, gate, wp, m2, inv2, k2, alpha, beta_r, ds_hw, r1a,
           r1b, delta):
        _, _, ddh, dbar = self._dd_hat(g, k9, m1, inv1, a1, b1, gate, wp, m2, inv2, k2, alpha,
                                       beta_r, ds_hw, delta)
        dd = a1[:, None, None] * ddh - r1a[:, None, None] - dbar * r1b[:, None, None]
        dx = depthwise3x3(dd, k9.reshape(self.C, 3, 3).flip(1, 2))
        if self.c2 == self.C:
            dx = dx + g.float()
        return dx.to(self.dtype)


@pytest.mark.parametrize("name,seed", [("residual", 0), ("projecting", 1)])
def test_kernel_path_host_arithmetic_matches_jax(jax_results, name, seed):
    """``_e1_forward``/``_e1_backward`` (the kernel path's sequencing and
    host-side math) over TorchPasses equal JAX's outputs, stats and gradients."""
    x, p, delta, w_out = _torch_case(name, seed)
    x, p = x.detach(), MBConvParams(*[t.detach() for t in p])
    k = TorchPasses(x, SHAPES[name][1])
    out, stats, (s_mean, gate) = _e1_forward(k, x, p, delta, EPS)
    dx, grads = _e1_backward(k, x, p, delta, stats, s_mean, gate, w_out, EPS)
    want = jax_results[name]
    np.testing.assert_allclose(out.numpy(), want["out"], rtol=2e-5, atol=2e-5)
    for a, b in zip(stats, want["stats"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dx.numpy(), want["dx"], rtol=1e-4, atol=1e-4)
    for field, a, b in zip(MBConvParams._fields, grads, want["grads"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4, err_msg=field)
