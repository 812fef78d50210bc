"""The port's ``fused_mbconv_e1`` (ops/mbconv.py) against the JAX package's
``fused_mbconv_e1`` run in Pallas interpret mode, at the shapes of
tests/test_mbconv_pallas.py, from the same seeded numpy inputs.

On CPU tensors the port's wrapper runs its plain version. On a card it runs
the e=1 form of ``fused_mbconv_e6`` (the passes of csrc/mbconv6_e6.cu) over the
whole image, held to the plain version there by tests/test_torch_cuda.py and
chip_smoke.py; here that form's plain version over the whole image is held to
JAX's fused_mbconv_e1 too, and the card path's sequence of launches is checked
against a fake library.

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
from mammo_clip_tpu_torch.ops.mbconv import MBConvParams, fused_mbconv_e1
from mammo_clip_tpu_torch.ops.mbconv6 import plain_fused_mbconv_e6


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel
    processes, and torch's default of one thread per core in each oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


def _e1_form_plain(x, p, delta):
    """The e=1 form of fused_mbconv_e6's plain version over the whole image: the
    function fused_mbconv_e1's card path computes (valid_h = H, valid_w = W)."""
    return plain_fused_mbconv_e6(x, p, delta, x.shape[2], x.shape[3], EPS)


@pytest.mark.parametrize("name,seed", [("residual", 0), ("projecting", 1)])
def test_e1_form_over_the_whole_image_matches_jax(jax_results, name, seed):
    """The card path runs the e=1 form's passes of csrc/mbconv6_e6.cu with no pad
    region; that form's plain version equals JAX's fused_mbconv_e1: out, stats,
    the loss and its gradient in x and in all 10 MBConvParams fields."""
    x, p, delta, w_out = _torch_case(name, seed)
    out, stats = _e1_form_plain(x, p, delta)
    want = jax_results[name]
    np.testing.assert_allclose(out.detach().numpy(), want["out"], rtol=2e-5, atol=2e-5)
    for a, b in zip(stats, want["stats"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-5)
    loss = (out * w_out).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), want["dx"], rtol=1e-4, atol=1e-4)
    for field, t, g in zip(MBConvParams._fields, p, want["grads"]):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-4, atol=1e-4, err_msg=field)


@pytest.mark.parametrize("name", ["residual", "projecting"])
def test_card_path_launches_only_the_e1_forms_passes(monkeypatch, name):
    """fused_mbconv_e1's kernel path, driven here on CPU tensors against a fake
    library: every launch is an m6_pass call of the e=1 form (expand 0) over the
    full H x W, 4 in the forward and 3 in the backward, the calls count under
    mbconv1.* and not under mbconv6.*, and delta's gradient is zero."""
    from mammo_clip_tpu_torch.ops import cuda_lib, mbconv6
    from mammo_clip_tpu_torch.ops.mbconv import _FusedMBConvE1, launches

    passes, bound = [], []

    class Lib:
        def __getattr__(self, fn):
            bound.append(fn)
            return lambda *args: (passes.append(args), 0)[1]

    monkeypatch.setattr(cuda_lib, "load", Lib)
    monkeypatch.setattr(cuda_lib, "_raw_stream", None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda d: 0, raising=False)
    monkeypatch.setattr(mbconv6, "_m6_pass", cuda_lib.launcher("m6_pass"))
    monkeypatch.setattr(mbconv6, "_scratch_floats", lambda ints: 4096)
    x, p, delta, w_out = _torch_case(name, 0)
    c2 = SHAPES[name][1]
    before = dict(launches.counts)
    xr = x.detach().requires_grad_(True)
    dr = delta.clone().requires_grad_(True)
    out, *stats = _FusedMBConvE1.apply(xr, dr, EPS, None, *p)
    assert out.shape == (N, c2, H, W) and len(stats) == 4
    n_fwd = len(passes)
    out.backward(w_out)
    assert bound == ["m6_pass"]
    ids = [args[0] for args in passes]
    assert ids[:n_fwd] == [mbconv6.F2, mbconv6.F3, mbconv6.F4, mbconv6.OUT]
    assert ids[n_fwd:] == [mbconv6.B1, mbconv6.BWD_V, mbconv6.BWD_X]
    for args in passes:
        # pass, 34 pointers, eps, the form and its 9 shape ints, the ranks, the device,
        # the stream
        expand, bf16, n, c, e, cc2, h, w, vh, vw, ranks = args[36:47]
        assert (expand, bf16, n, c, e, cc2, h, w, vh, vw, ranks) == (
            0, 0, N, x.shape[1], x.shape[1], c2, H, W, H, W, 1)
    counts = {k: v - before[k] for k, v in launches.counts.items()}
    assert counts == {**dict.fromkeys(counts, 0), "mbconv1.forward": 1, "mbconv1.backward": 1}
    assert not dr.grad.any()
