"""The port's flash attention (mammo_clip_tpu_torch/ops/flash_attention.py) and
its probe script against the JAX probe, benchmarks/probe_flash_attention.py.

The stock Pallas TPU kernel that the JAX probe calls runs here under
``pltpu.force_tpu_interpret_mode()``. At (1, 2, 128, 64) fp32 with 128-row
blocks the plain version (what a CPU tensor takes) matches it within 1e-5,
forward and the gradients of the probe's loss (same fp32 math, another
summation order); at the same shape in bf16, within 1e-2 of the largest
entries (the stock kernel's bf16 P and dS operands). The port's probe variants
match the JAX script's ``einsum_attention`` at a small bf16 shape within the
probe's own bound, 1e-2 on the loss.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mammo_clip_tpu_torch.benchmarks import probe_flash_attention as port_probe
from mammo_clip_tpu_torch.ops.flash_attention import (
    flash_attention,
    launches,
    plain_flash_attention,
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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_probe = _load("probe_flash_attention")


def _inputs(shape, dtype=np.float32, seed=0):
    r = np.random.default_rng(seed)
    return [(r.standard_normal(shape) * s).astype(dtype) for s in (0.3, 0.3, 0.3, 0.1)]


@pytest.fixture(scope="module")
def stock_kernel():
    """Loss sum(o * w), o and the gradients of the stock kernel in interpret mode."""
    q, k, v, w = _inputs((1, 2, 128, 64))

    def loss(q, k, v):
        o = jax_probe.flash_attention_bnsd(q, k, v, 128, 128)
        return jnp.sum(o * w), o

    with pltpu.force_tpu_interpret_mode():
        (l, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    return (q, k, v, w), float(l), np.asarray(o), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def stock_kernel_bf16():
    """The same loss on bf16 q, k, v (the probe's dtype): inputs as fp32 arrays of
    their bf16 values, o and the gradients of the stock kernel in interpret mode."""
    q, k, v, w = _inputs((1, 2, 128, 64))
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))

    def loss(q, k, v):
        o = jax_probe.flash_attention_bnsd(q, k, v, 128, 128)
        return jnp.sum(o.astype(jnp.float32) * w), o

    with pltpu.force_tpu_interpret_mode():
        (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(qb, kb, vb)
    as_f32 = lambda a: np.asarray(a.astype(jnp.float32))
    return [as_f32(a) for a in (qb, kb, vb)], w, as_f32(o), [as_f32(g) for g in grads]


def test_plain_matches_the_stock_pallas_kernel_in_bf16(stock_kernel_bf16):
    """At (1, 2, 128, 64) bf16 the stock kernel rounds its P and dS operands to
    bf16 before each product, and the plain version (fp32 scores, one rounding at
    the output) does not: output and gradients agree within 1e-2 of their largest
    entries (measured 5.9e-3 and 4.8e-3), the bound the card holds the bf16
    kernels to against the plain version."""
    (q, k, v), w, o, grads = stock_kernel_bf16
    tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_(True) for a in (q, k, v))
    out = plain_flash_attention(tq, tk, tv, 64 ** -0.5)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert out.dtype == torch.bfloat16
    for got, want in zip((out, tq.grad, tk.grad, tv.grad), (o, *grads)):
        assert got.dtype == torch.bfloat16
        assert np.abs(got.float().detach().numpy() - want).max() <= 1e-2 * np.abs(want).max()


def test_plain_matches_the_stock_pallas_kernel_forward_and_gradients(stock_kernel):
    (q, k, v, w), l, o, grads = stock_kernel
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = plain_flash_attention(tq, tk, tv, 64 ** -0.5)
    lt = (out * torch.from_numpy(w)).sum()
    lt.backward()
    np.testing.assert_allclose(out.detach().numpy(), o, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lt.item(), l, rtol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_wrapper_on_cpu_tensors_runs_the_plain_version_through_autograd(stock_kernel):
    (q, k, v, w), l, o, grads = stock_kernel
    before = dict(launches.counts)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, 64 ** -0.5)
    (out * torch.from_numpy(w)).sum().backward()
    assert launches.counts == before  # no kernel on the CPU
    np.testing.assert_allclose(out.detach().numpy(), o, rtol=0, atol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        flash_attention(tq[..., :32], tk, tv, 0.1)  # shapes differ
    with pytest.raises(ValueError):
        flash_attention(*[torch.zeros(1, 1, 4, 130)] * 3, 0.1)  # D > 128
    with pytest.raises(TypeError):
        flash_attention(tq, tk.double(), tv, 0.1)


def test_plain_in_bf16_rounds_once_at_the_output():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs((2, 2, 40, 32), seed=1))
    got = plain_flash_attention(*(t.bfloat16() for t in (q, k, v)), 32 ** -0.5)
    assert got.dtype == torch.bfloat16
    want = plain_flash_attention(*(t.bfloat16().float() for t in (q, k, v)), 32 ** -0.5)
    assert torch.equal(got, want.bfloat16())


@pytest.mark.parametrize("variant", ["einsum", "flash", "sdpa"])
def test_probe_variants_match_the_jax_einsum_attention_in_bf16(variant):
    """Each of the port's probe variants against the JAX script's
    ``einsum_attention`` (all-ones mask), at (B, S, N, D) = (2, 32, 2, 64) bf16:
    the loss sum(ctx * w) within the probe's bound 1e-2, and the outputs within
    a few bf16 roundings."""
    shape = (2, 32, 2, 64)  # D = 64: both scripts scale by their module's D
    q, k, v, w = (jnp.asarray(a, jnp.bfloat16) for a in _inputs(shape, np.float64))
    mask = jnp.ones(shape[:2], bool)

    def loss(q, k, v):
        ctx = jax_probe.einsum_attention(q, k, v, mask)
        return jnp.sum(ctx.astype(jnp.float32) * w.astype(jnp.float32)), ctx

    (l, ctx), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    fn = port_probe.build(variant, "cpu", shape)
    lt, tgrads = fn()
    assert abs(float(lt) - float(l)) / abs(float(l)) < 1e-2
    for got, want in zip(tgrads, grads):
        want = np.asarray(want.astype(jnp.float32))
        assert got.dtype == torch.bfloat16
        assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()
    tq, tk, tv, _ = port_probe.inputs("cpu", shape)
    if variant == "einsum":
        tctx = port_probe.einsum_attention(tq, tk, tv, torch.ones(shape[:2], dtype=torch.bool))
    else:
        tctx = port_probe._bnsd(variant, tq, tk, tv)
    ctx = np.asarray(ctx.astype(jnp.float32))
    assert np.abs(tctx.float().numpy() - ctx).max() <= 2e-2 * np.abs(ctx).max()


def test_probe_script_runs_on_the_cpu(capsys):
    res = port_probe.main(["--device", "cpu", "--iters", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == ["einsum", "flash", "sdpa", "loss", "einsum",
                                                   "flash", "sdpa"]
    assert res["rel"] < 1e-2 and set(res["ms"]) == {"einsum", "flash", "sdpa"}
    assert all(np.isfinite(res["loss"][v]) for v in res["loss"])


def test_flash_launcher_signatures_match_the_c_interface():
    """fa_forward and fa_backward take as many arguments as their ctypes
    signatures declare, the device index and the stream last, as
    ``cuda_lib.launcher`` passes them."""
    import re

    from mammo_clip_tpu_torch.ops import cuda_lib

    src = (cuda_lib.CSRC_DIR / "flash_attention.cu").read_text()
    protos = dict(re.findall(r"^int (fa_\w+)\(([^)]*)\)", src, re.M))
    assert set(protos) == {k for k in cuda_lib.SIGNATURES if k.startswith("fa_")}
    for name, params in protos.items():
        params = [" ".join(p.split()) for p in params.split(",")]
        assert len(params) == len(cuda_lib.SIGNATURES[name]), name
        assert params[-2:] == ["int device", "void* stream"], name
