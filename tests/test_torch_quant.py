"""The port's int8 1x1 convolutions (``ops/quant.py``) and the EfficientNet
options ``quant_int8_k5`` and ``s2d_exec`` against the JAX package, weights
carried over with ``convert/from_jax.py``, inputs from a numpy seed.

Tolerances, each with its reason:
- the int8 operands are equal, and so is the int32 product (exact on both
  sides); the dequantised output is ``acc * (sx * sw)`` in fp32 on both sides,
  so it is held to 1 ulp of fp32, and in bf16 to one bf16 step (the cast of
  equal fp32 values; XLA may fuse the multiply differently);
- the straight-through gradients are bf16 operands with fp32 sums on both
  sides: held to 1e-6 of the largest value (summation order);
- in a block, the project conv quantises an activation that conv and
  reduction round-off make differ by ~1e-7 between the two sides; a value
  within that of a .5 boundary flips by one int8 step. The flips are counted
  and must be under 0.1% of the values; outputs and running statistics are
  held by relative norm to 1e-5. The straight-through backward rounds the
  incoming gradient (and x) to bf16; where the two sides' fp32 values straddle
  a bf16 rounding boundary, that element moves by a bf16 step (2^-8 of it), so
  gradients (every tensor) are held to 1e-3 of the largest gradient, ten times
  the fp32 headroom of tests/test_torch_models.py;
- ``s2d_exec`` is held within JAX's own s2d-to-standard tolerances
  (``tests/test_s2d_exec.py``: loss rtol 1e-4, gradients relative norm 1e-4,
  running statistics rtol 1e-4 / atol 1e-6, eval pooled rtol 1e-5 / atol 1e-6).
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mammo_clip_tpu.models import load_image_encoder as jax_load_image_encoder
from mammo_clip_tpu.models.efficientnet import BlockArgs as JaxBlockArgs
from mammo_clip_tpu.models.efficientnet import MBConvBlock as JaxMBConvBlock
from mammo_clip_tpu.ops import quant as jax_quant
from mammo_clip_tpu_torch.convert.from_jax import load_jax_variables, state_dict_from_jax
from mammo_clip_tpu_torch.models import init_parameters, load_image_encoder
from mammo_clip_tpu_torch.models.efficientnet import BlockArgs, MBConvBlock
from mammo_clip_tpu_torch.ops import quant


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel processes, and
    torch's default of one thread per core in each oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _dot_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 5, 8, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 40)) * 0.05).astype(np.float32)
    g = rng.normal(size=(2, 5, 8, 40)).astype(np.float32)
    return x, w, g


DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_dot_forward_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    x, w, _ = _dot_inputs()
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    qx_j, sx_j = jax_quant._quantize_per_tensor(xj)
    qw_j, sw_j = jax_quant._quantize_per_column(wj)
    qx_t, sx_t = quant.quantize_per_tensor(xt)
    qw_t, sw_t = quant.quantize_per_column(wt)
    np.testing.assert_array_equal(qx_t.numpy(), np.asarray(qx_j))
    np.testing.assert_array_equal(qw_t.numpy(), np.asarray(qw_j))
    np.testing.assert_array_equal(sx_t.numpy(), np.asarray(sx_j))
    np.testing.assert_array_equal(sw_t.numpy(), np.asarray(sw_j))
    want = np.asarray(jax_quant.int8_dot(xj, wj, jdt).astype(jnp.float32))
    got = quant.int8_dot(xt, wt, tdt)
    assert got.dtype == tdt and got.shape == (2, 5, 8, 40)
    step = np.spacing(np.abs(want).astype(np.float32)) * (1 if dtype == "float32" else 2 ** 16)
    assert np.all(np.abs(got.float().numpy() - want) <= step)


def test_int8_dot_straight_through_gradients_match_jax():
    x, w, g = _dot_inputs(1)
    dx_j, dw_j = jax_quant._int8_dot_bwd(jnp.float32, (jnp.asarray(x), jnp.asarray(w)),
                                         jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    quant.int8_dot(xt, wt, torch.float32).backward(torch.from_numpy(g))
    for got, want in ((xt.grad, dx_j), (wt.grad, dw_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_int8_conv1x1_matches_jax_in_the_ports_layouts():
    """NCHW activation, OIHW kernel, against JAX's NHWC / HWIO function, forward
    and the straight-through gradients."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 5, 24)).astype(np.float32)
    k = (rng.normal(size=(1, 1, 24, 40)) * 0.1).astype(np.float32)
    g = rng.normal(size=(2, 6, 5, 40)).astype(np.float32)

    def f(x, k):
        return jnp.sum(jax_quant.int8_conv1x1(x, k, jnp.float32) * g)

    out_j = np.asarray(jax_quant.int8_conv1x1(jnp.asarray(x), jnp.asarray(k), jnp.float32))
    dx_j, dk_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    kt = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous().requires_grad_()
    out = quant.int8_conv1x1(xt, kt, torch.float32)
    assert out.is_contiguous() and out.shape == (2, 40, 6, 5)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), out_j, rtol=0,
                               atol=1e-6 * np.abs(out_j).max())
    out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    for got, want in ((xt.grad.permute(0, 2, 3, 1), dx_j), (kt.grad.permute(2, 3, 1, 0), dk_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("m,k,n", [(5, 3, 7), (16, 8, 8), (17, 12, 9), (40, 64, 24)])
def test_int_matmul_pads_to_the_cuda_shape_rules_exactly(m, k, n):
    """Zero-padding M to > 16 and K, N to multiples of 8 changes no sum."""
    rng = np.random.default_rng(m * k * n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    out = quant.int_matmul(a, b)
    assert out.dtype == torch.int32 and out.shape == (m, n)
    np.testing.assert_array_equal(out.numpy(), a.numpy().astype(np.int64) @ b.numpy())
    # the B5 k5 widths run through as they are: 1824 * 127^2 is past fp32's exact integers
    big = torch.full((17, 1824), 127, dtype=torch.int8)
    assert int(quant.int_matmul(big, big.t().contiguous()[:, :8])[0, 0]) == 1824 * 127 ** 2


# --------------------------------------------------------------------------- the block

BLOCK = (5, 1, 6, 32, 32, 0.25)  # tests/test_quant.py's quantised block


@functools.lru_cache(maxsize=None)
def _jax_block():
    """JAX's quantised k5 block: init, eval and train outputs with the project
    conv's input (the SE output) captured, the new batch stats and gradients."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    cot = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    blk = JaxMBConvBlock(JaxBlockArgs(*BLOCK), drop_rate=0.0, quant_int8=True)
    v = _np_tree(blk.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), False))
    res = {}
    for train in (False, True):
        out, mut = blk.apply(v, jnp.asarray(x), train, capture_intermediates=True,
                             mutable=["intermediates", "batch_stats"])
        res[train] = dict(out=np.asarray(out),
                          se=np.asarray(mut["intermediates"]["se"]["__call__"][0]),
                          stats=_np_tree(mut["batch_stats"]))

    def loss(params):
        out, _ = blk.apply({"params": params, "batch_stats": v["batch_stats"]},
                           jnp.asarray(x), True, mutable=["batch_stats"])
        return jnp.sum(out * cot)

    grads = _np_tree(jax.grad(loss)(v["params"]))
    return x, cot, v, res, grads


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_quantised_block_matches_jax(train):
    x, cot, v, res, grads = _jax_block()
    m = MBConvBlock(BlockArgs(*BLOCK), 0.0)
    load_jax_variables(m, v)
    captured = {}

    def keep_se(mod, inp, out):
        captured["se"] = out.detach()

    m.se.register_forward_hook(keep_se)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    out = m(xt, train, torch.ones(2), quant=True)
    want = res[train]
    se = captured["se"].permute(0, 2, 3, 1)
    flips = int((quant.quantize_per_tensor(se)[0].numpy()
                 != np.asarray(jax_quant._quantize_per_tensor(jnp.asarray(want["se"]))[0])).sum())
    print(f"{'train' if train else 'eval'}: {flips} of {se.numel()} quantised project-conv "
          f"inputs flipped by a step")
    assert flips <= 1e-3 * se.numel()
    assert _rel(out.detach().permute(0, 2, 3, 1).numpy(), want["out"]) < 1e-5
    if not train:
        return
    new = state_dict_from_jax({"batch_stats": want["stats"]})
    sd = m.state_dict()
    for key, value in new.items():
        assert _rel(sd[key].numpy(), value.numpy()) < 1e-5, key
    out.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
    ref = state_dict_from_jax({"params": grads})
    scale = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=0,
                                   atol=1e-3 * scale, err_msg=name)


def test_quantised_block_keeps_the_parameter_tree():
    """The same parameters as the standard block, and its int8 output within the
    JAX test's bound of the standard one (tests/test_quant.py: rel < 0.05)."""
    x, _, v, _, _ = _jax_block()
    m = MBConvBlock(BlockArgs(*BLOCK), 0.0)
    load_jax_variables(m, v)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        std = m(xt, False, torch.ones(2))
        q8 = m(xt, False, torch.ones(2), quant=True)
    assert 0 < _rel(q8.numpy(), std.numpy()) < 0.05


# --------------------------------------------------------------------------- the encoder

IMG = np.random.default_rng(7).standard_normal((2, 64, 48, 1)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_encoder(options):
    """b0 at 64x48 through JAX's load_image_encoder: init, and one train-mode
    value_and_grad with the pooled output, the new batch stats and, with
    ``quant_int8_k5``, every module's output (``capture_intermediates``)."""
    config = {"name": "efficientnet-b0", "drop_connect_rate": 0.0, **dict(options)}
    m = jax_load_image_encoder(config)
    v = _np_tree(jax.jit(lambda x: m.init({"params": jax.random.PRNGKey(0)}, x, False))(IMG))

    def loss(variables, x):
        out, mut = m.apply(variables, x, True, mutable=["batch_stats", "intermediates"],
                           rngs={"stochastic": jax.random.PRNGKey(3)},
                           capture_intermediates=config.get("quant_int8_k5", False))
        pooled = out["pooled"].astype(jnp.float32)
        return jnp.sum(pooled ** 2), (pooled, mut["batch_stats"], mut.get("intermediates", {}))

    (lv, (pooled, bs, inter)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(v, IMG)
    return (config, v, float(lv), np.asarray(pooled), _np_tree(bs), _np_tree(g["params"]),
            _np_tree(inter))


def _jax_layouts(config):
    """{block name: (s2d_nhwc, quant_int8)} as JAX's EfficientNet builds its
    blocks for IMG, read by intercepting each block call (no compile)."""
    m = jax_load_image_encoder(config)
    seen = {}

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, JaxMBConvBlock) and context.method_name == "__call__":
            seen[mod.name] = (mod.s2d_nhwc, mod.quant_int8)
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record):
        jax.eval_shape(lambda x: m.init({"params": jax.random.PRNGKey(0)}, x, False),
                       jnp.zeros(IMG.shape))
    return seen


def _port_layouts(m):
    """The port's (s2d_taken, quant_ok) per block for IMG (the stem halves it)."""
    h, w, out = -(-IMG.shape[1] // 2), -(-IMG.shape[2] // 2), {}
    for i, a in enumerate(m.block_args):
        out[f"block_{i}"] = (m.s2d_taken(a, h, w), m.quant_ok(a, h, w))
        h, w = -(-h // a.stride), -(-w // a.stride)
    return out


def _train_step_matches(options, loss_rtol, out_rel, grad_rel, stat_rtol, stat_atol):
    config, v, loss, pooled, bs, grads, inter = _jax_encoder(options)
    m = load_image_encoder(config)
    load_jax_variables(m, v)
    layouts = _port_layouts(m)
    assert layouts == _jax_layouts(config)
    # the quantised activations: each int8 block's input (its expand conv's,
    # where it has one) and its SE output (its project conv's)
    acts = {}
    for i, (_, q) in enumerate(layouts.values()):
        block = getattr(m, f"block_{i}")
        if q and hasattr(block, "bn0"):
            block.register_forward_hook(
                lambda mod, inp, o, i=i: acts.__setitem__((i, "in"), inp[0].detach()))
        if q:
            block.se.register_forward_hook(
                lambda mod, inp, o, i=i: acts.__setitem__((i, "se"), o.detach()))
    out = m(torch.from_numpy(IMG), train=True)
    flips = n_values = 0
    for (i, what), got in acts.items():
        src = inter[f"block_{i - 1}"] if what == "in" else inter[f"block_{i}"]["se"]
        want = jax_quant._quantize_per_tensor(jnp.asarray(src["__call__"][0]))[0]
        flips += int((quant.quantize_per_tensor(got.permute(0, 2, 3, 1))[0].numpy()
                      != np.asarray(want)).sum())
        n_values += got.numel()
    if acts:
        print(f"{len(acts)} quantised activations, {flips} of {n_values} values flipped by "
              f"an int8 step")
        assert flips <= 1e-3 * n_values
    lt = (out["pooled"].float() ** 2).sum()
    lt.backward()
    np.testing.assert_allclose(lt.item(), loss, rtol=loss_rtol)
    print(f"{dict(options)}: loss rel {abs(lt.item() - loss) / abs(loss):.2e}, pooled rel "
          f"{_rel(out['pooled'].detach().numpy(), pooled):.2e}")
    assert _rel(out["pooled"].detach().numpy(), pooled) < out_rel
    ref = state_dict_from_jax({"params": grads})
    names = [n for n, _ in m.named_parameters()]
    got = np.concatenate([dict(m.named_parameters())[n].grad.numpy().ravel() for n in names])
    want = np.concatenate([ref[n].numpy().ravel() for n in names])
    print(f"gradients rel {_rel(got, want):.2e}")
    assert _rel(got, want) < grad_rel
    new = state_dict_from_jax({"batch_stats": bs})
    sd = m.state_dict()
    for key, value in new.items():
        np.testing.assert_allclose(sd[key].numpy(), value.numpy(), rtol=stat_rtol,
                                   atol=stat_atol, err_msg=key)
    return m


def test_tiny_quant_int8_k5_encoder_train_step_matches_jax():
    """b0 with ``quant_int8_k5`` (its 9 k5 blocks int8) through
    ``load_image_encoder``, one train step. The quantised activations' flips are
    counted (one of ~130k values here, block 14's project input) and held under
    0.1%. The step is ill-conditioned at this size: a per-tensor int8 scale
    leaves a narrow channel a few levels, and train-mode BatchNorm over 8 values
    a channel (2 images of 2x2 in blocks 11-14) rescales that channel's
    quantisation steps to unit variance, so one flip moves outputs by a step of
    the normalised channel. On the CPU a 1e-6 relative change of the images
    moves the port's own pooled output by up to 18% and its gradients by up to
    71% (three draws: 0.7%, 71%, 71%); the fp32 encoder's by 1e-4. Against
    JAX with one flip the pooled output sits 2.4e-4 apart, the loss 1.1e-5,
    the gradients 7.5e-3. Held: pooled 1e-2 (relative norm), loss rtol 1e-3,
    gradients 5e-2 (relative norm of the whole), running statistics rtol 1e-3 /
    atol 1e-5. The block test holds the same code tightly where BatchNorm
    averages 512 values, and the s2d test below the int8 encoder's eval output
    to 1e-4."""
    m = _train_step_matches((("quant_int8_k5", True),), 1e-3, 1e-2, 5e-2, 1e-3, 1e-5)
    assert [i for i, a in enumerate(m.block_args) if a.kernel == 5] == [3, 4, 8, 9, 10, 11, 12,
                                                                        13, 14]


def test_s2d_exec_encoder_matches_jax_s2d_network():
    """JAX's b0 with ``s2d_exec`` at 64x48 (blocks 0, 1, 3 and 5 over
    space-to-depth tensors there) against the port's with the same flag (the
    NCHW path), one train step: pooled output, loss, gradients and running
    statistics within JAX's own s2d-to-standard tolerances."""
    m = _train_step_matches((("s2d_exec", True),), 1e-4, 1e-4, 1e-4, 1e-4, 1e-6)
    assert [i for i, (s2d, _) in enumerate(_port_layouts(m).values()) if s2d] == [0, 1, 3, 5]


def test_s2d_exec_leaves_the_blocks_it_takes_unquantised_as_jax_does():
    """With both options JAX quantises only the k5 blocks off the space-to-depth
    layout: block 3 (stride 2, an even 16x12 input) stays fp32. The port builds
    the same blocks, and its eval output agrees with JAX's (relative norm 1e-4,
    the int8 flips' headroom); quantising block 3 too would move it by ~1e-2."""
    config = {"name": "efficientnet-b0", "drop_connect_rate": 0.0, "quant_int8_k5": True,
              "s2d_exec": True}
    layouts = _jax_layouts(config)
    assert [n for n, (_, q) in layouts.items() if q] == [f"block_{i}" for i in (4, 8, 9, 10,
                                                                                 11, 12, 13, 14)]
    v = _jax_encoder((("quant_int8_k5", True),))[1]  # the same tree, already compiled
    jm = jax_load_image_encoder(config)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False))(v, IMG)["pooled"])
    m = load_image_encoder(config)
    load_jax_variables(m, v)
    assert _port_layouts(m) == layouts
    with torch.no_grad():
        assert _rel(m(torch.from_numpy(IMG), train=False)["pooled"].numpy(), want) < 1e-4
        m.s2d_exec = False
        assert _rel(m(torch.from_numpy(IMG), train=False)["pooled"].numpy(), want) > 1e-3


@pytest.mark.parametrize("config", [
    {"s2d_exec": True, "fused_mbconv": True},
    {"s2d_exec": True, "packed_residuals": True, "remat": True},
    {"s2d_exec": True, "tpu_optimized": True},
], ids=["fused_mbconv", "packed_residuals", "tpu_optimized"])
def test_s2d_exec_refusals_match_jax(config):
    config = {"name": "efficientnet-b0", **config}
    with pytest.raises(ValueError, match="layout regime"):
        load_image_encoder(config)
    m = jax_load_image_encoder(config)
    with pytest.raises(AssertionError, match="layout regime"):
        jax.eval_shape(lambda x: m.init({"params": jax.random.PRNGKey(0)}, x, False),
                       jnp.zeros((1, 64, 64, 1)))


def test_quant_int8_k5_composes_with_tpu_optimized():
    """No refusal of the pair, as in JAX: the flagship's deep k5 blocks go int8."""
    m = load_image_encoder({"name": "efficientnet-b0", "tpu_optimized": True,
                            "quant_int8_k5": True})
    init_parameters(m, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 64, 64, 1))
                         .astype(np.float32))
    with torch.no_grad():
        out = m(x, train=False)
    assert torch.isfinite(out["pooled"]).all()
    assert any(m.quant_ok(a, 4, 4) for a in m.block_args)


# --------------------------------------------------------------------------- learning

@pytest.mark.slow
def test_int8_deep_stages_learning_parity():
    """The port's twin of tests/test_quant.py's loss-curve overlay: the k5 block
    with int8 1x1s trains as far as the fp path on a separable task (weights from
    JAX's init, Adam 3e-3, 60 steps)."""
    args = (5, 1, 4, 16, 16, 0.25)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(32, 8, 8, 16)).astype(np.float32)
    y = torch.from_numpy((x[:, :, :, 0].mean(axis=(1, 2)) > 0).astype(np.float32))
    v = _np_tree(JaxMBConvBlock(JaxBlockArgs(*args), drop_rate=0.0).init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), False))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()

    def curve(q):
        block = MBConvBlock(BlockArgs(*args), 0.0)
        load_jax_variables(block, v)
        head = torch.zeros(16, requires_grad=True)
        opt = torch.optim.Adam([*block.parameters(), head], lr=3e-3)
        losses = []
        for _ in range(60):
            out = block(xt, True, torch.ones(32), quant=q)
            logit = out.mean(dim=(2, 3)) @ head
            loss = torch.nn.functional.binary_cross_entropy_with_logits(logit, y)
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.item())
        return losses

    fp, q8 = curve(False), curve(True)
    assert fp[-1] < 0.25, fp[-1]
    assert q8[-1] < fp[-1] + 0.1, (fp[-1], q8[-1])

