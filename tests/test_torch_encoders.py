"""The other image-encoder families of the port against the JAX package, on the CPU:
ResNet-50/101/152, ViT, Swin, the factory's dispatch, their initialisers and
Flax trees, one CLIP train step per family, and the Hugging Face ViT / Swin
importers.

Weights are drawn by the port (``models.init_parameters``; ResNet's BatchNorm
parameters and statistics then moved off their init) and carried to JAX with
``convert/from_jax.variables_from_state_dict``, so no JAX init is compiled;
each JAX function is compiled once for the file.

Tolerances (fp32 on both sides, other summation orders): forward values
within 1e-4 relative and 1e-4 of the output's largest value; gradients within
1e-3 relative and 1e-4 of the largest gradient; running statistics within
1e-5 relative and 1e-6 absolute; the parameters after one AdamW step within
1e-5 (1% of its learning rate). One exception, stated where it applies:
ResNet-50's train-mode outputs and statistics through all 16 blocks are held
within 1e-3 of the largest value. Train-mode BatchNorm at eps 1e-5 magnifies
rounding block by block there: at this input the JAX package's own fp32
result sits 5.5e-3 (8e-4 of the largest) from its fp64 result, and the
port's 1.0e-3. A single Bottleneck in train mode is held at the tight
tolerances above. The HF importers match HF's outputs within 2e-4 (the JAX
package's own test) and the JAX importers' trees exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mammo_clip_tpu.models.clip as jax_clip
from mammo_clip_tpu.convert import torch_import as jax_torch_import
from mammo_clip_tpu.core.config import tiny_test_config as jax_tiny_config
from mammo_clip_tpu.losses import build_loss as jax_build_loss
from mammo_clip_tpu.models import build_model as jax_build_model
from mammo_clip_tpu.models import load_image_encoder as jax_load_image_encoder
from mammo_clip_tpu.models import resnet as jax_resnet
from mammo_clip_tpu.models import swin as jax_swin
from mammo_clip_tpu.models import vit as jax_vit
from mammo_clip_tpu.train import build_optimizer as jax_build_optimizer
from mammo_clip_tpu_torch.convert import torch_import
from mammo_clip_tpu_torch.convert.from_jax import (
    load_jax_variables,
    state_dict_from_jax,
    variables_from_state_dict,
)
from mammo_clip_tpu_torch.core.config import tiny_test_config
from mammo_clip_tpu_torch.losses import build_loss
from mammo_clip_tpu_torch.models import (
    EfficientNet,
    ResNet,
    SwinConfig,
    SwinTransformer,
    ViT,
    ViTConfig,
    build_model,
    init_parameters,
    load_image_encoder,
)
from mammo_clip_tpu_torch.models import resnet, swin, vit
from mammo_clip_tpu_torch.train import build_optimizer, create_train_state
from mammo_clip_tpu_torch.train.recipes import bench_recipe_config

TINY_VIT = {"name": "vit-tiny", "patch_size": 8, "hidden_size": 32, "num_layers": 2,
            "num_heads": 2, "mlp_dim": 64, "base_grid": 4}
TINY_SWIN = {"name": "swin-tiny", "patch_size": 4, "embed_dim": 16, "depths": [2, 2],
             "num_heads": [2, 2], "window": 4}
FAMILIES = {"resnet": {"name": "resnet50"}, "vit": TINY_VIT, "swin": TINY_SWIN}
LR, ADAM_EPS = 1e-3, 1e-3


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel
    processes, and torch's default of one thread per core in each oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree):
    """The leaf shapes of a {collection: tree} mapping, empty collections dropped."""
    return {c: jax.tree_util.tree_map(lambda a: tuple(a.shape), t) for c, t in tree.items()
            if jax.tree_util.tree_leaves(t)}


def _port_shapes(model):
    return _shapes(variables_from_state_dict({k: torch.zeros(v.shape)
                                              for k, v in model.state_dict().items()}))


def _close(got, want, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    atol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=err_msg)


def _close_stats(got, want, err_msg=""):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{err_msg} {k}")


def _perturb_bn(model, seed):
    """BatchNorm scales, biases and running statistics away from their init."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if "bn" in name.rsplit(".", 2)[-2] and leaf in ("scale", "bias", "mean", "var"):
                noise = torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
                if leaf == "var":
                    t.copy_(1.0 + 0.2 * noise.abs())
                elif leaf == "scale":
                    t.copy_(1.0 + 0.1 * noise)
                else:
                    t.copy_(0.1 * noise)


def _stats(model):
    return {k: v.clone() for k, v in model.state_dict().items() if k.endswith(("mean", "var"))}


# --------------------------------------------------------------------------- ResNet


@pytest.mark.parametrize("cin,filters,stride,hw", [
    (64, 16, 1, (9, 8)),   # residual as it is: in == 4 * filters, stride 1
    (32, 16, 1, (9, 8)),   # a downsample branch at stride 1 (stage 1 block 0's case)
    (32, 16, 2, (10, 8)),  # stride 2 on even sizes: SAME pads one pixel at the end
    (32, 16, 2, (9, 7)),   # stride 2 on odd sizes: SAME pads one on each side
])
def test_bottleneck_train_and_eval_match_jax(cin, filters, stride, hw):
    block = resnet.Bottleneck(cin, filters, stride)
    init_parameters(block, torch.Generator().manual_seed(1))
    _perturb_bn(block, 2)
    assert hasattr(block, "downsample") == (cin != 4 * filters or stride != 1)
    v = variables_from_state_dict(block.state_dict())
    x = np.random.default_rng(3).standard_normal((2, *hw, cin)).astype(np.float32)
    jb = jax_resnet.Bottleneck(filters, strides=stride)
    ev, (tr, mut) = jax.jit(lambda v, x: (
        jb.apply(v, x, train=False),
        jb.apply(v, x, train=True, mutable=["batch_stats"])))(v, jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        _close(block(xt, False).permute(0, 2, 3, 1), ev, "eval")
        _close(block(xt, True).permute(0, 2, 3, 1), tr, "train")
    _close_stats(block.state_dict(), state_dict_from_jax({"batch_stats": mut["batch_stats"]}),
                 "running statistics")


def _resnet50():
    m = ResNet("resnet50")
    init_parameters(m, torch.Generator().manual_seed(0))
    _perturb_bn(m, 1)
    return m


@functools.lru_cache(maxsize=None)
def _jax_resnet50(h, w):
    """The JAX ResNet-50 on the port's weights at (2, h, w, 1): eval outputs, then
    train outputs with the updated statistics, in one compiled function."""
    m = jax_resnet.ResNet(variant="resnet50")
    x = np.random.default_rng(4).standard_normal((2, h, w, 1)).astype(np.float32)

    def run(variables, x):
        tr, mut = m.apply(variables, x, train=True, mutable=["batch_stats"])
        return m.apply(variables, x, train=False), tr, mut["batch_stats"]

    ev, tr, bs = jax.jit(run)(variables_from_state_dict(_resnet50().state_dict()), x)
    return x, _np_tree(ev), _np_tree(tr), _np_tree(bs)


def test_resnet50_eval_matches_jax():
    """64x50: the stem (50 even -> 25), the pool (25 odd -> 13) and the stride-2
    conv2 of stages 2-4 (13 -> 7 odd, 7 -> 4 odd, 4 -> 2 even) meet both cases."""
    x, ev, _, _ = _jax_resnet50(64, 50)
    m = _resnet50().eval()
    with torch.no_grad():
        out = m(torch.from_numpy(x))
    assert out["features"].shape == (2, 2, 2, 2048) and m.out_dim == 2048
    _close(out["features"], ev["features"], "features")
    _close(out["pooled"], ev["pooled"], "pooled")


def test_resnet50_train_outputs_and_statistics_match_jax():
    """Train mode through all 16 blocks, within 1e-3 of the largest value (see
    the module docstring), and the running statistics after the update."""
    x, _, tr, bs = _jax_resnet50(64, 50)
    m = _resnet50()
    before = _stats(m)
    with torch.no_grad():
        out = m(torch.from_numpy(x), train=True)
    for k in ("features", "pooled"):
        want = tr[k]
        np.testing.assert_allclose(out[k].numpy(), want, rtol=0,
                                   atol=1e-3 * np.abs(want).max(), err_msg=k)
    want = state_dict_from_jax({"batch_stats": bs})
    got = _stats(m)
    assert set(got) == set(want) == set(before)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-3 * float(w.abs().max()), err_msg=k)
        # momentum 0.9: one update moves a statistic 10% of the way to its batch value
        assert not torch.equal(got[k], before[k]), k


@pytest.mark.parametrize("variant,blocks", [("resnet50", 16), ("resnet101", 33),
                                            ("resnet152", 50)])
def test_resnet_trees_match_jax(variant, blocks):
    m = load_image_encoder({"name": variant, "remat": True, "fused_mbconv": True})
    assert isinstance(m, ResNet) and len(m.blocks) == blocks
    shapes = jax.eval_shape(lambda: jax_resnet.ResNet(variant=variant).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)), train=False))
    assert _port_shapes(m) == _shapes(shapes)


def test_unknown_resnet_raises_key_error_on_both_sides():
    with pytest.raises(KeyError):
        load_image_encoder({"name": "resnet18"})
    with pytest.raises(KeyError):
        jax_load_image_encoder({"name": "resnet18"}).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))


# --------------------------------------------------------------------------- ViT


def _vit(cfg=ViTConfig.tiny()):
    m = ViT(cfg)
    init_parameters(m, torch.Generator().manual_seed(5))
    return m


@pytest.mark.parametrize("hw", [(32, 32), (64, 48), (16, 16)],
                         ids=["grid_kept", "upsampled", "downsampled"])
def test_vit_matches_jax(hw, monkeypatch):
    """base_grid 4 at patch 8: 32x32 keeps the 4x4 grid, 64x48 resizes the
    position embeddings up to 8x6, 16x16 down to 2x2 (antialiased); every
    layer's attention goes through ``flash_attention`` (its plain version on
    the CPU)."""
    m = _vit()
    x = np.random.default_rng(6).standard_normal((2, *hw, 1)).astype(np.float32)
    want = jax.jit(jax_vit.ViT(cfg=jax_vit.ViTConfig.tiny()).apply)(
        variables_from_state_dict(m.state_dict()), jnp.asarray(x))
    calls = []
    flash = vit.flash_attention
    monkeypatch.setattr(vit, "flash_attention",
                        lambda q, k, v, s: calls.append((tuple(q.shape), s)) or flash(q, k, v, s))
    with torch.no_grad():
        out = m(torch.from_numpy(x))
    gh, gw = hw[0] // 8, hw[1] // 8
    assert calls == [((2, 2, gh * gw + 1, 16), 1.0)] * 2
    assert out["features"].shape == (2, gh, gw, 32) and m.out_dim == 32
    for k in ("pooled", "features", "tokens"):
        _close(out[k], want[k], k)


@pytest.mark.parametrize("grid", [(4, 4), (8, 6), (2, 2), (2, 7), (95, 57)])
def test_position_grid_resize_matches_jax_image_resize(grid):
    """Up, down, one axis each way, and ViT-B/16's 1520x912 grid from 14x14."""
    g = 14 if grid == (95, 57) else 4
    pos = np.random.default_rng(7).standard_normal((1, g, g, 8)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(pos), (1, *grid, 8), "bilinear")
    _close(vit.resize_grid(torch.from_numpy(pos), *grid), want)


def test_vit_dropout_is_refused():
    with pytest.raises(NotImplementedError):
        ViT(dataclasses.replace(ViTConfig.tiny(), dropout_rate=0.1))


# --------------------------------------------------------------------------- Swin


def _swin():
    m = SwinTransformer(SwinConfig(patch_size=4, embed_dim=16, depths=(2, 2),
                                   num_heads=(2, 2), window=4))
    init_parameters(m, torch.Generator().manual_seed(8))
    return m


def test_swin_matches_jax(monkeypatch):
    """64x32 at patch 4, window 4: stage 0's 16x8 grid takes a shifted block
    (roll, mask, roll back), the merge halves it to 8x4, where stage 1's
    second block takes no shift (the grid is one window across)."""
    m = _swin()
    shifts = []
    forward = swin.SwinBlock.forward
    monkeypatch.setattr(swin.SwinBlock, "forward",
                        lambda self, x, shift: shifts.append(shift) or forward(self, x, shift))
    x = np.random.default_rng(9).standard_normal((2, 64, 32, 1)).astype(np.float32)
    want = jax.jit(jax_swin.SwinTransformer(cfg=jax_swin.SwinConfig(
        patch_size=4, embed_dim=16, depths=(2, 2), num_heads=(2, 2), window=4)).apply)(
        variables_from_state_dict(m.state_dict()), jnp.asarray(x))
    with torch.no_grad():
        out = m(torch.from_numpy(x))
    assert shifts == [0, 2, 0, 0]
    assert out["features"].shape == (2, 8, 4, 32) and m.out_dim == 32
    for k in ("pooled", "features"):
        _close(out[k], want[k], k)


@pytest.mark.parametrize("w,hw,shift", [(4, (8, 12), 2), (8, (16, 16), 4), (3, (6, 9), 1)])
def test_swin_window_helpers_match_jax(w, hw, shift):
    np.testing.assert_array_equal(swin._rel_pos_index(w), jax_swin._rel_pos_index(w))
    np.testing.assert_array_equal(swin._shift_mask(*hw, w, shift),
                                  jax_swin._shift_mask(*hw, w, shift))
    x = np.random.default_rng(10).standard_normal((2, *hw, 5)).astype(np.float32)
    wins = swin._window_partition(torch.from_numpy(x), w)
    np.testing.assert_array_equal(wins.numpy(), jax_swin._window_partition(jnp.asarray(x), w))
    np.testing.assert_array_equal(swin._window_reverse(wins, w, 2, *hw).numpy(), x)


def test_swin_refuses_a_grid_the_window_does_not_divide():
    with pytest.raises(ValueError, match="not divisible by window"):
        _swin()(torch.zeros(1, 64, 48, 1))
    with pytest.raises(AssertionError):
        jax.eval_shape(lambda: jax_swin.SwinTransformer(cfg=jax_swin.SwinConfig.tiny_test())
                       .init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 1))))


# --------------------------------------------------------------------------- factory, trees


def _compat_encoder(**override):
    """The compat recipe's image-encoder keys (remat, fused_mbconv, ...) with a
    family's name: the EfficientNet-only keys are ignored, as in JAX."""
    ie = bench_recipe_config(compat=True).model.image_encoder.to_dict()
    ie.update(override)
    return ie


@pytest.mark.parametrize("config,cls,out_dim", [
    (_compat_encoder(name="vit-base"), ViT, 768),
    (_compat_encoder(name="deit-s", model_type="vit", hidden_size=384, num_heads=6), ViT, 384),
    (_compat_encoder(name="swin-tiny"), SwinTransformer, 768),
    (_compat_encoder(name="hf-swin", model_type="swin", embed_dim=32), SwinTransformer, 256),
    (_compat_encoder(name="resnet101"), ResNet, 2048),
    (_compat_encoder(name="tf_efficientnet_b5_ns-detect"), EfficientNet, 2048),
], ids=["vit-base", "vit-by-type", "swin-tiny", "swin-by-type", "resnet101", "b5-alias"])
def test_factory_dispatch_matches_jax(config, cls, out_dim):
    m = load_image_encoder(config)
    jm = jax_load_image_encoder(config)
    assert isinstance(m, cls) and type(jm).__name__ == cls.__name__
    assert m.out_dim == jm.out_dim == out_dim
    if cls is not EfficientNet:  # the JAX tree, leaf for leaf, without compiling
        hw = 256 if cls is SwinTransformer else 64
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, hw, hw, 1)), train=False))
        assert _port_shapes(m) == _shapes(shapes)


@pytest.mark.parametrize("option", ["s2d_exec", "quant_int8_k5"])
def test_efficientnet_options_not_ported_raise_for_efficientnet_alone(option):
    """Item 10's EfficientNet options raise there; another family ignores them,
    as the JAX factory does."""
    with pytest.raises(NotImplementedError, match=option):
        load_image_encoder({"name": "efficientnet-b0", option: True})
    for config in FAMILIES.values():
        assert load_image_encoder(dict(config, **{option: True})).out_dim in (32, 2048)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_trees_round_trip_through_from_jax(family):
    """Every leaf keeps its shape both ways but conv kernels (HWIO <-> OIHW);
    Swin's 4-D ``qkv`` kernel is not a conv kernel."""
    m = load_image_encoder(FAMILIES[family])
    init_parameters(m, torch.Generator().manual_seed(11))
    sd = m.state_dict()
    tree = variables_from_state_dict(sd)
    back = state_dict_from_jax(tree)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    flat = dict(jax.tree_util.tree_flatten_with_path(tree["params"])[0])
    for path, leaf in flat.items():
        name = ".".join(p.key for p in path)
        if name.endswith("qkv.kernel"):
            assert leaf.shape == tuple(sd[name].shape) and leaf.shape[1] == 3, name
        elif leaf.ndim == 4:
            assert leaf.shape == tuple(sd[name].permute(2, 3, 1, 0).shape), name
        else:
            assert leaf.shape == tuple(sd[name].shape), name
    fresh = load_image_encoder(FAMILIES[family])
    load_jax_variables(fresh, tree)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_new_leaves_take_flax_initialisers():
    """cls_token zeros, pos_embedding normal(0.02), rel_pos_table truncated
    normal(0.02), and a DenseGeneral kernel's fan-in the product of the axes it
    contracts: H * head_dim for ViT's ``attn.out`` and Swin's ``proj``, C for
    Swin's 4-D ``qkv``."""
    g = torch.Generator().manual_seed(12)
    v = ViT(ViTConfig(patch_size=16, hidden_size=256, num_layers=1, num_heads=8, mlp_dim=64,
                      base_grid=14))
    init_parameters(v, g)
    assert torch.count_nonzero(v.cls_token) == 0
    assert abs(float(v.pos_embedding.detach().std()) - 0.02) < 1e-3
    s = SwinTransformer(SwinConfig(patch_size=4, embed_dim=96, depths=(2,), num_heads=(6,),
                                   window=8))
    init_parameters(s, g)
    table = s.stage0_block0.rel_pos_table.detach()
    assert float(table.abs().max()) <= 0.04 + 1e-7
    # a standard normal truncated to [-2, 2] has std 0.8796
    assert abs(float(table.std()) - 0.02 * 0.8796) < 1.5e-3
    for kernel, fan_in in ((v.block_0.attn.out.kernel, 256), (v.block_0.attn.query.kernel, 256),
                           (s.stage0_block0.proj.kernel, 96), (s.stage0_block0.qkv.kernel, 96)):
        assert abs(float(kernel.detach().std()) * fan_in ** 0.5 - 1.0) < 0.05, kernel.shape


# --------------------------------------------------------------------------- CLIP step


def _clip_config(family):
    cfg = tiny_test_config()
    cfg.model.image_encoder = dict(FAMILIES[family])
    cfg.model.text_encoder.dropout_rate = 0.0
    cfg.optimizer.eps = ADAM_EPS
    return cfg


def _batch(cfg, n=2, seed=13):
    rng = np.random.default_rng(seed)
    h, w, s = cfg.data.image_size_h, cfg.data.image_size_w, cfg.data.text_max_length
    ids = rng.integers(1, cfg.model.text_encoder.vocab_size, size=(n, s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < rng.integers(2, s + 1, size=n)[:, None]).astype(np.int32)
    return {"images": rng.standard_normal((n, h, w, 1)).astype(np.float32),
            "image_views": rng.standard_normal((n, h, w, 1)).astype(np.float32),
            "input_ids": ids, "attention_mask": mask,
            "input_ids2": ids[:, ::-1].copy(), "attention_mask2": mask}


def _port_clip(family):
    cfg = _clip_config(family)
    model = build_model(cfg.model.to_dict(), device="cpu",
                        generator=torch.Generator().manual_seed(14))
    if family == "resnet":
        _perturb_bn(model.image_encoder, 15)
    return cfg, model


@functools.lru_cache(maxsize=None)
def _jax_clip_step(family):
    """The JAX package's CLIP on the port's weights: the loss, its gradients, the
    running statistics after the train-mode forward, and the parameters after
    one AdamW step (its BERT's dropout off, as the port's config sets it).
    ResNet's step runs in fp64 (see ``test_clip_step_matches_jax``)."""
    cfg, port = _port_clip(family)
    f64 = family == "resnet"
    cast = (lambda a: np.asarray(a, np.float64) if a.dtype == np.float32 else a) if f64 \
        else (lambda a: a)
    v = jax.tree_util.tree_map(cast, variables_from_state_dict(port.state_dict()))
    batch = _batch(cfg)
    jcfg = jax_tiny_config()
    jcfg.model.image_encoder = dict(FAMILIES[family])
    orig = jax_clip.bert_config_from_model_config
    jax_clip.bert_config_from_model_config = lambda mc: dataclasses.replace(
        orig(mc), dropout_rate=0.0)
    try:
        with jax.enable_x64(f64):
            model = jax_build_model(jcfg.model.to_dict(),
                                    dtype=jnp.float64 if f64 else jnp.float32)
            loss_fn = jax_build_loss(jcfg.loss.to_dict())
            tx = jax_build_optimizer(dict(jcfg.optimizer.to_dict(), eps=ADAM_EPS),
                                     lambda s: LR)

            def step(params, stats, batch):
                def loss(p):
                    out, mut = model.apply({"params": p, "batch_stats": stats}, batch,
                                           train=True, mutable=["batch_stats"])
                    return loss_fn(out, batch, True)["total"], mut["batch_stats"]

                (total, new_stats), grads = jax.value_and_grad(loss, has_aux=True)(params)
                updates, _ = tx.update(grads, tx.init(params), params)
                return total, grads, new_stats, optax.apply_updates(params, updates)

            out = jax.jit(step)(v["params"], v.get("batch_stats", {}),
                                {k: cast(a) for k, a in batch.items()})
            out = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out)
    finally:
        jax_clip.bert_config_from_model_config = orig
    return batch, out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_clip_step_matches_jax(family):
    """ViT and Swin against the JAX package in fp32, at the module's
    tolerances. ResNet-50's train step through 16 train-mode BatchNorm blocks
    is ill-conditioned in fp32: at this input the JAX package's own fp32
    gradients sit 2.2e-2 of the largest gradient from its fp64 ones, the
    port's (fp32) 5.6e-3. So the JAX side runs in fp64 there, as the exact
    function, and the port is held within 1e-2 of the largest gradient, its
    loss and running statistics within 1e-4 relative; its parameters after
    the AdamW step are held within 1e-6 to optax's step on the port's own
    gradients (an element whose gradient is near AdamW's eps moves by
    lr * g / (|g| + eps), which would pass the gradient's error on)."""
    batch, (total, grads, stats, params) = _jax_clip_step(family)
    cfg, model = _port_clip(family)
    resnet50 = family == "resnet"
    opt = build_optimizer(cfg.optimizer.to_dict(), lambda s: LR, model.named_parameters())
    state = create_train_state(model, opt)
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
          for k, v in batch.items()}
    loss = build_loss(cfg.loss.to_dict())(model(tb, train=True), tb, True)["total"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(total), rtol=1e-4, atol=1e-5)
    want = state_dict_from_jax({"params": grads})
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    scale = max(float(g.abs().max()) for g in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0 if resnet50 else 1e-3,
                                   atol=(1e-2 if resnet50 else 1e-4) * scale, err_msg=k)
    if resnet50:
        for k, w in state_dict_from_jax({"batch_stats": stats}).items():
            np.testing.assert_allclose(model.state_dict()[k].numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-4 * float(w.abs().max()), err_msg=k)
    before = variables_from_state_dict({k: v.clone()
                                        for k, v in model.state_dict().items()})["params"]
    port_grads = variables_from_state_dict({k: g.clone() for k, g in got.items()})["params"]
    state.apply_gradients()
    if resnet50:  # optax's AdamW step on the port's own gradients
        tx = jax_build_optimizer(dict(cfg.optimizer.to_dict(), eps=ADAM_EPS), lambda s: LR)
        params = _np_tree(jax.jit(lambda g, p: optax.apply_updates(
            p, tx.update(g, tx.init(p), p)[0]))(port_grads, before))
    after = state_dict_from_jax({"params": params})
    for k, w in after.items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 if resnet50 else 1e-5, err_msg=k)


# --------------------------------------------------------------------------- HF importers


@functools.lru_cache(maxsize=None)
def _hf_models():
    transformers = pytest.importorskip("transformers")
    vit_cfg = transformers.ViTConfig(
        image_size=32, patch_size=8, num_channels=3, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    swin_cfg = transformers.SwinConfig(
        image_size=32, patch_size=4, num_channels=3, embed_dim=16, depths=(2, 2),
        num_heads=(2, 2), window_size=4, mlp_ratio=4.0, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, drop_path_rate=0.0)
    torch.manual_seed(16)
    return (transformers.ViTModel(vit_cfg, add_pooling_layer=False).eval(),
            transformers.SwinModel(swin_cfg, add_pooling_layer=True).eval())


@pytest.mark.parametrize("family", ["vit", "swin"])
def test_hf_importer_matches_hf_and_the_jax_importer(family):
    """An HF model built in process (random weights, 3-channel patch embedding)
    -> the port's importer -> the port's encoder, on replicated-gray input,
    against HF's own outputs; the tree leaf for leaf against the JAX
    importer's, from the same state dict."""
    hf = _hf_models()[0 if family == "vit" else 1]
    sd = hf.state_dict()
    gray = torch.rand(2, 1, 32, 32, generator=torch.Generator().manual_seed(17))
    with torch.no_grad():
        ref = hf(pixel_values=gray.repeat(1, 3, 1, 1))
    if family == "vit":
        params = torch_import.convert_hf_vit(sd, num_heads=2)
        jax_params = jax_torch_import.convert_hf_vit(sd, num_heads=2)
        ours = ViT(ViTConfig(patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
                             mlp_dim=64, base_grid=4))
    else:
        params = torch_import.convert_hf_swin(sd, num_heads=(2, 2))
        jax_params = jax_torch_import.convert_hf_swin(sd, num_heads=(2, 2))
        ours = SwinTransformer(SwinConfig(patch_size=4, embed_dim=16, depths=(2, 2),
                                          num_heads=(2, 2), window=4))
    flat = lambda t: {jax.tree_util.keystr(p): leaf
                      for p, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(params), flat(jax_params)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    load_jax_variables(ours, {"params": params})
    with torch.no_grad():
        out = ours(gray.permute(0, 2, 3, 1))
    if family == "vit":
        np.testing.assert_allclose(out["tokens"].numpy(), ref.last_hidden_state.numpy(),
                                   atol=2e-4)
        np.testing.assert_allclose(out["pooled"].numpy(), ref.last_hidden_state[:, 0].numpy(),
                                   atol=2e-4)
    else:
        B, H, W, C = out["features"].shape
        np.testing.assert_allclose(out["features"].reshape(B, H * W, C).numpy(),
                                   ref.last_hidden_state.numpy(), atol=2e-4)
        np.testing.assert_allclose(out["pooled"].numpy(), ref.pooler_output.numpy(),
                                   atol=2e-4)
