"""The flagship pretraining path of the port against the JAX package, on the CPU.

The ``tpu_optimized`` EfficientNet (space-to-depth front, 128-multiple widths,
slim stages, ``packed_residuals``), its recipe, the compat-to-flagship warm
start and ``Trainer.fit(warm_start_from=...)``. Weights are drawn by the port
(``models.init_parameters``, BatchNorm parameters and statistics then
perturbed from a seed) and carried to JAX with
``convert/from_jax.variables_from_state_dict``, so no JAX init is compiled;
each JAX function is compiled once for the file.

Tolerances, those of tests/test_torch_models.py (fp32 on both sides, other
summation orders): forward values within 1e-4 relative and absolute (b5's
wider layers within 1e-4 of each output's largest value), gradients within
1e-3 relative and 1e-4 of the largest gradient, running statistics within
1e-5 relative and 1e-6 absolute. The warm start is bit-exact: the same numpy
arithmetic on the same arrays.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mammo_clip_tpu.convert import flagship_init as jax_flagship_init
from mammo_clip_tpu.core.config import Config as JaxConfig
from mammo_clip_tpu.downstream.classify import MammoClassifier as JaxClassifier
from mammo_clip_tpu.models import efficientnet as jax_efficientnet
from mammo_clip_tpu.models.retinanet import RetinaNet as JaxRetinaNet
from mammo_clip_tpu.train import recipes as jax_recipes
from mammo_clip_tpu.train import trainer as jax_trainer
from mammo_clip_tpu.utils.logging import MetricsLogger as JaxMetricsLogger
from mammo_clip_tpu_torch.convert import flagship_init
from mammo_clip_tpu_torch.convert.from_jax import state_dict_from_jax, variables_from_state_dict
from mammo_clip_tpu_torch.core.config import tiny_test_config
from mammo_clip_tpu_torch.downstream.classify import MammoClassifier
from mammo_clip_tpu_torch.losses.focal import focal_loss
from mammo_clip_tpu_torch.models import build_model, init_parameters
from mammo_clip_tpu_torch.models import efficientnet
from mammo_clip_tpu_torch.models.clip import image_encoder_state, load_image_encoder
from mammo_clip_tpu_torch.models.efficientnet import EfficientNet
from mammo_clip_tpu_torch.models.retinanet import RetinaNet, anchors_for, init_heads
from mammo_clip_tpu_torch.train import recipes
from mammo_clip_tpu_torch.train import trainer as trainer_mod
from mammo_clip_tpu_torch.train.checkpoint import save_checkpoint


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel
    processes, and torch's default of one thread per core in each oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


H, W = 64, 48
# (name, variant, encoder options); the taps are the detector's (b0 (10, 15), b5 (26, 37))
CASES = {
    "dense": ("b0", dict(feature_taps=(10, 15))),
    "sparse_packed_remat": ("b0", dict(feature_taps=(10, 15), tpu_dense_widths=False,
                                       remat=True, packed_residuals=True)),
    "rgb_front_e2": ("b0", dict(in_channels=3, tpu_front_expand=2, tpu_front_blocks=1)),
    "b5_slim": ("b5", dict(feature_taps=(26, 37), tpu_slim_stage3=256, tpu_slim_stage4=512,
                           tpu_slim_stage5=768, tpu_slim_stage6=1536, tpu_slim_stage7=2048)),
}
GRAD_CASES = ("dense", "sparse_packed_remat")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_bn(model, seed):
    """BatchNorm scales, biases and running statistics away from their init."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if ".bn" in name or "_bn." in name:
                noise = torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
                if leaf == "var":
                    t.copy_(1.0 + 0.2 * noise.abs())
                elif leaf == "scale":
                    t.copy_(1.0 + 0.1 * noise)
                else:
                    t.copy_(0.1 * noise)


def _port_encoder(case):
    """Built through the config loader, as a checkpoint's config builds it (it
    takes ``packed_residuals`` and does not pass it on)."""
    variant, opts = CASES[case]
    m = load_image_encoder({"name": f"efficientnet-{variant}", "drop_connect_rate": 0.0,
                            "tpu_optimized": True, **opts})
    init_parameters(m, torch.Generator().manual_seed(0))
    _perturb_bn(m, 1)
    return m


def _image(case):
    """b5 at twice the size: its 1/32 maps at 64x48 are 2x2, and train-mode
    BatchNorm over 8 values per channel magnifies rounding past the tolerance."""
    c = CASES[case][1].get("in_channels", 1)
    k = 2 if CASES[case][0] == "b5" else 1
    return np.random.default_rng(2).standard_normal((2, k * H, k * W, c)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The JAX flagship encoder on the port's weights: train-mode outputs with the
    new batch stats (and, for GRAD_CASES, the gradient of sum(pooled**2)), and
    eval-mode outputs, in one compiled function."""
    variant, opts = CASES[case]
    m = jax_efficientnet.EfficientNet(variant=variant, drop_connect_rate=0.0,
                                      tpu_optimized=True, **opts)
    v = variables_from_state_dict(_port_encoder(case).state_dict())

    def loss(variables, x):
        out, mut = m.apply(variables, x, True, mutable=["batch_stats"])
        return jnp.sum(out["pooled"] ** 2), (out, mut["batch_stats"])

    def run(variables, x):
        if case in GRAD_CASES:
            (_, (out, bs)), g = jax.value_and_grad(loss, has_aux=True)(variables, x)
        else:
            (_, (out, bs)), g = loss(variables, x), None
        return out, bs, g, m.apply(variables, x, False)

    out, bs, g, ev = jax.jit(run)(v, _image(case))
    return _np_tree(out), _np_tree(bs), (None if g is None else _np_tree(g["params"])), \
        _np_tree(ev)


def _close(got, want, err_msg, scaled):
    atol = 1e-4 * max(1.0, float(np.abs(want).max())) if scaled else 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=err_msg)


def _assert_outputs(out, want, scaled):
    for k in ("pooled", "features"):
        _close(out[k].detach().numpy(), want[k], k, scaled)
    assert list(out["endpoints"]) == list(want["endpoints"])
    for k, t in want["endpoints"].items():
        assert tuple(out["endpoints"][k].shape) == t.shape, k
        _close(out["endpoints"][k].detach().numpy(), t, k, scaled)
    assert len(out["taps"]) == len(want["taps"])
    for i, t in enumerate(want["taps"]):
        _close(out["taps"][i].detach().numpy(), t, f"tap {i}", scaled)


@pytest.mark.parametrize("case", list(CASES))
def test_flagship_forward_matches_jax(case):
    """Train mode (outputs, endpoints, taps, running-statistics updates) and eval
    mode. Covers dense widths on and off, the five slim overrides (b5, all at
    once), ``in_channels=3`` (space-to-depth's channel order), an expanding
    front block, and ``packed_residuals`` with remat."""
    want, bs, _, ev = _jax_run(case)
    scaled = CASES[case][0] == "b5"
    m = _port_encoder(case)
    x = torch.from_numpy(_image(case))
    with torch.no_grad():
        _assert_outputs(m(x, train=True), want, scaled)
        new = state_dict_from_jax({"batch_stats": bs})
        sd = m.state_dict()
        assert {k for k in sd if k.endswith((".mean", ".var"))} == set(new)
        for k, t in new.items():
            np.testing.assert_allclose(sd[k].numpy(), t.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        _assert_outputs(_port_encoder(case)(x, train=False), ev, scaled)


@pytest.mark.parametrize("case", GRAD_CASES)
@pytest.mark.parametrize("remat", [False, True])
def test_flagship_gradients_match_jax(case, remat):
    """Every parameter's gradient of sum(pooled**2) after one train-mode forward,
    with the port's remat off and on (the JAX side of ``sparse_packed_remat``
    runs remat with ``packed_residuals``: its saved block inputs are packed,
    C % 128 != 0 there)."""
    _, _, grads, _ = _jax_run(case)
    m = _port_encoder(case)
    m.remat = remat
    (m(torch.from_numpy(_image(case)), train=True)["pooled"] ** 2).sum().backward()
    ref = state_dict_from_jax({"params": grads})
    assert {n for n, _ in m.named_parameters()} == set(ref)
    scale = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("variant", ["b0", "b5"])
@pytest.mark.parametrize("dense", [True, False])
def test_block_args_match_jax(variant, dense):
    """``tpu_optimized_block_args`` with each slim override alone and all at once."""
    overrides = [{}] + [{f"slim_stage{s}": w} for s, w in
                        ((3, 256), (4, 512), (5, 768), (6, 1536), (7, 2048))]
    overrides.append({k: v for o in overrides for k, v in o.items()})
    for kw in overrides:
        got, skip = efficientnet.tpu_optimized_block_args(variant, dense_widths=dense, **kw)
        want, jskip = jax_efficientnet.tpu_optimized_block_args(variant, dense_widths=dense,
                                                                **kw)
        assert skip == jskip
        assert [dataclasses.asdict(a) for a in got] == [dataclasses.asdict(a) for a in want], kw


@pytest.mark.parametrize("trimmed", [False, True])
def test_b5_flagship_parameter_tree_matches_jax(trimmed):
    """B5 flagship (and ``--trimmed``) at the recipe's widths: the port declares
    the JAX tree, name for name and shape for shape (``jax.eval_shape``)."""
    slim = {f"tpu_slim_stage{s}": w for s, w in recipes.TRIMMED_SLIM.items()} if trimmed else {}
    x = np.zeros((1, 64, 64, 1), np.float32)
    m = jax_efficientnet.EfficientNet(variant="b5", tpu_optimized=True, **slim)
    shapes = jax.eval_shape(lambda x: m.init({"params": jax.random.PRNGKey(0)}, x, False), x)
    want = {k: tuple(t.shape) for k, t in state_dict_from_jax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    with torch.device("meta"):  # shapes only: no storage for B5's weights
        port = EfficientNet(variant="b5", tpu_optimized=True, **slim)
        tapped = EfficientNet(variant="b5", tpu_optimized=True, feature_taps=(26, 37))
    assert {k: tuple(t.shape) for k, t in port.state_dict().items()} == want
    assert "tpu_front_block_1.se.reduce.kernel" in want and "block_7.bn1.scale" not in want
    assert want["block_8.expand_conv.kernel"] == (256, 128, 1, 1)
    assert tapped.tap_channels() == [128, 512, 2048]


def test_flagship_guards_and_drop_rates():
    """Taps inside the replaced front and the fused route raise, as the JAX
    asserts do; deep blocks' drop rates count the original 39 blocks, the
    front's are 0."""
    with pytest.raises(ValueError, match="removed front"):
        EfficientNet(variant="b5", tpu_optimized=True, feature_taps=(7, 26))
    with pytest.raises(ValueError, match="own layout regime"):
        EfficientNet(variant="b0", tpu_optimized=True, fused_mbconv=True)
    m = EfficientNet(variant="b5", tpu_optimized=True, drop_connect_rate=0.2)
    assert m.skip == 8 and m.block_8.drop_rate == pytest.approx(0.2 * 8 / 39)
    assert m.block_38.drop_rate == pytest.approx(0.2 * 38 / 39)
    assert m.tpu_front_block_0.drop_rate == 0.0
    with pytest.raises(ValueError, match="/4 dims"):
        EfficientNet(variant="b0", tpu_optimized=True)(torch.zeros(1, 62, 48, 1))


@pytest.mark.parametrize("compat,trimmed,slim,amp_attn", [
    (True, False, None, True), (False, False, None, True), (False, True, None, True),
    (False, False, {5: 768, 7: 2048}, False)])
def test_bench_recipe_config_matches_jax(compat, trimmed, slim, amp_attn):
    """Field by field; the port's compat recipe also turns ``fused_mbconv`` on
    (the CUDA kernel), which the flagship refuses."""
    got = recipes.bench_recipe_config(compat=compat, trimmed=trimmed, amp_attn=amp_attn,
                                      slim=slim).to_dict()
    want = jax_recipes.bench_recipe_config(compat=compat, trimmed=trimmed, amp_attn=amp_attn,
                                           slim=slim).to_dict()
    if compat:
        assert got["model"]["image_encoder"].pop("fused_mbconv") is True
    assert got == want
    assert recipes.default_steps_per_call(compat) == jax_recipes.default_steps_per_call(compat)
    assert (recipes.TRIMMED_SLIM, recipes.BENCH_BATCH) == (jax_recipes.TRIMMED_SLIM,
                                                          jax_recipes.BENCH_BATCH)
    for kw in (dict(compat=True, trimmed=True), dict(compat=True, slim={3: 256}),
               dict(compat=False, trimmed=True, slim={3: 256})):
        with pytest.raises(ValueError):
            recipes.bench_recipe_config(**kw)


def test_build_bench_train_flagship_steps_k_at_a_time():
    """``build_bench_train`` on a tiny flagship: bf16 augmentation output (read
    from the cfg's ``tpu_optimized``), the K-step call, and the recipe's peak LR
    after its warm-up."""
    cfg = tiny_test_config()
    cfg.model.image_encoder.tpu_optimized = True
    model, _, state, preprocess, step = recipes.build_bench_train(cfg, k_steps=2, device="cpu")
    g = torch.Generator().manual_seed(0)
    n, s = 2, cfg.data.text_max_length
    batch = {"images": 255 * torch.rand(2, n, H, H, 1, generator=g),
             "image_views": 255 * torch.rand(2, n, H, H, 1, generator=g)}
    for suffix in ("", "2"):
        batch["input_ids" + suffix] = torch.randint(1, 100, (2, n, s), generator=g)
        batch["attention_mask" + suffix] = torch.ones(2, n, s, dtype=torch.long)
    assert preprocess({k: v[0] for k, v in batch.items()}, g)["images"].dtype == torch.bfloat16
    state, loss = step(state, batch, g)
    assert state.step == 2 and math.isfinite(float(loss["total"]))
    assert state.optimizer.schedule(recipes.BENCH_WARMUP_STEPS) == pytest.approx(
        cfg.optimizer.lr, rel=1e-6)


@functools.lru_cache(maxsize=None)
def _clip_trees():
    """A tiny compat CLIP's tree (every leaf perturbed, so the saliency ranks
    real magnitudes) and a tiny flagship CLIP's, from the port's init."""
    cfg = tiny_test_config()
    compat = build_model(cfg.model.to_dict(), device="cpu")
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for t in list(compat.parameters()) + list(compat.buffers()):
            t.add_(0.05 * torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
            if t.dim() == 1:
                t.abs_()  # BN variances stay positive
    cfg.model.image_encoder.tpu_optimized = True
    flag = build_model(cfg.model.to_dict(), device="cpu",
                       generator=torch.Generator().manual_seed(4))
    return compat.state_dict(), flag.state_dict()


@pytest.mark.parametrize("method", ["importance", "slab"])
def test_flagship_warm_start_bit_exact(method):
    """The port's numpy ``flagship_warm_start`` against JAX's ``importance``
    method on the same compat and flagship trees: every leaf bit for bit. The
    tiny b0 has shrunk widths (192 -> 128, 320 -> 256, expanded 672 -> 640) and
    grown ones. The port keeps no ``slab`` method (first-N truncation, which no
    entry point of the JAX package uses either): its case holds the port's
    overlay alone, the step after the channel selection, to JAX's ``slab``
    bit for bit, and shows that the saliency picked other channels."""
    compat_sd, flag_sd = _clip_trees()
    compat, flag = variables_from_state_dict(compat_sd), variables_from_state_dict(flag_sd)
    want_sd = state_dict_from_jax(_np_tree(
        jax_flagship_init.flagship_warm_start(compat, flag, method=method)))
    if method == "importance":
        got_sd = state_dict_from_jax(flagship_init.flagship_warm_start(compat, flag))
        # on the port's state dicts: the same tensors
        from_sd = flagship_init.warm_start_state_dict(compat_sd, flag_sd)
        assert from_sd.keys() == want_sd.keys()
        for k, t in from_sd.items():
            assert torch.equal(t, want_sd[k]), k
    else:
        got_sd = state_dict_from_jax({col: flagship_init._overlay(compat.get(col, {}), tree)
                                      for col, tree in _np_tree(flag).items()})
        picked = state_dict_from_jax(flagship_init.flagship_warm_start(compat, flag))
        assert not torch.equal(picked["image_encoder.block_15.project_conv.kernel"],
                               got_sd["image_encoder.block_15.project_conv.kernel"])
    assert got_sd.keys() == want_sd.keys() == flag_sd.keys()
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k
    assert torch.equal(got_sd["logit_scale"], compat_sd["logit_scale"])
    assert torch.equal(got_sd["image_encoder.tpu_stem_conv.kernel"],
                       flag_sd["image_encoder.tpu_stem_conv.kernel"])


def _compat_checkpoint(path, logit_scale=1.2345):
    compat_sd, _ = _clip_trees()
    cfg = tiny_test_config()
    model = build_model(cfg.model.to_dict(), device="cpu")
    model.load_state_dict({**compat_sd, "logit_scale": torch.tensor(logit_scale)})
    from mammo_clip_tpu_torch.train import build_optimizer, create_train_state

    opt = build_optimizer({"name": "adamw"}, lambda s: 1e-3, model.named_parameters())
    save_checkpoint(str(path), create_train_state(model, opt), config=cfg.to_dict(),
                    max_to_keep=1)
    return str(path)


def _flagship_cfg(**optimizer):
    cfg = tiny_test_config()
    cfg.model.image_encoder.tpu_optimized = True
    cfg.scheduler.update(epochs=1, warmup_epochs=0)
    cfg.train.update(dtype="float32", log_every=1)
    cfg.optimizer.update(warm_start_lr_scale=0.25, **optimizer)
    return cfg


def _tiny_batches(cfg, n_batches, n=2):
    g = torch.Generator().manual_seed(5)
    h, w, s = cfg.data.image_size_h, cfg.data.image_size_w, cfg.data.text_max_length
    out = []
    for _ in range(n_batches):
        b = {"images": 255 * torch.rand(n, h, w, 1, generator=g),
             "input_ids": torch.randint(1, 100, (n, s), generator=g),
             "attention_mask": torch.ones(n, s, dtype=torch.long)}
        out.append(b)
    return out


def test_trainer_fit_warm_starts_with_lr_scale(tmp_path):
    """``Trainer.fit(warm_start_from=...)`` from a port compat checkpoint, as the
    JAX package's tests/test_trainer.py::test_trainer_flagship_warm_start: the
    LR scale 0.25 reaches the schedule's peak, and the model carries the compat
    ``logit_scale``. The seeded values land in the tensors the optimizer holds:
    after one AdamW step each seeded leaf sits within one step (the scaled peak
    LR, plus weight decay) of the warm start's value, and has moved."""
    ckpt = _compat_checkpoint(tmp_path / "compat_best")
    cfg = _flagship_cfg()
    trainer = trainer_mod.Trainer(cfg, workdir=str(tmp_path / "run"), device="cpu")
    seen = {}
    build = trainer._build_state

    def spy(spe, lr_scale=1.0):
        seen["lr_scale"] = lr_scale
        return build(spe, lr_scale=lr_scale)

    trainer._build_state = spy
    seeded = flagship_init.warm_start_state_dict(
        _clip_trees()[0] | {"logit_scale": torch.tensor(1.2345)}, trainer.model.state_dict())
    batches = _tiny_batches(cfg, 1)
    state = trainer.fit(lambda e: iter(batches), None, steps_per_epoch=1,
                        warm_start_from=ckpt)
    assert seen["lr_scale"] == 0.25 and state.step == 1
    lr = 0.25 * cfg.optimizer.lr
    assert trainer._schedule(0) == pytest.approx(lr, rel=1e-6)
    after = dict(trainer.model.named_parameters())
    for key in ("logit_scale", "image_encoder.block_15.project_conv.kernel",
                "image_encoder.block_3.expand_conv.kernel",
                "text_encoder.layer_0.attention.query.kernel"):
        moved = (after[key].detach() - seeded[key]).abs()
        top = float(seeded[key].abs().max())  # + 2 fp32 ulps of the largest value
        bound = lr * (1.0 + 1e-3 + cfg.optimizer.weight_decay * top) + 2.4e-7 * top
        assert 0 < float(moved.max()) <= bound, key
    assert abs(trainer.model.logit_scale.item() - 1.2345) <= lr * 1.01 + 1e-6


def test_r9_warm_start_ema_jax_fresh_port_seeded(tmp_path, monkeypatch):
    """Fault R9 of the reference: JAX ``Trainer.fit`` replaces params and
    batch_stats after the warm start and leaves ``ema_params`` at the fresh
    init, so with ``optimizer.ema_decay`` validation and ``best/`` judge
    unseeded weights. The port seeds the EMA from the warm-started parameters.
    Both trainers are stopped at the resume that follows the warm start. On the
    JAX side the model init (``create_train_state``'s jitted init) returns the
    port's tiny flagship tree and ``load_clip_for_eval`` returns the compat
    tree, so no JAX program is compiled, and its metrics logger is off; the
    warm-start lines run as they are.
    The two schedules, both scaled by 0.25, agree."""
    class Stop(Exception):
        pass

    captured = {}

    def stop_at_resume(key):
        def stop(directory, state, *a, **k):
            captured[key] = state
            raise Stop
        return stop

    compat_sd, flag_sd = _clip_trees()
    compat_sd = compat_sd | {"logit_scale": torch.tensor(1.2345)}
    fresh_logit = float(flag_sd["logit_scale"])
    cfg = _flagship_cfg(ema_decay=0.999)

    # JAX: the real fit up to its resume
    compat_vars, flag_vars = (variables_from_state_dict(compat_sd),
                              variables_from_state_dict(flag_sd))

    class FixedInit:
        def init(self, rngs, batch, train=False):
            return flag_vars

    real_create = jax_trainer.create_train_state
    monkeypatch.setattr(jax_trainer, "create_train_state",
                        lambda model, *a, **k: real_create(FixedInit(), *a, **k))
    import mammo_clip_tpu.eval.loading as jax_loading

    monkeypatch.setattr(jax_loading, "load_clip_for_eval",
                        lambda path, *a, **k: (None, compat_vars, None))
    monkeypatch.setattr(jax_trainer, "restore_checkpoint", stop_at_resume("jax"))
    # its TensorBoard writer imports TensorFlow (~15 s); the JSONL mirror is enough
    monkeypatch.setattr(jax_trainer, "MetricsLogger",
                        lambda workdir, enabled=True: JaxMetricsLogger(workdir, enabled=False))
    jt = jax_trainer.Trainer(JaxConfig(cfg.to_dict()), workdir=str(tmp_path / "jax"))
    batch = {k: v.numpy() for k, v in _tiny_batches(cfg, 1)[0].items()}
    with pytest.raises(Stop):
        jt.fit(lambda e: iter([batch]), None, steps_per_epoch=1, resume=True,
               warm_start_from="compat")
    js = captured["jax"]
    assert float(js.params["logit_scale"]) == pytest.approx(1.2345)
    assert float(js.ema_params["logit_scale"]) == pytest.approx(fresh_logit)  # R9
    assert float(js.eval_variables()["params"]["logit_scale"]) == pytest.approx(fresh_logit)

    # the port: the EMA starts from the seeded parameters
    ckpt = _compat_checkpoint(tmp_path / "compat_best")
    monkeypatch.setattr(trainer_mod, "restore_checkpoint", stop_at_resume("port"))
    pt = trainer_mod.Trainer(cfg, workdir=str(tmp_path / "port"), device="cpu")
    with pytest.raises(Stop):
        pt.fit(lambda e: iter(_tiny_batches(cfg, 1)), None, steps_per_epoch=1, resume=True,
               warm_start_from=ckpt)
    ps = captured["port"]
    assert float(ps.ema["logit_scale"]) == pytest.approx(1.2345)
    for name, p in pt.model.named_parameters():
        assert torch.equal(ps.ema[name], p.detach()), name
    for s in (0, 1):
        assert pt._schedule(s) == pytest.approx(float(jt._schedule(s)), rel=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_downstream_trees():
    ie = {"name": "efficientnet-b0", "in_channels": 1, "tpu_optimized": True}
    x = np.zeros((1, 64, 64, 1), np.float32)
    out = []
    for m in (JaxClassifier(image_encoder_config=ie, num_classes=1),
              JaxRetinaNet(image_encoder_config=ie, num_classes=3)):
        shapes = jax.eval_shape(lambda x: m.init({"params": jax.random.PRNGKey(0)}, x,
                                                 train=False), x)
        out.append({k: tuple(t.shape) for k, t in state_dict_from_jax(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes)).items()})
    return out


def test_flagship_checkpoint_backs_classifier_and_retinanet():
    """JAX tests/test_downstream.py::test_flagship_checkpoint_backs_downstream_models:
    a flagship CLIP's config builds the classifier's and the detector's encoder
    (the trees name for name and shape for shape as the JAX modules',
    ``eval_shape``), the CLIP's encoder weights load into both, the detector's
    FPN takes the flagship's tap widths, and gradients reach the backbone
    through the focal loss, finite."""
    _, flag_sd = _clip_trees()
    enc = image_encoder_state(flag_sd)
    ie = {"name": "efficientnet-b0", "in_channels": 1, "tpu_optimized": True}
    jclf, jdet = _jax_downstream_trees()
    gen = torch.Generator().manual_seed(7)
    clf = MammoClassifier(ie, num_classes=1)
    init_parameters(clf, gen)
    assert {k: tuple(v.shape) for k, v in clf.state_dict().items()} == jclf
    clf.image_encoder.load_state_dict(enc)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 64, 64, 1)).astype(
        np.float32))
    assert clf(x)["logits"].shape == (2, 1)

    det = RetinaNet(ie, num_classes=3)
    init_heads(det, gen)
    assert {k: tuple(v.shape) for k, v in det.state_dict().items()} == jdet
    det.image_encoder.load_state_dict(enc)
    assert det.image_encoder.tap_channels() == [128, 256, 1280]
    o = det(x)
    anchors = torch.from_numpy(anchors_for((64, 64)))
    assert o["class_probs"].shape == (2, anchors.shape[0], 3)
    ann = torch.tensor([[[4.0, 4.0, 20.0, 20.0, 0.0]]]).expand(2, 1, 5)
    focal_loss(o["class_probs"], o["box_deltas"], anchors, ann)["total"].backward()
    g = det.image_encoder.tpu_stem_conv.kernel.grad
    assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0
