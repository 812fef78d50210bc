"""The port's model modules against the JAX package, weights carried over with
``mammo_clip_tpu_torch/convert/from_jax.py``: EfficientNet in train mode
(outputs, every gradient, running-statistics updates) and eval mode, on the
unfused and the fused route; BERT; the CLIP embeddings; the losses.

Everything runs in fp32 on the CPU. Tolerances: 1e-4 on forward values (same
fp32 math, different summation order in convs and reductions); gradients
within 1e-4 of the global gradient norm per tensor, because several
parameters (a bn2 bias feeding the next block's BatchNorm) have true gradients
of ~0 that both sides only resolve to rounding noise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mammo_clip_tpu.core.config import tiny_test_config as jax_tiny_config
from mammo_clip_tpu.losses import build_loss as jax_build_loss
from mammo_clip_tpu.models import build_model as jax_build_model
from mammo_clip_tpu.models.bert import BertConfig as JaxBertConfig
from mammo_clip_tpu.models.bert import BertEncoder as JaxBert
from mammo_clip_tpu.models.bert import pool_text as jax_pool_text
from mammo_clip_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from mammo_clip_tpu_torch.convert.from_jax import load_jax_variables, state_dict_from_jax
from mammo_clip_tpu_torch.core.config import tiny_test_config
from mammo_clip_tpu_torch.losses import build_loss
from mammo_clip_tpu_torch.models import build_model
from mammo_clip_tpu_torch.models.bert import BertConfig, BertEncoder, pool_text
from mammo_clip_tpu_torch.models.efficientnet import EfficientNet


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel
    processes, and torch's default of one thread per core in each oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


IMG = np.random.default_rng(0).standard_normal((2, 64, 44, 1)).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grads_close(named_params, jax_grads, tol=1e-4):
    ref = state_dict_from_jax({"params": _np_tree(jax_grads)})
    scale = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for name, p in named_params:
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=1e-3,
                                   atol=tol * scale, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_efficientnet():
    """b0 at 64x44 (stage-2 maps 16x11: the fused route pads W): init, one
    train-mode value_and_grad with the new batch stats, and eval outputs."""
    m = JaxEfficientNet(variant="b0", drop_connect_rate=0.0)
    v = jax.jit(lambda x: m.init({"params": jax.random.PRNGKey(0)}, x, False))(IMG)

    def loss(variables, x):
        out, mut = m.apply(variables, x, True, mutable=["batch_stats"])
        return jnp.sum(out["pooled"] ** 2), (out["pooled"], mut["batch_stats"])

    (l, (pooled, bs)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(v, IMG)
    ev = jax.jit(lambda v, x: m.apply(v, x, False))(v, IMG)
    return _np_tree(v), float(l), np.asarray(pooled), _np_tree(bs), g["params"], _np_tree(ev)


def _port_efficientnet(fused):
    v = _jax_efficientnet()[0]
    m = EfficientNet(variant="b0", drop_connect_rate=0.0, fused_mbconv=fused)
    load_jax_variables(m, v)
    return m


@pytest.mark.parametrize("fused", [False, True])
def test_efficientnet_train_matches_jax(fused):
    _, loss, pooled, bs, grads, _ = _jax_efficientnet()
    m = _port_efficientnet(fused)
    out = m(torch.from_numpy(IMG), train=True)
    lt = (out["pooled"] ** 2).sum()
    lt.backward()
    np.testing.assert_allclose(lt.item(), loss, rtol=1e-5)
    np.testing.assert_allclose(out["pooled"].detach().numpy(), pooled, rtol=1e-4, atol=1e-4)
    _grads_close(m.named_parameters(), grads)
    # running statistics after one train call: m * old + (1 - m) * biased batch stats
    new = state_dict_from_jax({"batch_stats": bs})
    sd = m.state_dict()
    for k, want in new.items():
        np.testing.assert_allclose(sd[k].numpy(), want.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("fused", [False, True])
def test_efficientnet_eval_matches_jax(fused):
    ev = _jax_efficientnet()[5]
    m = _port_efficientnet(fused)
    with torch.no_grad():
        out = m(torch.from_numpy(IMG), train=False)
    np.testing.assert_allclose(out["pooled"].numpy(), ev["pooled"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["features"].numpy(), ev["features"], rtol=1e-4, atol=1e-4)
    assert list(out["endpoints"]) == list(ev["endpoints"])
    for k, want in ev["endpoints"].items():
        assert out["endpoints"][k].shape == want.shape, k
        np.testing.assert_allclose(out["endpoints"][k].numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_efficientnet_parameter_tree_matches_b5():
    """B5 at the recipe's widths: the port declares exactly the JAX tree."""
    x = np.zeros((1, 64, 64, 1), np.float32)
    shapes = jax.eval_shape(
        lambda x: JaxEfficientNet(variant="b5").init({"params": jax.random.PRNGKey(0)}, x,
                                                     False), x)
    want = {k: tuple(t.shape) for k, t in state_dict_from_jax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    got = {k: tuple(t.shape) for k, t in EfficientNet(variant="b5").state_dict().items()}
    assert got == want


def test_bert_matches_jax_forward_gradient_and_pooling():
    cfg = JaxBertConfig.tiny()
    rng = np.random.default_rng(1)
    ids = rng.integers(1, cfg.vocab_size, size=(3, 16)).astype(np.int32)
    mask = (np.arange(16)[None, :] < np.array([[16], [9], [3]])).astype(np.int32)
    jm = JaxBert(cfg)
    v = jm.init({"params": jax.random.PRNGKey(2)}, ids, mask)

    def f(params):
        h = jm.apply({"params": params}, ids, mask)
        return jnp.sum(jax_pool_text(h, mask, "eos") ** 2), h

    (l, h), g = jax.value_and_grad(f, has_aux=True)(v["params"])
    tm = BertEncoder(BertConfig.tiny())
    load_jax_variables(tm, _np_tree(v))
    ht = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    lt = (pool_text(ht, torch.from_numpy(mask), "eos") ** 2).sum()
    lt.backward()
    np.testing.assert_allclose(ht.detach().numpy(), np.asarray(h), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lt.item(), float(l), rtol=1e-5)
    _grads_close(tm.named_parameters(), g)
    for pooling in ("bos", "mean"):
        np.testing.assert_allclose(
            pool_text(ht, torch.from_numpy(mask), pooling).detach().numpy(),
            np.asarray(jax_pool_text(h, mask, pooling)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("options", [("fused_qkv",), ("amp_attn_scores",),
                                     ("fused_qkv", "amp_attn_scores")])
def test_bert_options_match_jax_in_bf16(options, monkeypatch):
    """``fused_qkv`` and ``amp_attn_scores`` with bf16 activations (fp32
    parameters) against the JAX BERT with the same options and weights: the
    hidden states within the JAX package's own bf16 bounds for these options
    (tests/test_convert.py: atol 0.15, mean |diff| < 0.02), every parameter
    gradient within 2e-2 of the largest (a few bf16 roundings, 2^-8 each, on
    either side). With ``fused_qkv`` the three separate products must not run."""
    opts = dict.fromkeys(options, True)
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), **opts)
    rng = np.random.default_rng(1)
    ids = rng.integers(1, jcfg.vocab_size, size=(3, 16)).astype(np.int32)
    mask = (np.arange(16)[None, :] < np.array([[16], [9], [3]])).astype(np.int32)
    jm = JaxBert(jcfg, dtype=jnp.bfloat16)
    v = jm.init({"params": jax.random.PRNGKey(2)}, ids, mask)

    def f(params):
        h = jm.apply({"params": params}, ids, mask)
        return jnp.sum(jax_pool_text(h, mask, "eos").astype(jnp.float32) ** 2), h

    (l, h), g = jax.value_and_grad(f, has_aux=True)(v["params"])
    tm = BertEncoder(dataclasses.replace(BertConfig.tiny(), **opts), dtype=torch.bfloat16)
    load_jax_variables(tm, _np_tree(v))
    if "fused_qkv" in options:
        for i in range(2):
            for name in ("query", "key", "value"):
                dense = getattr(getattr(tm, f"layer_{i}").attention, name)
                monkeypatch.setattr(dense, "forward", lambda x: pytest.fail("unfused Q/K/V"))
    ht = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert ht.dtype == torch.bfloat16
    lt = (pool_text(ht, torch.from_numpy(mask), "eos").float() ** 2).sum()
    lt.backward()
    diff = np.abs(ht.detach().float().numpy() - np.asarray(h, np.float32))
    assert diff.max() < 0.15 and diff.mean() < 0.02, (diff.max(), diff.mean())
    np.testing.assert_allclose(lt.item(), float(l), rtol=1e-2)
    _grads_close(tm.named_parameters(), g, tol=2e-2)


def test_bert_amp_scores_keep_masked_keys_out_in_bf16():
    """``attention`` with bf16 scores gives masked keys zero weight and the
    fp32-score result to bf16 resolution; in fp32 the option changes nothing."""
    from mammo_clip_tpu_torch.models.bert import attention

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 8, 16, generator=g) for _ in range(3))
    mask = torch.ones(2, 8, dtype=torch.bool)
    mask[1, 5:] = False
    v_masked = v.clone()
    v_masked[1, :, 5:] = 1e4  # would dominate the output if a masked key leaked in
    for dtype in (torch.float32, torch.bfloat16):
        base = attention(q.to(dtype), k.to(dtype), v.to(dtype), mask, amp_scores=False)
        amp = attention(q.to(dtype), k.to(dtype), v_masked.to(dtype), mask, amp_scores=True)
        assert amp.dtype == dtype
        torch.testing.assert_close(amp.float(), base.float(), atol=2e-2 if dtype != torch.float32
                                   else 0.0, rtol=0.0)


def test_bert_seq_parallel_raises_and_options_follow_the_model_config():
    from mammo_clip_tpu_torch.models.clip import bert_config_from_model_config

    mc = tiny_test_config().model.to_dict()
    for key in ("fused_qkv", "amp_attn_scores", "seq_parallel"):
        t = dict(mc["text_encoder"], **{key: True})
        assert getattr(bert_config_from_model_config(dict(mc, text_encoder=t)), key) is True
    mc["text_encoder"]["seq_parallel"] = True
    with pytest.raises(NotImplementedError, match="queue 9"):
        build_model(mc, device="cpu")


def _clip_batch(cfg, n=4, seed=3):
    rng = np.random.default_rng(seed)
    h, w, s = cfg.data.image_size_h, cfg.data.image_size_w, cfg.data.text_max_length
    ids = rng.integers(1, cfg.model.text_encoder.vocab_size, size=(n, s)).astype(np.int32)
    lengths = rng.integers(2, s + 1, size=n)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return {"images": rng.standard_normal((n, h, w, 1)).astype(np.float32),
            "image_views": rng.standard_normal((n, h, w, 1)).astype(np.float32),
            "input_ids": ids, "attention_mask": mask,
            "input_ids2": ids[::-1].copy(), "attention_mask2": mask[::-1].copy()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def test_clip_embeddings_and_loss_match_jax():
    """Eval-mode CLIP embeddings of the tiny config and the multi-positive loss
    on them, with the JAX tree loaded into the port."""
    jcfg = jax_tiny_config()
    batch = _clip_batch(jcfg)
    jm = jax_build_model(jcfg.model.to_dict())
    v = jax.jit(lambda b: jm.init({"params": jax.random.PRNGKey(4)}, b, train=False))(batch)
    out = jax.jit(lambda v, b: jm.apply(v, b, train=False))(v, batch)
    jloss = jax_build_loss(jcfg.loss.to_dict())(out, batch, False)

    cfg = tiny_test_config()
    tm = build_model(cfg.model.to_dict(), device="cpu")
    load_jax_variables(tm, _np_tree(v))
    with torch.no_grad():
        tout = tm(_torch_batch(batch), train=False)
    tloss = build_loss(cfg.loss.to_dict())(tout, _torch_batch(batch), False)
    for k in ("image_embeddings", "text_embeddings", "text_embeddings2",
              "image_view_embeddings", "logit_scale"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(out[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert set(tloss) == set(jloss)
    for k in jloss:
        np.testing.assert_allclose(float(tloss[k]), float(jloss[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["breast_clip", "breast_clip_contrastive"])
@pytest.mark.parametrize("smoothing,is_train", [(0.0, True), (0.1, True), (0.1, False)])
def test_losses_match_jax(kind, smoothing, is_train):
    rng = np.random.default_rng(5)
    emb = {k: rng.standard_normal((6, 8)).astype(np.float32) for k in
           ("image_embeddings", "text_embeddings", "text_embeddings2",
            "image_view_embeddings")}
    emb = {k: v / np.linalg.norm(v, axis=-1, keepdims=True) for k, v in emb.items()}
    emb["logit_scale"] = np.float32(1 / 0.07)
    cfg = {kind: {"label_smoothing": smoothing, "loss_ratio": 0.7}}
    want = jax_build_loss(cfg)({k: jnp.asarray(v) for k, v in emb.items()}, {}, is_train)
    got = build_loss(cfg)({k: torch.tensor(v) for k, v in emb.items()}, {}, is_train)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_bert_config_follows_model_config():
    from mammo_clip_tpu.models.clip import bert_config_from_model_config as jax_bc
    from mammo_clip_tpu_torch.models.clip import bert_config_from_model_config

    mc = jax_tiny_config().model.to_dict()
    want = dataclasses.asdict(jax_bc(mc))
    got = dataclasses.asdict(bert_config_from_model_config(mc))
    assert {k: got[k] for k in got} == {k: want[k] for k in got}


def test_mlp_projection_head_matches_jax():
    from mammo_clip_tpu.models.projection import MLPProjectionHead as JaxMLP
    from mammo_clip_tpu_torch.models.projection import MLPProjectionHead

    x = np.random.default_rng(6).standard_normal((5, 24)).astype(np.float32)
    jm = JaxMLP(proj_dim=16)
    v = jm.init({"params": jax.random.PRNGKey(7)}, x)
    tm = MLPProjectionHead(24, 16)
    load_jax_variables(tm, _np_tree(v))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply(v, x)), rtol=1e-4, atol=1e-5)


def test_bert_remat_gives_the_same_values_and_gradients():
    cfg = BertConfig.tiny()
    ids = torch.from_numpy(np.random.default_rng(8).integers(1, cfg.vocab_size, (2, 16)))
    mask = torch.ones(2, 16, dtype=torch.long)
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        m = BertEncoder(dataclasses.replace(cfg, remat=remat, dropout_rate=0.0))
        for p in m.parameters():
            torch.nn.init.normal_(p, std=0.05)
        h = m(ids, mask, train=True)
        h.square().sum().backward()
        runs.append((h.detach(), [p.grad for p in m.parameters()]))
    torch.testing.assert_close(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b)


def test_drop_delta_keeps_each_sample_with_probability_one_minus_rate():
    from mammo_clip_tpu_torch.ops.stochastic import drop_delta

    d = drop_delta(20000, 0.2, torch.Generator().manual_seed(0), "cpu")
    assert set(np.unique(d.numpy()).round(6)) == {0.0, 1.25}
    assert abs((d > 0).float().mean().item() - 0.8) < 4.5 * np.sqrt(0.16 / 20000)
    assert torch.equal(drop_delta(3, 0.0, None, "cpu"), torch.ones(3))
