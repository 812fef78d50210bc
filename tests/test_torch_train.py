"""The port's training layer against the JAX package: schedule, AdamW with
masks and the global-norm clip, and whole train steps of the tiny CLIP.

The train-step test runs one and three ``make_train_step`` steps on both sides
from the same parameters (carried over with ``convert/from_jax.py``) and the
same batch, with dropout and drop-connect off and the augmentation fed the
same affine matrices and elastic field; the port takes the fused MBConv route
(its plain version on the CPU), the JAX side the Flax route, which the JAX
package's own tests hold equal to its Pallas kernel.

The step test sets AdamW's eps to 1e-3 on both sides (the recipe's 1e-8 is
held to optax by the AdamW test above). With eps 1e-8 Adam moves an element by
~lr * sign(gradient) whatever the gradient's size, so the ~0.1% of elements
whose gradient sits at the fp32 rounding floor (every bn2 bias: it feeds a
BatchNorm through a linear path, so its true gradient is 0) take coin-flip
+-lr steps on each side, and by step 3 the losses drift apart by ~1e-3; with
eps 1e-3 such elements barely move and the trajectories agree to ~1e-5.

Tolerances: losses 1e-4 relative and 1e-5 absolute (fp32 forward through ~30 layers, other
summation order); BatchNorm running statistics 1e-4; parameters 1e-5 absolute
(1% of one step's learning rate).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mammo_clip_tpu.models.clip as jax_clip
from mammo_clip_tpu.core.config import tiny_test_config as jax_tiny_config
from mammo_clip_tpu.losses import build_loss as jax_build_loss
from mammo_clip_tpu.models import build_model as jax_build_model
from mammo_clip_tpu.ops import augment as jax_aug
from mammo_clip_tpu.train import build_optimizer as jax_build_optimizer
from mammo_clip_tpu.train import create_train_state as jax_create_train_state
from mammo_clip_tpu.train import make_train_step as jax_make_train_step
from mammo_clip_tpu.train import warmup_cosine_sq_schedule as jax_schedule
from mammo_clip_tpu_torch.convert.from_jax import load_jax_variables, state_dict_from_jax
from mammo_clip_tpu_torch.core.config import tiny_test_config
from mammo_clip_tpu_torch.losses import build_loss
from mammo_clip_tpu_torch.models import build_model
from mammo_clip_tpu_torch.ops import augment
from mammo_clip_tpu_torch.train import (
    Optimizer,
    build_optimizer,
    create_train_state,
    make_train_step,
    warmup_cosine_sq_schedule,
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


LR, TOTAL, WARMUP = 1e-3, 50, 0
ADAM_EPS = 1e-3
MEAN, STD = 0.3089279, 0.25053555408335154


@pytest.mark.parametrize("total,warmup", [(100, 10), (50, 0)])
def test_schedule_matches_jax(total, warmup):
    ours = warmup_cosine_sq_schedule(5e-5, total, warmup)
    ref = jax_schedule(5e-5, total, warmup)
    for step in [0, 1, 5, 9, 10, 11, 49, 50, 99, 100]:
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6, atol=1e-12)


def test_adamw_with_mask_and_clip_matches_optax():
    """Three updates with weight decay, a no-decay pattern and an active clip."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "bias": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: (3 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    sched = jax_schedule(1e-2, 10, 1)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        sched, weight_decay=0.1, mask={"w": True, "bias": False}))
    p, s = jax.tree_util.tree_map(jnp.asarray, params), None
    s = tx.init(p)
    for g in grads:
        u, s = tx.update(jax.tree_util.tree_map(jnp.asarray, g), s, p)
        p = optax.apply_updates(p, u)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = Optimizer(tp.items(), warmup_cosine_sq_schedule(1e-2, 10, 1), weight_decay=0.1,
                    no_decay_patterns=["bias"], grad_clip_norm=1.0)
    for g in grads:
        for k, t in tp.items():
            t.grad = torch.tensor(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(p[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def _fixed_warp(batch_size, h, w, seed=7):
    """Affine matrices and an elastic field (numpy) sampled once by the JAX side."""
    cfg = jax_aug.AugmentConfig(hflip_p=0.5, vflip_p=0.5, affine_p=1.0, elastic_p=1.0)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    mats = jax_aug.sample_affine_matrices(k1, batch_size, h, w, cfg)
    disp = jax_aug.sample_elastic_displacement(k2, batch_size, h, w, cfg)
    return np.asarray(mats), np.asarray(disp)


def _batch(cfg, n=4, seed=3):
    rng = np.random.default_rng(seed)
    h, w, s = cfg.data.image_size_h, cfg.data.image_size_w, cfg.data.text_max_length
    ids = rng.integers(1, cfg.model.text_encoder.vocab_size, size=(n, s)).astype(np.int32)
    lengths = rng.integers(2, s + 1, size=n)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return {"images": rng.integers(0, 256, size=(n, h, w, 1)).astype(np.float32),
            "image_views": rng.integers(0, 256, size=(n, h, w, 1)).astype(np.float32),
            "input_ids": ids, "attention_mask": mask,
            "input_ids2": ids[:, ::-1].copy(), "attention_mask2": mask}


@pytest.fixture(scope="module")
def jax_trajectory():
    """Initial variables and the state after steps 1 and 3 of the JAX step."""
    cfg = jax_tiny_config()
    cfg.model.image_encoder.drop_connect_rate = 0.0
    cfg.optimizer.grad_clip_norm = 1.0
    cfg.optimizer.eps = ADAM_EPS
    batch = _batch(cfg)
    n, h, w = 4, cfg.data.image_size_h, cfg.data.image_size_w
    mats, disp = _fixed_warp(2 * n, h, w)

    def preprocess(b, rng):
        b = dict(b)
        both = jax_aug.minmax_standardize(jnp.concatenate([b["images"], b["image_views"]]),
                                          MEAN, STD)
        bg = (0.0 - MEAN) / STD
        coords = jax_aug.affine_grid(jnp.asarray(mats), h, w) + jnp.asarray(disp)
        out = jax_aug.warp_bilinear(both - bg, coords) + bg
        b["images"], b["image_views"] = out[:n], out[n:]
        return b

    orig = jax_clip.bert_config_from_model_config
    jax_clip.bert_config_from_model_config = lambda mc: dataclasses.replace(
        orig(mc), dropout_rate=0.0)
    try:
        model = jax_build_model(cfg.model.to_dict())
        tx = jax_build_optimizer(cfg.optimizer.to_dict(), jax_schedule(LR, TOTAL, WARMUP))
        state = jax_create_train_state(model, jax.tree_util.tree_map(jnp.asarray, batch), tx,
                                       jax.random.PRNGKey(0))
        init = {"params": state.params, "batch_stats": state.batch_stats}
        init = jax.tree_util.tree_map(np.asarray, init)
        step = jax_make_train_step(model, jax_build_loss(cfg.loss.to_dict()),
                                   preprocess=preprocess, donate=False)
        after = {}
        for i in range(1, 4):
            state, losses = step(state, batch, jax.random.PRNGKey(1))
            if i in (1, 3):
                after[i] = (jax.tree_util.tree_map(np.asarray, {
                    "params": state.params, "batch_stats": state.batch_stats}),
                    {k: float(v) for k, v in losses.items()}, jax.tree_util.tree_map(
                        np.asarray, state.params))
    finally:
        jax_clip.bert_config_from_model_config = orig
    return init, after, batch, mats, disp


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(jax_trajectory, steps):
    init, after, batch, mats, disp = jax_trajectory
    cfg = tiny_test_config()
    cfg.model.image_encoder.drop_connect_rate = 0.0
    cfg.model.image_encoder.fused_mbconv = True
    cfg.model.text_encoder.dropout_rate = 0.0
    cfg.optimizer.grad_clip_norm = 1.0
    cfg.optimizer.eps = ADAM_EPS
    model = build_model(cfg.model.to_dict(), device="cpu")
    load_jax_variables(model, init)
    opt = build_optimizer(cfg.optimizer.to_dict(), warmup_cosine_sq_schedule(LR, TOTAL, WARMUP),
                          model.named_parameters())
    state = create_train_state(model, opt)
    n = batch["images"].shape[0]

    def preprocess(b, generator):
        b = dict(b)
        both = augment.minmax_standardize(torch.cat([b["images"], b["image_views"]]), MEAN, STD)
        out = augment.apply_warp(both, torch.from_numpy(mats), torch.from_numpy(disp), MEAN, STD)
        b["images"], b["image_views"] = out[:n], out[n:]
        return b

    step = make_train_step(model, build_loss(cfg.loss.to_dict()), preprocess)
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
          for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(steps):
        state, losses = step(state, tb, gen)
    want_vars, want_losses, _ = after[steps]
    assert state.step == steps
    for k, v in want_losses.items():
        np.testing.assert_allclose(losses[k].item(), v, rtol=1e-4, atol=1e-5, err_msg=k)
    want = state_dict_from_jax(want_vars)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        if k.endswith(("mean", "var")):
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-5, err_msg=k)
