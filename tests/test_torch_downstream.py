"""The port's downstream classifier path against the JAX package, on the CPU.

* the classification losses (``pos_weight``, negative labels, CE) over seeds;
* ``MammoClassifier`` and ``MammoEfficientNetClassifier`` in eval mode on a b0
  at 64x48, fp32, from one JAX init carried across by ``convert/from_jax``:
  logits within 1e-5;
* two lp and two ft steps of ``make_classifier_steps`` (the port's ft encoder
  on the fused route, whose CPU path is the kernel's plain version): loss,
  head, encoder parameters and BatchNorm running statistics within 1e-5 after
  each step; in lp the encoder is bit for bit unchanged and within 1e-7 of the
  JAX package's (whose AdamW also decays the frozen leaves, by 5e-9 relative
  at lr 5e-5: below fp32's resolution);
* ``train_classifier`` (lp, 2 epochs x 2 steps, RSNA aggregation) against the
  JAX one: history within 1e-6, the same best epoch and step, the same
  ``arrays.npz``; then its resume;
* SGD and Adam against optax over 3 steps, the Batcher's ``sample_weights``
  draw against the JAX Batcher's, and the RSNA aggregation against pandas'
  with integer patient ids of unequal length.

The JAX side is computed once per file (``jax_runs``). Augmentation is off
(every p at 0) and ``drop_connect_rate`` is 0, since torch and JAX draw
differently (``test_torch_augment.py`` holds the draws' distribution).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from mammo_clip_tpu.data.pipeline import Batcher as JaxBatcher
from mammo_clip_tpu.downstream import classify as jax_classify
from mammo_clip_tpu.downstream import experiments as jax_experiments
from mammo_clip_tpu.losses import classification as jax_losses
from mammo_clip_tpu.losses.combined import build_loss as jax_build_loss
from mammo_clip_tpu.ops.augment import AugmentConfig as JaxAugmentConfig
from mammo_clip_tpu.train.checkpoint import load_checkpoint_arrays as jax_load_arrays
from mammo_clip_tpu.train.optim import build_optimizer as jax_build_optimizer
from mammo_clip_tpu.train.schedule import warmup_cosine_sq_schedule as jax_schedule
from mammo_clip_tpu.train.state import TrainState as JaxTrainState
from mammo_clip_tpu_torch.convert.from_jax import (
    load_jax_variables,
    state_dict_from_jax,
    variables_from_state_dict,
)
from mammo_clip_tpu_torch.data.metadata import Table
from mammo_clip_tpu_torch.data.pipeline import Batcher
from mammo_clip_tpu_torch.downstream.classify import (
    MammoClassifier,
    MammoEfficientNetClassifier,
    POS_WEIGHTS,
    aggregate_rsna_predictions,
    group_means,
    rsna_aggregator,
)
from mammo_clip_tpu_torch.downstream.experiments import (
    _make_preprocess,
    make_classifier_steps,
    train_classifier,
)
from mammo_clip_tpu_torch.losses import build_loss
from mammo_clip_tpu_torch.losses.classification import bce_with_logits_loss, softmax_ce_loss
from mammo_clip_tpu_torch.models import init_parameters
from mammo_clip_tpu_torch.ops.augment import AugmentConfig
from mammo_clip_tpu_torch.train import build_optimizer, create_train_state
from mammo_clip_tpu_torch.train.checkpoint import load_checkpoint_arrays
from mammo_clip_tpu_torch.train.schedule import warmup_cosine_sq_schedule

H, W, N = 64, 48, 4
ENC = {"name": "efficientnet-b0", "in_channels": 1, "drop_connect_rate": 0.0}
NO_AUG = dict(hflip_p=0.0, vflip_p=0.0, affine_p=0.0, elastic_p=0.0)
MEAN, STD = 0.3089279, 0.25053555
LR, WD, TOTAL = 5e-5, 1e-4, 10
POS_WEIGHT = 2.0
# the step tests' AdamW: eps 1e-3, because some encoder gradients are 0 up to
# rounding (a bias before a batch-statistics BatchNorm), and Adam's first step
# takes lr * g / (|g| + eps) of them, whose sign the rounding picks
STEP_OPT = {"name": "adamw", "lr": LR, "weight_decay": WD, "eps": 1e-3}
# validation rows of train_classifier (labels in VALID: 0 for 9/L and 7/L, 1 for
# 10/R and 123/R): integer patient ids of unequal length
VALID_IDS = [(9, "L"), (10, "R"), (9, "L"), (123, "R"), (10, "R"), (7, "L"), (7, "L"), (123, "R")]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel
    processes, and torch's default of one thread per core in each oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, H, W, 1)).astype(np.uint8)


def _batch(seed, labels):
    return {"images": _images(len(labels), seed), "labels": np.asarray(labels, np.float32)}


TRAIN = [_batch(10 + i, [0, 1, 1, 0] if i % 2 else [1, 0, 0, 1]) for i in range(2)]
VALID = [_batch(20 + i, lab) for i, lab in enumerate(([0, 1, 0, 1], [1, 0, 0, 1]))]


def _port_init(model, seed):
    """The port's init drawn from ``seed``, with BatchNorm running statistics
    that are not (0, 1); returns the JAX tree of the same weights."""
    init_parameters(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(".mean"):
                buf.copy_(torch.from_numpy(0.1 * rng.standard_normal(buf.shape)))
            elif name.endswith(".var"):
                buf.copy_(torch.from_numpy(1.0 + 0.5 * rng.random(buf.shape)))
    return variables_from_state_dict(model.state_dict())


def _jax_aggregate(ids):
    def aggregate(preds, labels, meta):
        sub = pd.DataFrame(ids[: len(preds)], columns=["patient_id", "laterality"])
        sub["pred"] = preds
        sub["label"] = labels
        agg = sub.groupby(["patient_id", "laterality"])[["pred", "label"]].mean()
        return agg["pred"].to_numpy(), agg["label"].to_numpy()
    return aggregate


def _port_aggregate(ids):
    """The CLI's aggregation (``rsna_aggregator``) over a fold of these ids."""
    return rsna_aggregator(Table(({"patient_id": p, "laterality": lat} for p, lat in ids),
                                 ("patient_id", "laterality")))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX side: eval logits of each classifier, two lp and two ft steps of
    make_classifier_steps, and a 2-epoch lp train_classifier run."""
    # one init, the port's, carried to the JAX trees (a JAX init would cost two
    # more compiles; convert/from_jax maps the trees both ways)
    clf = jax_classify.MammoClassifier(image_encoder_config=ENC)
    init = _port_init(MammoClassifier(ENC), 0)
    eff = jax_classify.MammoEfficientNetClassifier(variant="b0")
    eff_init = _port_init(MammoEfficientNetClassifier(variant="b0"), 1)
    x = np.random.default_rng(5).standard_normal((N, H, W, 1)).astype(np.float32)
    logits = {"clip": np.asarray(jax.jit(lambda v, x: clf.apply(v, x)["logits"])(init, x)),
              "gem": np.asarray(jax.jit(lambda v, x: eff.apply(v, x)["logits"])(eff_init, x))}

    aug = JaxAugmentConfig(**NO_AUG)
    pre = jax_experiments._make_preprocess(aug, MEAN, STD)
    steps = {}
    for arch in ("lp", "ft"):
        model = jax_classify.MammoClassifier(image_encoder_config=ENC,
                                             freeze_encoder=arch == "lp")
        tx = jax_build_optimizer(STEP_OPT, jax_schedule(LR, TOTAL, 0))
        state = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=init["params"],
                              batch_stats=init["batch_stats"], opt_state=tx.init(init["params"]),
                              tx=tx)
        train_step, _ = jax_experiments.make_classifier_steps(model, "bce", pre, POS_WEIGHT)
        steps[arch] = []
        for b in TRAIN:
            state, loss = train_step(state, jax.tree_util.tree_map(jnp.asarray, b),
                                     jax.random.PRNGKey(1))
            steps[arch].append((float(loss), {"params": _np(state.params),
                                              "batch_stats": _np(state.batch_stats)}))

    workdir = tmp_path_factory.mktemp("jax_clf")
    lp = jax_classify.MammoClassifier(image_encoder_config=ENC, freeze_encoder=True)
    res = jax_experiments.train_classifier(
        lp, init, lambda epoch: (jax.tree_util.tree_map(jnp.asarray, b) for b in TRAIN),
        lambda: (jax.tree_util.tree_map(jnp.asarray, b) for b in VALID),
        epochs=2, steps_per_epoch=2, lr=LR, weight_decay=WD, loss_kind="bce", aug=aug,
        mean=MEAN, std=STD, workdir=str(workdir), config={"kind": "test"},
        aggregate=_jax_aggregate(VALID_IDS))
    best = sorted(os.listdir(workdir / "best"))
    meta = json.loads((workdir / "best" / best[-1] / "meta.json").read_text())
    return dict(init=init, eff_init=eff_init, x=x, logits=logits, steps=steps, result=res,
                arrays=jax_load_arrays(str(workdir / "best")), best_step=best[-1],
                best_meta=meta)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close_state(model, want, atol, what):
    want = state_dict_from_jax(want)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=atol,
                                   err_msg=f"{what}: {k}")


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", ["bce", "bce_pos_weight", "ce"])
def test_losses_match_jax(seed, case):
    rng = np.random.default_rng(seed)
    if case == "ce":
        logits = (3 * rng.standard_normal((16, 4))).astype(np.float32)
        labels = rng.integers(0, 4, 16).astype(np.float32)  # cast to int by both
        got = softmax_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels))
        want = jax_losses.softmax_ce_loss(jnp.asarray(logits), jnp.asarray(labels))
    else:
        logits = (4 * rng.standard_normal(16)).astype(np.float32)
        labels = rng.integers(-1, 2, 16).astype(np.float32)  # -1: a missing label
        pw = POS_WEIGHTS["rsna/cancer"] if case == "bce_pos_weight" else None
        got = bce_with_logits_loss(torch.from_numpy(logits), torch.from_numpy(labels), pw)
        want = jax_losses.bce_with_logits_loss(jnp.asarray(logits), jnp.asarray(labels), pw)
        if pw is not None:  # torch's own weighted BCE on the clamped labels
            ref = torch.nn.BCEWithLogitsLoss(pos_weight=torch.tensor(pw))(
                torch.from_numpy(logits), torch.from_numpy(labels).clamp(min=0))
            np.testing.assert_allclose(got.item(), ref.item(), rtol=1e-6)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kinds", [("classification",), ("breast_clip", "classification"),
                                   ("breast_clip", "breast_clip_contrastive")])
def test_combined_loss_with_classification_matches_jax(kinds):
    """The ``classification`` kind reads outputs["cls_pred"] and
    batch["target_class"] and reports under its own key; contrastive plus
    classification is allowed, two contrastive kinds are refused."""
    rng = np.random.default_rng(1)
    config = {"breast_clip": {"i2i_weight": 1.0, "t2t_weight": 0.5, "loss_ratio": 1.0},
              "breast_clip_contrastive": {"loss_ratio": 1.0},
              "classification": {"loss_ratio": 0.5, "pos_weight": 3.0}}
    config = {k: config[k] for k in kinds}
    unit = lambda a: (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)
    arrays = {"image_embeddings": unit(rng.standard_normal((6, 8))),
              "text_embeddings": unit(rng.standard_normal((6, 8))),
              "logit_scale": np.float32(10.0),
              "cls_pred": rng.standard_normal(6).astype(np.float32)}
    batch = {"target_class": np.asarray([1, 0, -1, 1, 0, 0], np.float32)}
    if len(kinds) == 2 and "classification" not in kinds:
        for build in (build_loss, jax_build_loss):
            with pytest.raises(ValueError, match="duplicate loss output keys"):
                build(config)
        return
    got = build_loss(config)({k: torch.as_tensor(v) for k, v in arrays.items()},
                             {k: torch.from_numpy(v) for k, v in batch.items()})
    want = jax_build_loss(config)({k: jnp.asarray(v) for k, v in arrays.items()},
                                  {k: jnp.asarray(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)


# ------------------------------------------------------------------ models


def test_classifiers_forward_match_jax(jax_runs):
    x = torch.from_numpy(jax_runs["x"])
    clip = MammoClassifier(ENC)
    load_jax_variables(clip, jax_runs["init"])
    gem = MammoEfficientNetClassifier(variant="b0")
    load_jax_variables(gem, jax_runs["eff_init"])
    for name, model in (("clip", clip), ("gem", gem)):
        out = model(x, train=False)
        assert set(out) == {"logits", "pooled_features", "raw_features"}
        assert out["logits"].dtype == torch.float32 and out["logits"].shape == (N, 1)
        np.testing.assert_allclose(out["logits"].detach().numpy(), jax_runs["logits"][name],
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("arch", ["lp", "ft"])
def test_classifier_steps_match_jax(jax_runs, arch):
    # the port's ft encoder takes the fused route (its kernel's plain version
    # on the CPU); the JAX one runs its unfused blocks: the same function
    model = MammoClassifier({**ENC, "fused_mbconv": arch == "ft"},
                            freeze_encoder=arch == "lp")
    load_jax_variables(model, jax_runs["init"])
    before = {k: v.clone() for k, v in model.image_encoder.state_dict().items()}
    named = model.trainable_parameters()
    assert [n for n, _ in named] == (["head.kernel", "head.bias"] if arch == "lp"
                                     else [n for n, _ in model.named_parameters()])
    opt = build_optimizer(STEP_OPT, warmup_cosine_sq_schedule(LR, TOTAL, 0), named)
    state = create_train_state(model, opt)
    train_step, _ = make_classifier_steps(
        model, "bce", _make_preprocess(AugmentConfig(**NO_AUG), MEAN, STD), POS_WEIGHT)
    gen = torch.Generator()
    for i, b in enumerate(TRAIN):
        state, loss = train_step(state, _torch_batch(b), gen, seed=0)
        want_loss, want = jax_runs["steps"][arch][i]
        np.testing.assert_allclose(loss.item(), want_loss, rtol=0, atol=1e-5)
        _close_state(model, want, 1e-5, f"{arch} step {i + 1}")
    head = model.head.kernel.detach().numpy()
    assert not np.allclose(head, jax_runs["init"]["params"]["head"]["kernel"], atol=1e-6)
    if arch == "lp":
        for k, v in model.image_encoder.state_dict().items():
            assert torch.equal(v, before[k]), k  # frozen: parameters and statistics
        enc = {k: v for k, v in state_dict_from_jax(jax_runs["steps"]["lp"][-1][1]).items()
               if k.startswith("image_encoder.")}
        for k, w in enc.items():
            np.testing.assert_allclose(model.state_dict()[k].numpy(), w.numpy(), rtol=0,
                                       atol=1e-7, err_msg=k)
    else:
        moved = [k for k, v in model.image_encoder.state_dict().items()
                 if k.endswith(("mean", "var")) and not torch.equal(v, before[k])]
        assert moved, "the ft step updated no running statistic"


# ------------------------------------------------------------------ training loop


def _port_train(init, workdir, epochs, resume=False):
    model = MammoClassifier(ENC, freeze_encoder=True)
    load_jax_variables(model, init)
    return train_classifier(
        model, lambda epoch: (_torch_batch(b) for b in TRAIN),
        lambda: (_torch_batch(b) for b in VALID), epochs=epochs, steps_per_epoch=2, lr=LR,
        weight_decay=WD, loss_kind="bce", aug=AugmentConfig(**NO_AUG), mean=MEAN, std=STD,
        workdir=str(workdir), config={"kind": "test"}, aggregate=_port_aggregate(VALID_IDS),
        resume=resume)


def test_train_classifier_matches_jax(jax_runs, tmp_path):
    res = _port_train(jax_runs["init"], tmp_path, 2)
    want = jax_runs["result"]
    np.testing.assert_allclose(res["history"], want["history"], rtol=0, atol=1e-6)
    assert int(np.argmax(res["history"])) == int(np.argmax(want["history"]))
    assert res["best_metric"] == pytest.approx(want["best_metric"], abs=1e-6)
    best = sorted(os.listdir(tmp_path / "best"))
    assert best == [jax_runs["best_step"]]
    meta = json.loads((tmp_path / "best" / best[0] / "meta.json").read_text())
    assert meta["epoch"] == jax_runs["best_meta"]["epoch"]
    got, ref = load_checkpoint_arrays(str(tmp_path / "best")), jax_runs["arrays"]
    assert set(got) == set(ref) == {"predictions", "labels"}
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape == (4,), k
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_allclose(got["predictions"], ref["predictions"], rtol=0, atol=1e-6)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["2"]


def test_train_classifier_resumes(jax_runs, tmp_path, capsys):
    first = _port_train(jax_runs["init"], tmp_path, 1)
    res = _port_train(jax_runs["init"], tmp_path, 2, resume=True)
    assert "resumed classifier at epoch 1" in capsys.readouterr().out
    assert len(first["history"]) == 1 and len(res["history"]) == 2
    assert res["history"][0] == first["history"][0]
    assert res["best_metric"] == max(res["history"])
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["2"]
    meta = json.loads((tmp_path / "checkpoints" / "2" / "meta.json").read_text())
    assert meta["epoch"] == 2 and meta["history"] == res["history"]


# ------------------------------------------------------------------ optimizers, data


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_sgd_and_adam_match_optax(name):
    rng = np.random.default_rng(7)
    shapes = {"w": (5, 3), "b": (3,)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    cfg = {"name": name, "weight_decay": 0.05, "momentum": 0.8, "grad_clip_norm": 2.0}
    sched_args = (0.01, 10, 1)
    tx = jax_build_optimizer(cfg, jax_schedule(*sched_args))
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)
    named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy()))) for k, v in init.items()]
    opt = build_optimizer(cfg, warmup_cosine_sq_schedule(*sched_args), named)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                       params)
        params = optax.apply_updates(params, updates)
        for k, p in named:
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in named:
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} {k}")
    assert opt.count == 3


def test_sample_weights_draw_matches_jax():
    ds = [{"image": np.full((2, 2), i, np.uint8), "label": np.float32(i % 2)} for i in range(10)]
    weights = np.arange(1, 11, dtype=np.float64)
    ours = Batcher(ds, None, batch_size=3, seed=4, sample_weights=weights)
    ref = JaxBatcher(ds, None, batch_size=3, seed=4, sample_weights=weights,
                     process_index=0, process_count=1)
    for epoch in range(3):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        np.testing.assert_array_equal(ours._indices(), ref._indices())
        for a, b in zip(ours, ref):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_rsna_aggregation_matches_pandas():
    rng = np.random.default_rng(0)
    ids = [7, 10, 123, 9, 10, 7, 1000, 9, 123, 7]
    lat = ["L", "R", "L", "R", "R", "L", "L", "R", "L", "R"]
    pred = rng.random(len(ids)).astype(np.float32)
    cancer = [int(i % 2) for i in ids]
    df = pd.DataFrame({"patient_id": ids, "laterality": lat, "pred": pred, "cancer": cancer})
    want = jax_classify.aggregate_rsna_predictions(df)
    rows = Table(({"patient_id": i, "laterality": s, "pred": p, "cancer": c}
                  for i, s, p, c in zip(ids, lat, pred, cancer)),
                 ("patient_id", "laterality", "pred", "cancer"))
    got = aggregate_rsna_predictions(rows)
    assert [(r["patient_id"], r["laterality"]) for r in got] == list(
        zip(want["patient_id"], want["laterality"]))  # 7, 9, 10, 123, 1000: numeric order
    for col in ("pred", "cancer"):
        vals = np.asarray([r[col] for r in got])
        assert vals.dtype == want[col].to_numpy().dtype, col
        np.testing.assert_allclose(vals, want[col].to_numpy(), rtol=1e-7, err_msg=col)
    # string ids (as load_metadata keeps them) sort as strings, as pandas sorts them
    keys = [(str(i), s) for i, s in zip(ids, lat)]
    groups, _ = group_means(keys, {"pred": pred})
    assert groups == sorted(set(keys)) and groups[0][0] == "10"
