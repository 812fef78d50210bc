"""Downstream experiments: classifier fine-tuning and the detector's
steps (port of ``mammo_clip_tpu/downstream/experiments.py``).

Capability parity with the reference's experiment loop
(reference: Classifiers/experiments.py:21-456): AdamW + per-STEP warmup-cos^2
schedule (experiments.py:347-348), weighted BCE / CE losses, per-epoch AUROC
(with RSNA patient-laterality aggregation, experiments.py:171-173) or
accuracy, best-metric checkpointing with the validation predictions
persisted, and a per-epoch resume checkpoint. Augmentation runs on the
device inside the step (``ops/augment.py``); the head and the loss are fp32.

A validation batch may carry ``"n_rows"``, the count of its real rows: the
rows after them pad the batch to the fixed shape (the last batch of a fold),
and their predictions are dropped before scoring.

``make_detector_steps`` gives RetinaNet's train step (box-aware augmentation,
focal loss, the optimizer's update), its eval forward and its multi-scale
eval (reference: Detectors/experiments.py:24-273); ``cli/detector`` runs the
loop.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..core.mesh import is_master
from ..eval.metrics import accuracy, auroc
from ..losses.classification import bce_with_logits_loss, softmax_ce_loss
from ..losses.focal import focal_loss
from ..models.retinanet import detect_multiscale
from ..ops.augment import AugmentConfig, augment_batch
from ..train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..train.optim import build_optimizer
from ..train.schedule import warmup_cosine_sq_schedule
from ..train.state import TrainState, create_train_state
from ..train.step import step_seed
from ..utils.logging import MetricsLogger


def _make_preprocess(aug: AugmentConfig, mean: float, std: float):
    """On-device normalisation and (with a generator) augmentation of ``images``."""

    def preprocess(batch, generator):
        batch = dict(batch)
        batch["images"] = augment_batch(batch["images"], generator, aug, mean, std,
                                        train=generator is not None)
        return batch

    return preprocess


def make_classifier_steps(model, loss_kind: str, preprocess, pos_weight: Optional[float] = None):
    """Returns (train_step, eval_step) for MammoClassifier-style models.

    ``train_step(state, batch, generator, seed=None) -> (state, loss)``: with a
    ``seed`` the generator is first reseeded from (seed, state.step), so a
    step's draws (augmentation, then stochastic depth) depend only on them.
    The forward runs in train mode (a frozen encoder stays in eval mode) and
    applies the BatchNorm running-statistics updates. ``eval_step(state,
    batch)`` returns the probabilities: sigmoid of the logit for ``bce``,
    softmax over the classes for ``ce``."""
    if loss_kind not in ("bce", "ce"):
        raise ValueError(loss_kind)

    def loss_of(logits, labels):
        if loss_kind == "bce":
            return bce_with_logits_loss(logits[:, 0], labels, pos_weight=pos_weight)
        return softmax_ce_loss(logits, labels)

    def train_step(state: TrainState, batch, generator: torch.Generator,
                   seed: Optional[int] = None):
        if seed is not None:
            generator.manual_seed(step_seed(seed, state.step))
        b = preprocess(batch, generator)
        out = model(b["images"], train=True, generator=generator)
        loss = loss_of(out["logits"], b["labels"])
        loss.backward()
        state.apply_gradients()
        return state, loss.detach()

    def eval_step(state: TrainState, batch):
        b = preprocess(batch, None)
        with torch.no_grad():
            logits = model(b["images"], train=False)["logits"]
        if loss_kind == "bce":
            return torch.sigmoid(logits[:, 0])
        return torch.softmax(logits, dim=-1)

    return train_step, eval_step


def train_classifier(
    model,
    train_batches: Callable[[int], Iterable],
    valid_batches: Callable[[], Iterable],
    *,
    epochs: int,
    steps_per_epoch: int,
    lr: float = 5e-5,
    weight_decay: float = 1e-4,
    warmup_epochs: int = 1,
    loss_kind: str = "bce",
    pos_weight: Optional[float] = None,
    aug: Optional[AugmentConfig] = None,
    mean: float = 0.3089279,
    std: float = 0.25053555,
    workdir: Optional[str] = None,
    config: Optional[Dict] = None,
    aggregate: Optional[Callable[[np.ndarray, np.ndarray, list], tuple]] = None,
    seed: int = 0,
    resume: bool = False,
) -> Dict[str, float]:
    """Returns {'best_metric': ..., 'history': [...]}; checkpoints best into workdir.

    ``model`` holds its own weights (the JAX function's ``variables``) and is
    trained in place; the optimizer takes ``model.trainable_parameters()``,
    the head's alone in a linear probe. The best checkpoint embeds the
    validation ``predictions``/``labels`` arrays (arrays.npz sidecar) for
    offline re-scoring, and a per-epoch resume checkpoint lands in
    ``workdir/checkpoints``: parity with the reference's persisted predictions
    (Classifiers/experiments.py:193-222) plus the preemption-resume its
    30/120-epoch loops lack. ``resume=True`` picks up from the latest epoch
    checkpoint, keeping the best-metric watermark and the history."""
    total_steps = max(epochs * steps_per_epoch, 2)
    warmup_steps = min(warmup_epochs * steps_per_epoch, total_steps - 1)
    sched = warmup_cosine_sq_schedule(lr, total_steps, warmup_steps)
    tx = build_optimizer({"name": "adamw", "lr": lr, "weight_decay": weight_decay}, sched,
                         model.trainable_parameters())
    state = create_train_state(model, tx)
    preprocess = _make_preprocess(aug or AugmentConfig(), mean, std)
    train_step, eval_step = make_classifier_steps(model, loss_kind, preprocess, pos_weight)
    logger = MetricsLogger(workdir, enabled=workdir is not None and is_master())
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)

    best = -np.inf
    history = []
    start_epoch = 0
    resume_dir = f"{workdir}/checkpoints" if workdir else None
    if resume and resume_dir and latest_step(resume_dir) is not None:
        state, _, meta = restore_checkpoint(resume_dir, state)
        start_epoch = int(meta.get("epoch", 0))
        if meta.get("best_metric") is not None:
            best = float(meta["best_metric"])
        history = list(meta.get("history", []))
        print(f"resumed classifier at epoch {start_epoch} (best={best:.4f})")
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        for batch in train_batches(epoch):
            state, _ = train_step(state, batch, generator, seed)
        # ---- validation
        preds, labels, meta = [], [], []
        for batch in valid_batches():
            n = batch.get("n_rows", len(batch["labels"]))
            preds.append(eval_step(state, batch)[:n].cpu().numpy())
            labels.append(np.asarray(batch["labels"][:n].cpu()))
            if "meta" in batch:
                meta.extend(batch["meta"][:n])
        preds = np.concatenate(preds)
        labels = np.concatenate(labels)
        if aggregate is not None:
            preds, labels = aggregate(preds, labels, meta)
        if loss_kind == "bce":
            metric = auroc(labels, preds)
        else:
            metric = accuracy(labels, np.argmax(preds, axis=-1))
        history.append(metric)
        logger.log(state.step, {"metric": metric, "epoch_time": time.time() - t0},
                   prefix="valid")
        if metric > best:
            best = metric
            if workdir:
                save_checkpoint(f"{workdir}/best", state, config=config,
                                extra_meta={"epoch": epoch + 1, "metric": metric},
                                max_to_keep=1,
                                extra_arrays={"predictions": preds, "labels": labels})
        if workdir:
            save_checkpoint(resume_dir, state, config=config, step=epoch + 1,
                            extra_meta={"epoch": epoch + 1,
                                        "best_metric": None if not np.isfinite(best) else float(best),
                                        "history": [float(h) for h in history]},
                            max_to_keep=1)
    logger.close()
    return {"best_metric": float(best), "history": history}


# ------------------------------------------------------------------ detection


def make_detector_steps(model, anchors, preprocess, alpha: float = 0.25, gamma: float = 2.0):
    """Returns (train_step, infer_step, infer_multiscale) for a RetinaNet.

    ``train_step(state, batch, generator, seed=None) -> (state, losses)``:
    with a ``seed`` the generator is first reseeded from (seed, state.step);
    ``preprocess(batch, generator)`` augments images and boxes, then the
    focal loss on ``batch["annotations"]`` is backpropagated and the
    optimizer steps (the CLI's: Adam with a global-norm clip of 0.1). The
    backbone's BatchNorm statistics stay as they are (eval-mode backbone).
    ``losses`` holds detached scalars: classification, regression, total.
    ``infer_step(state, batch)`` returns the model's outputs on the
    normalized images; ``infer_multiscale(state, batch, scales,
    score_threshold, iou_threshold, nms)`` the merged detections of
    ``models/retinanet.detect_multiscale``."""
    device = next(model.parameters()).device
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=device)

    def train_step(state: TrainState, batch, generator: torch.Generator,
                   seed: Optional[int] = None):
        if seed is not None:
            generator.manual_seed(step_seed(seed, state.step))
        b = preprocess(batch, generator)
        out = model(b["images"], train=True, generator=generator)
        ld = focal_loss(out["class_probs"], out["box_deltas"], anchors, b["annotations"],
                        alpha=alpha, gamma=gamma)
        ld["total"].backward()
        state.apply_gradients()
        return state, {k: v.detach() for k, v in ld.items()}

    def infer_step(state: TrainState, batch):
        b = preprocess(batch, None)
        with torch.no_grad():
            return model(b["images"], train=False)

    def infer_multiscale(state: TrainState, batch, scales, score_threshold=0.05,
                         iou_threshold=0.5, nms="hard"):
        b = preprocess(batch, None)
        with torch.no_grad():
            return detect_multiscale(lambda imgs: model(imgs, train=False), b["images"],
                                     tuple(scales), score_threshold=score_threshold,
                                     iou_threshold=iou_threshold, nms=nms)

    return train_step, infer_step, infer_multiscale
