"""Detector CLI (port of ``mammo_clip_tpu/cli/detector.py``; reference:
src/codebase/train_detector.py:14-125).

    python -m mammo_clip_tpu_torch.cli.detector --clip-checkpoint <ckpt> \
        --csv vindr_detection_folds.csv --image-dir <pngs|shards|synthetic://> \
        [--resize 512] [--epochs 120] [--freeze-backbone] [--device cuda] ...

The JAX CLI's flags plus ``--device`` (default ``cuda``). ``--clip-checkpoint``
is a port checkpoint (a run directory or a step root such as ``best/``) or a
reference ``.tar``. RetinaNet over the CLIP image encoder (its parameters and
BatchNorm statistics copied from the checkpoint), bf16 activations, the 11
VinDr classes. Boxes come from the resized_{x,y}{min,max} columns produced by
the preprocessing remap (reference preprocess_VinDr_detector.py), padded to
(16, 5) with -1 rows (reference dataset_concepts.py:185-205). Training uses
Adam with a global-norm clip of 0.1, focal alpha/gamma 0.25/2.0 and box-aware
augmentation; evaluation is VOC mAP@0.5 over shape-static per-class NMS,
hard or soft (``--soft-nms``), at one scale or several (``--eval-scales``).

``<workdir>/best/<step>/`` keeps the validation slates and annotations in
``arrays.npz``; ``<workdir>/checkpoints/`` the per-epoch resume checkpoint with
the epoch and ``best_mAP``. Prints ``epoch N: mAP=...`` per epoch, then one
JSON line ``{"best_mAP": ...}``, and returns it.

Every validation image is scored. The JAX CLI batches validation like
training, in full batches only, so a fold of n images is scored on n - n %
batch_size of them (fault R8 in ROADMAP.md). Here the last validation batch is
padded to the fixed batch shape by repeating its last image, and the pad
images' slates are dropped before ``evaluate_map``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..data.images import open_image_store
from ..data.metadata import Table, load_metadata, split_dataframe
from ..downstream.detect import VINDR_DETECTION_CLASSES, evaluate_map
from ..downstream.experiments import make_detector_steps
from ..eval.loading import load_clip_for_eval
from ..models.retinanet import anchors_for, detect, retinanet_from_clip_checkpoint
from ..ops.augment import AugmentConfig, augment_batch, augment_batch_with_boxes
from ..train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..train.optim import build_optimizer
from ..train.state import create_train_state

MAX_BOXES = 16
# box-aware augmentation of the reference detector recipe, AugmentConfig's
# defaults: flips, Affine(rotate 20, translate 0.1, scale 0.8-1.2, shear 20),
# Elastic(10, 15), each at p 0.5 (reference: Datasets/dataset_utils.py:59-66,
# train_detector.py:48-49)
DETECTOR_AUG = AugmentConfig()


def build_detection_table(rows: Table, classes, image_col="image_id", max_boxes=MAX_BOXES):
    """Group per-image box rows into padded (max_boxes, 5) annotation arrays,
    keyed by image id; an image without a box of a known class is left out."""
    cls_index = {c: i for i, c in enumerate(classes)}
    ann = {}
    for r in rows:
        img = str(r[image_col])
        cats = r.get("finding_categories")
        cats = cats if isinstance(cats, list) else [cats]
        for cat in cats:
            if cat not in cls_index:
                continue
            box = [r.get("resized_xmin", r.get("xmin")), r.get("resized_ymin", r.get("ymin")),
                   r.get("resized_xmax", r.get("xmax")), r.get("resized_ymax", r.get("ymax")),
                   cls_index[cat]]
            ann.setdefault(img, []).append([float(v) for v in box])
    table = {}
    for img, boxes in ann.items():
        arr = -np.ones((max_boxes, 5), np.float32)
        arr[: min(len(boxes), max_boxes)] = np.asarray(boxes[:max_boxes], np.float32)
        table[img] = arr
    return table


def batches(tab, store, batch_size, device, shuffle=False, seed=0, pad_last=False):
    """Batches of ``batch_size`` images of ``tab`` (sorted ids) on ``device``:
    full ones only, or with ``pad_last`` also the last partial one, padded with
    copies of its last image. Each carries ``ids`` and ``n_rows``, the count of
    its real images."""
    ids = sorted(tab)
    order = np.arange(len(ids))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    stop = len(ids) if pad_last else len(ids) - batch_size + 1
    for i in range(0, max(stop, 0), batch_size):
        sel = [ids[int(j)] for j in order[i: i + batch_size]]
        rows = len(sel)
        sel += [sel[-1]] * (batch_size - rows)
        yield {
            "images": torch.from_numpy(np.stack([store.get("", s) for s in sel])[..., None]
                                       ).to(device),
            "annotations": torch.from_numpy(np.stack([tab[s] for s in sel])).to(device),
            "ids": sel[:rows],
            "n_rows": rows,
        }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clip-checkpoint", required=True)
    ap.add_argument("--csv", required=True)
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--resize", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--batch-size", type=int, default=7)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--focal-alpha", type=float, default=0.25)
    ap.add_argument("--focal-gamma", type=float, default=2.0)
    ap.add_argument("--score-threshold", type=float, default=0.2)
    ap.add_argument("--freeze-backbone", action="store_true")
    ap.add_argument("--eval-scales", type=lambda v: [float(x) for x in v.split(",")],
                    default=None, help="multi-scale eval, e.g. 0.75,1.0,1.25: run "
                    "the detector at each scale and merge candidates in ONE NMS")
    ap.add_argument("--soft-nms", action="store_true",
                    help="gaussian soft-NMS at eval (score decay instead of kill)")
    ap.add_argument("--resume", action="store_true", help="resume from workdir/checkpoints")
    ap.add_argument("--workdir", default="outputs/detector")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    clip_model, clip_cfg = load_clip_for_eval(args.clip_checkpoint, device=args.device)
    device = clip_model.logit_scale.device
    H = W = args.resize
    classes = VINDR_DETECTION_CLASSES
    model = retinanet_from_clip_checkpoint(
        clip_cfg.to_dict(), clip_model.state_dict(), len(classes),
        freeze_backbone=args.freeze_backbone, dtype=torch.bfloat16, device=device)
    del clip_model

    df = load_metadata(args.csv)
    store = open_image_store(args.image_dir, (H, W))
    train_tab = build_detection_table(split_dataframe(df, "train"), classes)
    valid_tab = build_detection_table(split_dataframe(df, "valid"), classes)

    anchors = torch.from_numpy(anchors_for((H, W))).to(device)
    mean, std = clip_cfg.data.mean, clip_cfg.data.std

    def preprocess(batch, generator):
        batch = dict(batch)
        if generator is None:
            batch["images"] = augment_batch(batch["images"], None, DETECTOR_AUG, mean, std,
                                            train=False)
        else:
            batch["images"], batch["annotations"] = augment_batch_with_boxes(
                batch["images"], batch["annotations"], generator, DETECTOR_AUG, mean, std)
        return batch

    tx = build_optimizer({"name": "adam", "lr": args.lr, "grad_clip_norm": 0.1},
                         lambda s: args.lr, model.named_parameters())
    state = create_train_state(model, tx)
    train_step, infer_step, infer_multiscale = make_detector_steps(
        model, anchors, preprocess, alpha=args.focal_alpha, gamma=args.focal_gamma)
    nms = "soft" if args.soft_nms else "hard"
    generator = torch.Generator(device=device)
    config = {"classes": classes, "resize": args.resize}

    best_map = -1.0
    start_epoch = 0
    ckpt_dir = f"{args.workdir}/checkpoints"
    if args.resume and latest_step(ckpt_dir) is not None:
        state, _, meta = restore_checkpoint(ckpt_dir, state)
        start_epoch = int(meta.get("epoch", 0))
        best_map = float(meta.get("best_mAP", -1.0))
        print(f"resumed detector at epoch {start_epoch} (best mAP {best_map:.4f})")
    for epoch in range(start_epoch, args.epochs):
        for batch in batches(train_tab, store, args.batch_size, device, shuffle=True,
                             seed=epoch):
            state, _ = train_step(state, batch, generator, seed=0)
        dets, anns = [], []
        for batch in batches(valid_tab, store, args.batch_size, device, pad_last=True):
            if args.eval_scales:
                d = infer_multiscale(state, batch, scales=tuple(args.eval_scales), nms=nms)
            else:
                d = detect(infer_step(state, batch), anchors, (H, W), score_threshold=0.05,
                           nms=nms)
            d = {k: v[: batch["n_rows"]].cpu().numpy() for k, v in d.items()}
            ann = batch["annotations"][: batch["n_rows"]].cpu().numpy()
            for i in range(batch["n_rows"]):
                dets.append({k: v[i] for k, v in d.items()})
                anns.append(ann[i])
        res = evaluate_map(dets, anns, len(classes), score_threshold=args.score_threshold,
                           class_names=classes)
        print(f"epoch {epoch + 1}: mAP={res['mAP']:.4f}")
        if res["mAP"] > best_map:
            best_map = res["mAP"]
            # the validation detections, for offline re-scoring (reference keeps
            # predictions in its best checkpoints, Classifiers/experiments.py:193-222)
            det_arrays = {k: np.stack([d[k] for d in dets])
                          for k in ("boxes", "scores", "classes", "valid")}
            det_arrays["annotations"] = np.stack(anns)
            save_checkpoint(f"{args.workdir}/best", state, config=config,
                            extra_meta={"mAP": best_map}, max_to_keep=1,
                            extra_arrays=det_arrays)
        save_checkpoint(ckpt_dir, state, step=epoch + 1, config=config,
                        extra_meta={"epoch": epoch + 1, "best_mAP": float(best_map)},
                        max_to_keep=1)
    out = {"best_mAP": best_map}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
