"""Downstream classifier CLI (port of ``mammo_clip_tpu/cli/classifier.py``;
reference: src/codebase/train_classifier.py:14-156).

    python -m mammo_clip_tpu_torch.cli.classifier --clip-checkpoint <ckpt> \
        --csv <folds.csv> --image-dir <pngs|shards|synthetic://> --label cancer \
        --arch lp|ft [--dataset rsna|vindr] [--epochs 30] [--device cuda] ...

The JAX CLI's flags (the load-bearing subset of the reference's ~40), plus
``--device`` (default ``cuda``). ``--clip-checkpoint`` is a port checkpoint
(a run directory or a step root such as ``best/``) or a reference ``.tar``.
Class-balance pos-weights come from downstream.classify.POS_WEIGHTS
(train_classifier.py:113-141). Prints one JSON line ``{"best_metric",
"history"}`` and returns it. The classifier trains and validates in fp32
with TF32 off (``utils/device.py::full_fp32``), as the JAX CLI's fp32 does.

Every validation row is scored. The JAX CLI batches validation like
training, in full batches only, so a fold of n rows is scored on n - n %
batch_size of them (fault R7 in ROADMAP.md). Here the last validation batch
is padded to the fixed batch shape by repeating its last row, and the pad
rows' predictions are dropped (``n_rows``, ``downstream/experiments.py``).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core.config import Config
from ..data.datasets import ImageClassificationDataset
from ..data.images import open_image_store
from ..data.metadata import load_metadata, split_dataframe, subsample
from ..downstream.classify import POS_WEIGHTS, classifier_from_clip_checkpoint, rsna_aggregator
from ..downstream.experiments import train_classifier
from ..eval.loading import load_clip_for_eval
from ..utils.device import full_fp32


def _batches(ds, batch_size, shuffle, device, seed=0, pad_last=False):
    """Batches of ``batch_size`` rows of ``ds`` on ``device``: full ones only,
    or with ``pad_last`` also the last partial one, padded with copies of its
    last row and carrying ``n_rows``, the count of its real rows."""
    n = len(ds)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    stop = n if pad_last else n - batch_size + 1
    for i in range(0, max(stop, 0), batch_size):
        idx = list(order[i : i + batch_size])
        rows = len(idx)
        idx += [idx[-1]] * (batch_size - rows)
        items = [ds[int(j)] for j in idx]
        batch = {
            "images": torch.from_numpy(np.stack([it["image"] for it in items])[..., None]).to(device),
            "labels": torch.from_numpy(np.asarray([it["label"] for it in items])).to(device),
        }
        if pad_last:
            batch["n_rows"] = rows
        yield batch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clip-checkpoint", required=True)
    ap.add_argument("--csv", required=True)
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--label", default="cancer")
    ap.add_argument("--dataset", default="rsna", choices=["rsna", "vindr"])
    ap.add_argument("--arch", default="lp", choices=["lp", "ft"],
                    help="lp = frozen encoder linear probe, ft = full finetune")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--fold", type=int, default=0)
    ap.add_argument("--data-frac", type=float, default=1.0)
    ap.add_argument("--num-classes", type=int, default=1)
    ap.add_argument("--weighted-bce", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="resume from workdir/checkpoints")
    ap.add_argument("--workdir", default="outputs/classifier")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    clip_model, clip_cfg = load_clip_for_eval(args.clip_checkpoint, device=args.device)
    h, w = clip_cfg.data.image_size_h, clip_cfg.data.image_size_w
    model = classifier_from_clip_checkpoint(
        clip_cfg.to_dict(), clip_model.state_dict(), num_classes=args.num_classes,
        freeze_encoder=args.arch == "lp", device=clip_model.logit_scale.device)
    del clip_model

    df = load_metadata(args.csv)
    train_df = subsample(split_dataframe(df, "train", args.fold), args.data_frac)
    valid_df = split_dataframe(df, "valid", args.fold)
    store = open_image_store(args.image_dir, (h, w))
    train_ds = ImageClassificationDataset(train_df, store, label_col=args.label)
    valid_ds = ImageClassificationDataset(valid_df, store, label_col=args.label)

    pos_weight = POS_WEIGHTS.get(f"{args.dataset}/{args.label}") if args.weighted_bce else None
    loss_kind = "ce" if args.label in ("density", "birads") else "bce"

    aggregate = rsna_aggregator(valid_df) if args.dataset == "rsna" else None
    device = next(model.parameters()).device
    with full_fp32():
        res = train_classifier(
            model,
            lambda epoch: _batches(train_ds, args.batch_size, True, device, seed=epoch),
            lambda: _batches(valid_ds, args.batch_size, False, device, pad_last=True),
            epochs=args.epochs,
            steps_per_epoch=max(len(train_ds) // args.batch_size, 1),
            lr=args.lr,
            weight_decay=args.weight_decay,
            loss_kind=loss_kind,
            pos_weight=pos_weight,
            mean=clip_cfg.data.mean,
            std=clip_cfg.data.std,
            workdir=args.workdir,
            config=Config({"clip": clip_cfg.to_dict(), "label": args.label,
                           "arch": args.arch}).to_dict(),
            aggregate=aggregate,
            resume=args.resume,
        )
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
