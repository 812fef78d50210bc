"""Offline re-scoring of persisted validation predictions (port of
``mammo_clip_tpu/cli/rescore.py``).

The downstream trainers persist the best checkpoint's validation
``predictions``/``labels`` arrays (the arrays.npz sidecar of
``train/checkpoint.py``), the parity artifact for the reference's
embedded-predictions workflow (reference: Classifiers/experiments.py:193-222
saves ``predictions`` in its best checkpoints; its offline analyses re-score
them without re-running inference). This CLI recomputes metrics from that
artifact alone: no model build, no device.

    python -m mammo_clip_tpu_torch.cli.rescore --checkpoint outputs/classifier/best \
        [--metric auroc|pfbeta|accuracy] [--threshold 0.5]

Prints one JSON line with every requested metric, and returns it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..eval.metrics import auroc, pfbeta
from ..train.checkpoint import load_checkpoint_arrays


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint dir whose best step carries arrays.npz")
    ap.add_argument("--metric", action="append", default=None,
                    choices=["auroc", "pfbeta", "accuracy"],
                    help="repeatable; default: all")
    ap.add_argument("--threshold", type=float, default=0.5,
                    help="binarization threshold for accuracy")
    args = ap.parse_args(argv)

    arrays = load_checkpoint_arrays(args.checkpoint)
    if not arrays:
        raise SystemExit(f"no arrays.npz under {args.checkpoint} "
                         "(older checkpoint? re-run training to persist predictions)")
    preds = np.asarray(arrays["predictions"], np.float64)
    labels = np.asarray(arrays["labels"], np.float64)

    # multi-class artifacts (the classifier CLI's ce labels, density/birads,
    # persist (N, C) probabilities): auroc becomes macro one-vs-rest; pfbeta is
    # a binary metric and is skipped unless explicitly requested.
    multiclass = preds.ndim > 1
    metrics = args.metric or (
        ["auroc", "accuracy"] if multiclass else ["auroc", "pfbeta", "accuracy"])
    out = {"n": int(preds.shape[0])}
    if "auroc" in metrics:
        if multiclass:
            per_class = [
                auroc((labels == c).astype(np.float64), preds[:, c])
                for c in range(preds.shape[1])
                if 0 < np.sum(labels == c) < len(labels)
            ]
            out["auroc"] = float(np.mean(per_class)) if per_class else float("nan")
        else:
            out["auroc"] = float(auroc(labels, preds))
    if "pfbeta" in metrics:
        if multiclass:
            raise SystemExit(
                "pfbeta is a binary metric; this checkpoint holds multi-class "
                f"(N, {preds.shape[1]}) predictions")
        out["pfbeta"] = float(pfbeta(labels, preds))
    if "accuracy" in metrics:
        if multiclass:
            out["accuracy"] = float(np.mean(preds.argmax(-1) == labels))
        else:
            out["accuracy"] = float(np.mean((preds >= args.threshold) == (labels > 0.5)))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
