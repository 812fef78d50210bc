"""Zero-shot evaluation CLI (port of ``mammo_clip_tpu/cli/zeroshot.py``;
reference: src/codebase/eval_zero_shot_clip.py:16-54).

    python -m mammo_clip_tpu_torch.cli.zeroshot --checkpoint <run dir | step root | .tar> \
        --csv <labels.csv> --image-dir <pngs|shards|synthetic://> --dataset vindr \
        [--out results.json] [--device cuda]

Per test dataset: embed all images, embed each label's prompt pair, softmax cosine
similarity, AUROC (mass/calc/cancer) or accuracy (density); results printed as
JSON and dumped to ``--out`` (reference writes results-{ds}.json,
eval_zero_shot_clip.py:45-46). ``--device`` (default ``cuda``) is the port's;
the JAX CLI's compile cache has no counterpart (eager PyTorch compiles nothing).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..data.images import open_image_store
from ..data.metadata import load_metadata, split_dataframe
from ..data.tokenizer import load_tokenizer
from ..eval.embeddings import EmbeddingExtractor
from ..eval.loading import load_clip_for_eval
from ..eval.zeroshot import DEFAULT_ZS_PROMPTS, eval_zeroshot

# CSV column per label key (reference image_classification_zs.py:83-99)
LABEL_COLUMNS = {
    "mass": ("Mass", "mass"),
    "suspicious_calcification": ("Suspicious_Calcification", "calc"),
    "malignancy": ("cancer", "cancer"),
    "cancer": ("cancer", "cancer"),
    "density": ("density", "density"),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--ema", action="store_true",
                    help="evaluate the EMA weights (optimizer.ema_decay checkpoints)")
    ap.add_argument("--csv", required=True)
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--image-col", default="image_id")
    ap.add_argument("--dataset", default="vindr", choices=list(DEFAULT_ZS_PROMPTS))
    ap.add_argument("--split", default="valid")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    model, cfg = load_clip_for_eval(args.checkpoint, use_ema=args.ema, device=args.device)
    h, w = cfg.data.image_size_h, cfg.data.image_size_w
    extractor = EmbeddingExtractor(model, cfg.data.mean, cfg.data.std,
                                   batch_size=args.batch_size)
    tokenizer = load_tokenizer(
        {"vocab_size": cfg.get_path("model.text_encoder.vocab_size", 28996),
         "name": cfg.get_path("model.text_encoder.name")}
    )

    df = split_dataframe(load_metadata(args.csv), args.split)
    store = open_image_store(args.image_dir, (h, w))
    prompts = DEFAULT_ZS_PROMPTS[args.dataset]

    images = np.stack(
        [store.get(str(r.get("study_id", r.get("patient_id", ""))), str(r[args.image_col]))
         for r in df]
    )[..., None]
    image_emb = extractor.encode_images(images)

    labels = {}
    for key in prompts:
        col, lbl = LABEL_COLUMNS[key.lower()]
        if col in df.columns:
            labels[lbl] = np.asarray([r[col] for r in df])

    results = eval_zeroshot(
        extractor, tokenizer, image_emb, labels, prompts,
        max_length=cfg.data.text_max_length,
    )
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
