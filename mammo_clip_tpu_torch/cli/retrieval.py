"""Image->text retrieval evaluation CLI (port of ``mammo_clip_tpu/cli/retrieval.py``;
reference: evaluator.py:197-252 via eval_zero_shot_clip.py; dataset
configs/data_test/upmc_image_text_retrieval.yaml).

    python -m mammo_clip_tpu_torch.cli.retrieval --checkpoint <ckpt> \
        --csv retrieval.csv --image-dir <pngs|shards|synthetic://> [--out results.json] \
        [--device cuda]

Embeds every image and its full report text, deduplicates texts, and reports
Recall@{1,5,10,15} + mean rank. ``--device`` (default ``cuda``) is the port's.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..data.datasets import ImageTextRetrievalDataset
from ..data.images import open_image_store
from ..data.metadata import load_metadata, split_dataframe
from ..data.tokenizer import load_tokenizer
from ..eval.embeddings import EmbeddingExtractor
from ..eval.loading import load_clip_for_eval
from ..eval.retrieval import eval_image_text_retrieval


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--ema", action="store_true",
                    help="evaluate the EMA weights (optimizer.ema_decay checkpoints)")
    ap.add_argument("--csv", required=True)
    ap.add_argument("--image-dir", required=True)
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
    ds = ImageTextRetrievalDataset(df, store)

    images, texts = [], []
    for i in range(len(ds)):
        item = ds[i]
        images.append(item["image"])
        texts.append(item["text"])
    img_emb = extractor.encode_images(np.stack(images)[..., None])
    enc = tokenizer(texts, max_length=cfg.data.text_max_length)
    txt_emb = extractor.encode_texts(enc["input_ids"], enc["attention_mask"])

    results = eval_image_text_retrieval(img_emb, txt_emb, texts)
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
