"""Tutorial: extract vision-encoder embeddings from a Mammo-CLIP checkpoint (the
port's twin of ``examples/get_embeddings.py``; script form of the reference's
notebooks/Tutorial/Get_Embedding_Vision_encoder_Mammo_CLIP_tutorial.ipynb).

    python -m mammo_clip_tpu_torch.examples.get_embeddings \\
        --checkpoint <checkpoint dir | reference .tar> --images img1.png img2.png \\
        [--out embeddings.npy] [--texts "mass in the left breast." ...] [--device cuda]

8-bit greyscale PNGs are read with the port's decoder (``data/png.py``) and
resized to the checkpoint's image size with the area resize that
``data/images.py::DirectoryImageStore`` uses; no OpenCV.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data.png import read_png
from ..data.tokenizer import load_tokenizer
from ..eval.embeddings import EmbeddingExtractor
from ..eval.loading import load_clip_for_eval
from ..preprocess.native_bindings import area_resize


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--images", nargs="+", required=True)
    ap.add_argument("--out", default="embeddings.npy")
    ap.add_argument("--texts", nargs="*", default=None, help="optionally embed texts too")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    model, cfg = load_clip_for_eval(args.checkpoint, device=args.device)
    h, w = cfg.data.image_size_h, cfg.data.image_size_w
    extractor = EmbeddingExtractor(model, cfg.data.mean, cfg.data.std)

    imgs = []
    for p in args.images:
        img = read_png(p)
        if img.shape != (h, w):
            img = area_resize(img, (h, w))
        imgs.append(img)
    emb = extractor.encode_images(np.stack(imgs)[..., None])
    np.save(args.out, emb)
    print(f"saved {emb.shape} image embeddings to {args.out}")

    if args.texts:
        tok = load_tokenizer({"vocab_size": cfg.get_path("model.text_encoder.vocab_size", 28996),
                              "name": cfg.get_path("model.text_encoder.name")})
        enc = tok(args.texts, max_length=cfg.data.text_max_length)
        temb = extractor.encode_texts(enc["input_ids"], enc["attention_mask"])
        sims = emb @ temb.T
        print("image-text cosine similarities:\n", np.round(sims, 4))
    return emb


if __name__ == "__main__":
    main()
