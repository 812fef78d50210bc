"""Mammo-FActOR training CLI (port of ``mammo_clip_tpu/cli/factor.py``;
reference: notebooks/Mammo-Factor/Mammo-Factor.ipynb cell 5
train_region_mapper).

    python -m mammo_clip_tpu_torch.cli.factor --clip-checkpoint <ckpt> \
        --csv vindr_folds.csv --image-dir <pngs|shards|synthetic://> \
        [--attributes Mass Suspicious_Calcification] [--epochs 10] [--device cuda]

Trains per-attribute region projection heads (``interpret/factor.py``) on the
Mass/Calc-positive rows of the train split with the region-attribute
max-similarity contrastive loss. The CLIP checkpoint (a port run directory or
step root, or a reference ``.tar``) stays frozen: its image encoder gives
the ``features`` map of any encoder family in eval mode under ``no_grad``,
its text tower the attribute embeddings (the synthetic-report bank's
positive prompts, hashing tokenizer). Each epoch visits the rows in
``np.random.default_rng(epoch)`` order, in full batches; AdamW has optax's
defaults (weight decay 1e-4). The mapper is saved under ``workdir/mapper``
with ``final_loss`` in its meta, and the JSON line ``{"final_loss"}`` is
printed and returned. Everything runs in fp32 with TF32 off, as the JAX
CLI's fp32 does.

When the train split has fewer positive rows than ``--batch-size``, the JAX
CLI takes no step and saves an untrained mapper with ``final_loss`` NaN
(fault R10 in ROADMAP.md); here that raises ``ValueError`` before anything
is loaded.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..data.images import open_image_store
from ..data.metadata import load_metadata, split_dataframe
from ..data.prompts import build_prompt_bank
from ..data.tokenizer import load_tokenizer
from ..eval.embeddings import EmbeddingExtractor
from ..eval.loading import load_clip_for_eval
from ..interpret.factor import FactorMapper, attribute_embeddings, factor_loss
from ..models import init_parameters
from ..ops.augment import minmax_standardize
from ..train import build_optimizer, create_train_state
from ..train.checkpoint import save_checkpoint
from ..utils.device import full_fp32

# prompt sources per attribute: positive templates from the synthetic-report bank
_BANK_KEY = {"Mass": "Mass", "Suspicious_Calcification": "Suspicious Calcification"}


def _image(store, row, image_col):
    return store.get(str(row.get("study_id", row.get("patient_id", ""))), str(row[image_col]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clip-checkpoint", required=True)
    ap.add_argument("--csv", required=True)
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--image-col", default="image_id")
    ap.add_argument("--attributes", nargs="+", default=["Mass", "Suspicious_Calcification"])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--temperature", type=float, default=0.07)
    ap.add_argument("--workdir", default="outputs/factor")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    # data: Mass/Calc-positive rows only (notebook cell 5), the train split
    df = load_metadata(args.csv)
    present = [a for a in args.attributes if a in df.columns]
    df = df.select(i for i, r in enumerate(df) if any(r[a] == 1 for a in present))
    train_df = split_dataframe(df, "train")
    bs = args.batch_size
    if len(train_df) < bs:
        raise ValueError(f"the train split has {len(train_df)} rows positive for "
                         f"{args.attributes}, fewer than --batch-size {bs}: no training step "
                         "would run (the JAX CLI saves an untrained mapper then, fault R10)")

    with full_fp32():
        return _train(args, train_df)


def _train(args, train_df) -> dict:
    clip_model, cfg = load_clip_for_eval(args.clip_checkpoint, device=args.device)
    device = clip_model.logit_scale.device
    h, w = cfg.data.image_size_h, cfg.data.image_size_w
    mean, std = cfg.data.mean, cfg.data.std

    # attribute embeddings from the frozen text tower (notebook cell 1)
    extractor = EmbeddingExtractor(clip_model, mean, std, batch_size=args.batch_size)
    tokenizer = load_tokenizer({"vocab_size": cfg.get_path("model.text_encoder.vocab_size",
                                                           28996)})
    bank = build_prompt_bank()
    prompts = {a: bank[_BANK_KEY.get(a, a)]["pos_right"][:64]
               + bank[_BANK_KEY.get(a, a)]["pos_left"][:64] for a in args.attributes}
    attr_embs = attribute_embeddings(extractor, tokenizer, prompts,
                                     max_length=cfg.data.text_max_length)
    attr_mat = torch.from_numpy(np.stack([attr_embs[a] for a in args.attributes])).to(device)

    @torch.no_grad()
    def raw_features(images: np.ndarray) -> torch.Tensor:
        x = minmax_standardize(torch.from_numpy(images).to(device), mean, std)
        return clip_model.image_encoder(x, train=False)["features"]

    store = open_image_store(args.image_dir, (h, w))
    # the mapper needs the feature map's spatial size
    fm = raw_features(_image(store, train_df[0], args.image_col)[None, ..., None])
    _, fh, fw, _ = fm.shape
    mapper = FactorMapper(num_attributes=len(args.attributes), lang_dim=int(attr_mat.shape[1]),
                          spatial_dim=fh * fw).to(device)
    init_parameters(mapper, torch.Generator(device=device).manual_seed(0))
    opt = build_optimizer({"name": "adamw", "weight_decay": 1e-4}, lambda step: args.lr,
                          mapper.named_parameters())
    state = create_train_state(mapper, opt)

    bs = args.batch_size
    last_loss = float("nan")
    for epoch in range(args.epochs):
        order = np.random.default_rng(epoch).permutation(len(train_df))
        for i in range(0, len(order) - bs + 1, bs):
            rows = train_df.select(order[i:i + bs])
            imgs = np.stack([_image(store, r, args.image_col) for r in rows])[..., None]
            labels = torch.tensor([[r[a] for a in args.attributes] for r in rows],
                                  dtype=torch.float32, device=device)
            loss = factor_loss(mapper(raw_features(imgs)), attr_mat, labels,
                               temperature=args.temperature)
            loss.backward()
            state.apply_gradients()
            last_loss = loss.item()
        print(f"epoch {epoch + 1}: loss={last_loss:.4f}")

    save_checkpoint(f"{args.workdir}/mapper", state,
                    config={"attributes": args.attributes, "temperature": args.temperature},
                    extra_meta={"final_loss": last_loss}, max_to_keep=1)
    out = {"final_loss": last_loss}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
