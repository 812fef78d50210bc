"""Dataset classes (host side; port of ``mammo_clip_tpu/data/datasets.py``).

The pretraining kinds of the reference dataset zoo
(reference: breastclip/data/datasets/__init__.py:9-24 dispatch):

  imagetext               -> ImageTextDataset          (pretraining workhorse)
  imagetext_contrastive   -> ImageTextContrastiveDataset

The retrieval, classification and aligner kinds belong to the evaluation and
downstream slices. A dataset takes the ``Table`` of ``data/metadata.py`` (row
dicts) where the JAX one takes a DataFrame; sampling is the same: one
``random.Random`` per (epoch seed, index), so an item is a pure function of
(seed, epoch, index).

TPU-first split of responsibilities: host datasets return raw uint8 images + python
strings; tokenization happens in the batcher (fixed shapes); per-image min-max
normalization and ALL geometric augmentation run on-device inside the compiled train
step (ops/augment.py). This removes the reference's CPU bottleneck where albumentations
ran synchronously on the training process (dataloader num_workers=0,
configs/dataloader/dataloader_b5.yaml:5).

Known reference bugs intentionally NOT replicated (SURVEY.md "bugs" list):
* the sentence-shuffle augmentation whose result is discarded (imagetext.py:190-194) —
  here the shuffle is applied for real, behind a flag;
* the hard-coded absolute prompts.json path (imagetext.py:53-55) — the prompt bank is
  generated in-process (data/prompts.py).
"""

from __future__ import annotations

import random
import re
from typing import Dict, List, Optional, Sequence

from .metadata import Table, parse_list_cell
from .prompts import build_prompt_bank, generate_report_from_labels

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")


def _sentence_shuffle(text: str, rng: random.Random) -> str:
    parts = [p for p in _SENT_SPLIT.split(text) if p]
    if len(parts) > 1:
        rng.shuffle(parts)
    return " ".join(parts)


class ImageTextDataset:
    """Per patient-laterality row -> two views (CC/MLO when available) + two texts.

    Behavior mirrors reference imagetext.py:67-213:
    * with >=2 views: pick 2 distinct views, then a random image per view;
    * with 1 view / plain image lists: draw from the list (2 distinct when
      image_aug_other_image and possible, else the same image twice);
    * text datasets: two sections sampled from the text list, each independently
      replaced by its back-translation with p=0.5 when available
      (imagetext.py:163-186), then sentence-shuffled in train;
    * image-label datasets (VinDr): per-view findings -> synthetic reports via the
      prompt bank (imagetext.py:196-207), deterministic outside train.
    """

    def __init__(
        self,
        df: Table,
        image_store,
        split: str = "train",
        image_view_aug: bool = True,
        image_aug_other_image: bool = False,
        seed: int = 0,
    ):
        self.df = df
        self.store = image_store
        self.split = split
        self.image_view_aug = image_view_aug
        self.image_aug_other_image = image_aug_other_image
        self._base_seed = seed
        self.seed = seed
        self.prompt_bank = build_prompt_bank() if "CC_FINDING" in df.columns else None
        self.has_backtranslation = "text_augment" in df.columns

    def __len__(self) -> int:
        return len(self.df)

    def _pick_images(self, row, rng: random.Random) -> (List[str], List[str]):
        if "CC" in self.df.columns:
            views = list(parse_list_cell(row["view"]))
            if len(views) >= 2:
                views = rng.sample(views, 2)
                paths = []
                for v in views:
                    candidates = list(parse_list_cell(row[v]))
                    paths.append(rng.choice(candidates))
                return paths, views
            tag = views[0] if len(views) == 1 else "image"
            candidates = list(parse_list_cell(row[tag]))
            views = views or ["image"]
        else:
            candidates = list(parse_list_cell(row["image"]))
            views = ["image"]
        if self.split == "train" and self.image_aug_other_image and len(candidates) > 1:
            paths = rng.sample(candidates, 2)
        else:
            paths = [rng.choice(candidates)] if self.split == "train" else [candidates[0]]
        return paths, views

    def _pick_texts(self, row, views: Sequence[str], rng: random.Random) -> (str, str):
        if "text" in self.df.columns:
            texts = list(parse_list_cell(row["text"]))
            augs = list(parse_list_cell(row["text_augment"])) if self.has_backtranslation else texts

            def sample(i: int) -> str:
                use_aug = self.has_backtranslation and rng.random() < 0.5
                return (augs if use_aug else texts)[i]

            if len(texts) >= 2:
                i, j = rng.randrange(len(texts)), rng.randrange(len(texts))
                t1, t2 = sample(i), sample(j)
            else:
                if rng.random() < 0.5:
                    t1, t2 = texts[0], (augs[0] if self.has_backtranslation else texts[0])
                else:
                    t1, t2 = (augs[0] if self.has_backtranslation else texts[0]), texts[0]
            if self.split == "train":
                t1 = _sentence_shuffle(t1, rng)
                t2 = _sentence_shuffle(t2, rng)
            return t1, t2
        if "CC_FINDING" in self.df.columns:
            deterministic = self.split != "train"
            f1 = parse_list_cell(row[f"{views[0]}_FINDING"])
            f2 = parse_list_cell(row[f"{views[1] if len(views) > 1 else views[0]}_FINDING"])
            t1 = generate_report_from_labels(f1, self.prompt_bank, deterministic, rng=rng)
            t2 = generate_report_from_labels(f2, self.prompt_bank, deterministic, rng=rng)
            return t1, t2
        raise AttributeError("dataframe has neither 'text' nor 'CC_FINDING' columns")

    def __getitem__(self, index: int) -> Dict:
        row = self.df[index]
        # per-(epoch seed, index) RNG: reproducible yet varied across epochs
        rng = random.Random((self.seed * 1_000_003 + index) & 0xFFFFFFFF)
        paths, views = self._pick_images(row, rng)
        study_id = str(row["patient_id"]) if "patient_id" in row else str(row.get("study_id", ""))
        image = self.store.get(study_id, paths[0])
        out: Dict = {"image": image}
        if self.image_view_aug:
            view_path = paths[1] if len(paths) > 1 else paths[0]
            out["image_view"] = self.store.get(study_id, view_path)
        t1, t2 = self._pick_texts(row, views, rng)
        out["text"], out["text2"] = t1, t2
        return out

    def reseed(self, epoch: int) -> None:
        """Vary sampling across epochs (replaces DistributedSampler.set_epoch).

        The epoch is folded into the constructor seed rather than replacing it, so
        runs started with different ``seed=`` values keep sampling differently after
        epoch 0, and epoch N of two different runs is not identical."""
        self.seed = self._base_seed * 715_827_883 + epoch


class ImageTextContrastiveDataset:
    """ConVIRT-style: one image + one random sentence from the report + BIRADS label
    (reference: imagetext_contrastive.py:17-111)."""

    def __init__(self, df: Table, image_store, split: str = "train", seed: int = 0):
        self.df = df
        self.store = image_store
        self.split = split
        self.seed = seed

    def __len__(self) -> int:
        return len(self.df)

    def __getitem__(self, index: int) -> Dict:
        row = self.df[index]
        rng = random.Random((self.seed * 1_000_003 + index) & 0xFFFFFFFF)
        images = list(parse_list_cell(row["image"]))
        image = self.store.get(str(row["patient_id"]), rng.choice(images))
        texts = list(parse_list_cell(row["text"]))
        text = " ".join(texts)
        sents = [s for s in _SENT_SPLIT.split(text) if s]
        if self.split == "train" and sents:
            text = rng.choice(sents)
        out = {"image": image, "text": text}
        if "BIRADS" in row:
            out["label"] = row["BIRADS"]
        return out


def load_dataset(data_type: str, **kwargs):
    """Factory mirroring reference breastclip/data/datasets/__init__.py:9-24."""
    table = {
        "imagetext": ImageTextDataset,
        "imagetext_contrastive": ImageTextContrastiveDataset,
    }
    if data_type not in table:
        raise KeyError(f"data_type not ported (the pretraining kinds are): {data_type}")
    return table[data_type](**kwargs)
