"""Config-driven data assembly (port of ``mammo_clip_tpu/data/datamodule.py``;
reference: breastclip/data/datamodule.py:19-160).

Builds datasets + batchers from a config of the shape::

    data:
      train:                       # list of dataset entries, concatenated
        - csv: /path/clip_pretrain.csv
          image_dir: /path/images   # PNG tree, packed-shard dir, or synthetic://
          data_type: imagetext      # data/datasets.load_dataset dispatch
      valid: [...]
      image_size_h/image_size_w/mean/std/text_max_length/batch_size_per_device

Differences from the reference on purpose: train entries are concatenated by
index offsets (ConcatDataset below) rather than torch ConcatDataset + DistributedSampler
(per-process index sharding lives in data.pipeline.Batcher), and tokenization happens
in the batcher at fixed length. ``process_index`` / ``process_count`` (the
mesh's data index and data ranks, ``core/mesh.py``, by default) pick each rank's strided
slice of every epoch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..core.config import Config
from .datasets import load_dataset
from .images import open_image_store
from .metadata import load_metadata, split_dataframe, subsample
from .pipeline import Batcher
from .tokenizer import load_tokenizer


class ConcatDataset:
    """Round-robin concatenation of mapping-style datasets (reference uses torch
    ConcatDataset, datamodule.py:116)."""

    def __init__(self, datasets: List):
        self.datasets = datasets
        self._offsets = []
        total = 0
        for d in datasets:
            self._offsets.append(total)
            total += len(d)
        self._total = total

    def __len__(self) -> int:
        return self._total

    def __getitem__(self, index: int):
        for d, off in zip(reversed(self.datasets), reversed(self._offsets)):
            if index >= off:
                return d[index - off]
        raise IndexError(index)

    def reseed(self, epoch: int) -> None:
        for d in self.datasets:
            if hasattr(d, "reseed"):
                d.reseed(epoch)


class DataModule:
    def __init__(self, cfg: Config, cur_fold: int = 0, data_frac: float = 1.0,
                 process_index: Optional[int] = None, process_count: Optional[int] = None):
        self.cfg = Config(cfg)
        self.cur_fold = cur_fold
        self.data_frac = data_frac
        self.process_index, self.process_count = process_index, process_count
        tok_cfg = dict(self.cfg.get("tokenizer", {}))
        tok_cfg.setdefault("vocab_size", self.cfg.get_path("model.text_encoder.vocab_size", 28996))
        self.tokenizer = load_tokenizer(tok_cfg)

    def _build_datasets(self, entries, split: str):
        h = self.cfg.data.image_size_h
        w = self.cfg.data.image_size_w
        out = []
        for entry in entries:
            entry = dict(entry)
            df = load_metadata(entry["csv"])
            df = split_dataframe(df, split, cur_fold=self.cur_fold)
            if split == "train":
                df = subsample(df, self.data_frac)
            store = open_image_store(entry["image_dir"], (h, w))
            kwargs = dict(entry.get("dataset_kwargs", {}))
            data_type = entry.get("data_type", "imagetext")
            if data_type == "imagetext":
                kwargs.setdefault("split", split)
            out.append(load_dataset(data_type, df=df, image_store=store, **kwargs))
        return out

    def batcher(self, split: str, shuffle: Optional[bool] = None, batch_size: Optional[int] = None) -> Batcher:
        entries = self.cfg.data.get(split, [])
        if not entries:
            raise ValueError(f"no data entries for split {split}")
        datasets = self._build_datasets(entries, split)
        dataset = datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)
        return Batcher(
            dataset,
            self.tokenizer,
            batch_size=batch_size or self.cfg.data.batch_size_per_device,
            max_length=self.cfg.data.text_max_length,
            shuffle=(split == "train") if shuffle is None else shuffle,
            process_index=self.process_index,
            process_count=self.process_count,
        )
