"""Input pipeline: host batching -> prefetched device batches (port of
``mammo_clip_tpu/data/pipeline.py``).

* static shapes everywhere: fixed batch size (drop_last), fixed token length;
* the host only stacks uint8 images and tokenizes; augmentation and
  normalization run on the device inside the train step (ops/augment.py);
* ``prefetch_to_device`` does the host work of the next ``depth`` batches in a
  background thread into pinned memory, and the consumer copies each batch to
  the device with ``non_blocking=True``;
* ``sample_weights`` draws an epoch's indices with replacement, weighted, as
  the JAX Batcher does (the reference's WeightedRandomSampler option for the
  classifiers, Datasets/dataset_utils.py:147-165);
* one process drives one device; under data parallelism (``core/mesh.py``)
  each data rank's Batcher enumerates its strided slice of the epoch's order
  (``process_index::process_count``: the data index and the data ranks by
  default, so the ranks of a model group get the same rows), the JAX
  Batcher's per-process sharding:
  the ranks' batches are disjoint, together they cover the epoch, and every
  rank yields ``len(batcher)`` batches of its own ``batch_size`` rows, so a
  step's global batch is ``process_count * batch_size``.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..core import mesh


class Batcher:
    """Deterministic, seeded batch iterator over a host dataset: the order of an
    epoch is a pure function of (seed, epoch).

    dataset: mapping-style with __len__/__getitem__ returning dicts with
    'image' (H,W uint8), optional 'image_view', 'text'/'text2' strings or 'label'.
    """

    def __init__(self, dataset, tokenizer, batch_size: int, max_length: int = 256,
                 shuffle: bool = True, seed: int = 0, sample_weights=None,
                 process_index: Optional[int] = None, process_count: Optional[int] = None):
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_length = max_length
        self.shuffle = shuffle
        self.seed = seed
        self.sample_weights = (None if sample_weights is None
                               else np.asarray(sample_weights, np.float64))
        # this process's data index and the data ranks (the mesh's by default)
        self.process_index = mesh.data_index() if process_index is None else int(process_index)
        self.process_count = mesh.data_size() if process_count is None else int(process_count)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "reseed"):
            self.dataset.reseed(epoch)

    def __len__(self) -> int:
        # the last partial batch is dropped; every rank yields this many
        return len(self.dataset) // self.process_count // self.batch_size

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed * 100_003 + self.epoch)
        if self.sample_weights is not None:
            order = rng.choice(n, size=n, replace=True,
                               p=self.sample_weights / self.sample_weights.sum())
            return order[self.process_index::self.process_count]
        order = np.arange(n)
        if self.shuffle:
            rng.shuffle(order)
        return order[self.process_index::self.process_count]

    def _collate(self, items) -> Dict[str, np.ndarray]:
        batch: Dict[str, np.ndarray] = {}
        batch["images"] = np.stack([it["image"] for it in items])[..., None]
        if "image_view" in items[0]:
            batch["image_views"] = np.stack([it["image_view"] for it in items])[..., None]
        if "text" in items[0]:
            enc = self.tokenizer([it["text"] for it in items], max_length=self.max_length)
            batch["input_ids"] = enc["input_ids"]
            batch["attention_mask"] = enc["attention_mask"]
        if "text2" in items[0]:
            enc2 = self.tokenizer([it["text2"] for it in items], max_length=self.max_length)
            batch["input_ids2"] = enc2["input_ids"]
            batch["attention_mask2"] = enc2["attention_mask"]
        if "label" in items[0]:
            batch["labels"] = np.asarray([it["label"] for it in items])
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices()
        bs = self.batch_size
        for b in range(len(self)):
            yield self._collate([self.dataset[int(i)] for i in idx[b * bs : (b + 1) * bs]])


def stack_batches(batches) -> Dict[str, np.ndarray]:
    """Stack K same-shape host batches along a new leading steps axis: every
    leaf goes from ``(B, ...)`` to ``(K, B, ...)``, the input of
    ``train.step.make_train_multistep``."""
    keys = batches[0].keys()
    if any(b.keys() != keys for b in batches):
        raise ValueError("batches must share keys")
    return {k: np.stack([np.asarray(b[k]) for b in batches]) for k in keys}


def group_batches(batches, k: int):
    """Yield lists of ``k`` consecutive batches, dropping the final partial
    group (the trainer accounts for the dropped tail in its schedule horizon)."""
    buf = []
    for b in batches:
        buf.append(b)
        if len(buf) == k:
            yield buf
            buf = []


def _host_tensors(batch, pin: bool) -> Dict[str, torch.Tensor]:
    """numpy batch -> torch tensors (int32 ids widened to int64), pinned when the
    destination is a card."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.dtype == torch.int32:
            t = t.long()
        out[k] = t.pin_memory() if pin else t
    return out


def prefetch_to_device(batches, device="cuda", depth: int = 2, stacked: bool = False):
    """Yield the host batches of ``batches`` as tensors on ``device``.

    A daemon thread prepares up to ``depth`` batches ahead (numpy -> pinned
    tensors), overlapping host work with the device's; the consumer copies each
    to the device with ``non_blocking=True`` on its current stream. The thread
    ends with the iterator: when the source is exhausted, when it raises (the
    error is re-raised here), or when this generator is closed or dropped
    (its ``finally`` stops and joins the thread). ``stacked`` batches carry a
    leading (K,) steps axis (``stack_batches``); on one device they are copied
    as they are.
    """
    device = torch.device(device)
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    sentinel = object()
    err: list = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not put(_host_tensors(b, pin)):
                    return
        except Exception as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            put(sentinel)

    thread = threading.Thread(target=worker, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield {k: v.to(device, non_blocking=True) for k, v in item.items()}
    finally:
        stop.set()
        thread.join()
