"""Host-side image stores (port of ``mammo_clip_tpu/data/images.py``).

``PackedShardStore`` format: ``<root>/shard_{k:05d}.npy`` each (N, H, W) uint8
plus ``index.csv`` mapping image_id -> (shard, row), read here with ``csv``.
``DirectoryImageStore`` reads the reference's PNG tree with the port's own
8-bit greyscale PNG decoder (``data/png.py``) and resizes with the area resize
of ``preprocess/native_bindings.py`` (native, else its plain version); it needs
no OpenCV. ``SyntheticImageStore`` makes seeded pseudo-images for
tests and benchmarks (``synthetic://``).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class DirectoryImageStore:
    """Reads grayscale PNGs from ``root/<study_id>/<image_id>`` like the reference
    dataset layout (imagetext.py:63-64). Optionally resizes to a fixed (H, W)."""

    def __init__(self, root: str, image_size: Optional[Tuple[int, int]] = None):
        self.root = Path(root)
        self.image_size = image_size

    def get(self, study_id: str, image_id: str) -> np.ndarray:
        from ..preprocess.native_bindings import area_resize
        from .png import read_png

        img = read_png(self.root / str(study_id) / str(image_id))
        if self.image_size is not None and img.shape != tuple(self.image_size):
            img = area_resize(img, tuple(self.image_size))
        return img  # (H, W) uint8


class PackedShardStore:
    """Memory-mapped packed uint8 shards with an image_id index."""

    INDEX_NAME = "index.csv"

    def __init__(self, root: str):
        self.root = Path(root)
        with open(self.root / self.INDEX_NAME, newline="") as f:
            self._index: Dict[str, Tuple[int, int]] = {
                r["image_id"]: (int(r["shard"]), int(r["row"])) for r in csv.DictReader(f)}
        self._shards: Dict[int, np.ndarray] = {}

    def _shard(self, k: int) -> np.ndarray:
        if k not in self._shards:
            self._shards[k] = np.load(self.root / f"shard_{k:05d}.npy", mmap_mode="r")
        return self._shards[k]

    def __contains__(self, image_id: str) -> bool:
        return str(image_id) in self._index

    def get(self, study_id: str, image_id: str) -> np.ndarray:
        shard, row = self._index[str(image_id)]
        return np.asarray(self._shard(shard)[row])  # (H, W) uint8 copy

    def get_rows(self, image_ids: Sequence[str]) -> np.ndarray:
        return np.stack([self.get("", i) for i in image_ids])


class SyntheticImageStore:
    """Deterministic pseudo-images for tests and benchmarks (no disk).

    The pixels are the JAX store's expression, seeded from Python's ``hash`` of
    the ids. String hashing is salted per process (PYTHONHASHSEED), so an image
    is the same for every read within one process, and equal to the JAX store's
    only when both run in the same process."""

    def __init__(self, image_size: Tuple[int, int] = (64, 48)):
        self.image_size = image_size

    def get(self, study_id: str, image_id: str) -> np.ndarray:
        seed = abs(hash((str(study_id), str(image_id)))) % (2**32)
        rng = np.random.default_rng(seed)
        return rng.integers(0, 255, size=self.image_size, dtype=np.uint8)


def open_image_store(root_or_spec: str, image_size: Optional[Tuple[int, int]] = None):
    """Pick a store: packed shards if index.csv exists, synthetic:// for tests, else
    a PNG directory tree."""
    if str(root_or_spec).startswith("synthetic://"):
        return SyntheticImageStore(image_size or (64, 48))
    root = Path(root_or_spec)
    if (root / PackedShardStore.INDEX_NAME).exists():
        return PackedShardStore(str(root))
    return DirectoryImageStore(str(root), image_size)
