"""Packed-shard writer: PNG/DICOM trees -> fixed-shape uint8 shards + index
(port of ``mammo_clip_tpu/preprocess/shard_writer.py``, over ``csv``).

Each shard is ``np.save`` of an (N, H, W) uint8 array, read back via memmap by
``data.images.PackedShardStore``, so a batch fetch is a few sequential memcpys
with zero decode. ``index.csv`` (image_id, shard, row) has the bytes of the
JAX writer's ``DataFrame.to_csv(index=False)`` (``data.metadata.write_table``).

``default_image_loader`` decodes with the port's PNG reader (``data/png.py``)
and resizes with the native area resize, else its plain version, where the
JAX loader used OpenCV.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from ..data.metadata import Table, write_table
from ..data.png import read_png
from .breast_crop import extract_breast_roi
from .native_bindings import area_resize

INDEX_COLUMNS = ("image_id", "shard", "row")


def default_image_loader(path: str, image_size: Tuple[int, int], crop: bool = False):
    img = read_png(path)
    if crop:
        img = extract_breast_roi(img)
    h, w = image_size
    if img.shape != (h, w):
        img = area_resize(img, (h, w))
    return img


def write_packed_shards(
    image_paths: Sequence[Tuple[str, str]],  # (image_id, path)
    out_dir: str,
    image_size: Tuple[int, int],
    shard_size: int = 1024,
    crop: bool = False,
    loader: Optional[Callable] = None,
) -> Table:
    """Write shards + index.csv; returns the index."""
    loader = loader or (lambda p: default_image_loader(p, image_size, crop))
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    h, w = image_size
    rows = []
    shard_idx = 0
    buf = np.zeros((min(shard_size, len(image_paths)), h, w), np.uint8)
    n_in_buf = 0
    for image_id, path in image_paths:
        buf[n_in_buf] = loader(path)
        rows.append({"image_id": str(image_id), "shard": shard_idx, "row": n_in_buf})
        n_in_buf += 1
        if n_in_buf == buf.shape[0]:
            np.save(out / f"shard_{shard_idx:05d}.npy", buf[:n_in_buf])
            shard_idx += 1
            remaining = len(image_paths) - len(rows)
            buf = np.zeros((min(shard_size, max(remaining, 1)), h, w), np.uint8)
            n_in_buf = 0
    if n_in_buf:
        np.save(out / f"shard_{shard_idx:05d}.npy", buf[:n_in_buf])
    # pandas gives a frame of no rows no columns either
    index = Table(rows, INDEX_COLUMNS if rows else ())
    write_table(index, str(out / "index.csv"))
    return index
