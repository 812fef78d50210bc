"""Offline DICOM -> packed-shard / PNG conversion tool (port of
``mammo_clip_tpu/preprocess/dicom_tool.py``; no pandas, OpenCV or pydicom needed).

Replaces the reference's two conversion scripts and their native dependencies
(reference: preprocess_image_to_png_kaggle.py — NVIDIA DALI GPU JPEG2000 path — and
preprocess_image_to_png_vindr.py — dicomsdl CPU path): decode via the native
GDCM-backed codec (pydicom as a lazy fallback), then the fused native C++
pipeline (normalize -> breast-ROI crop -> area resize, preprocess/native/) or the
numpy path (``normalize_dicom_pixels``, ``breast_roi_bounds`` and the area
resize, native or plain), writing packed uint8 shards (preferred) or PNGs
(``data/png.py``); ``--bounds-csv`` is written by ``data.metadata.write_table``.

    python -m mammo_clip_tpu_torch.preprocess.dicom_tool --in-dir dicoms/ \
        --out-dir shards/ [--height 1520 --width 912] [--png] [--bounds-csv b.csv] \
        [--threads 0]
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Tuple

import numpy as np

from ..data.metadata import Table, write_table
from ..data.png import write_png
from . import native_bindings as nb
from .breast_crop import breast_roi_bounds, normalize_dicom_pixels
from .shard_writer import write_packed_shards

BOUNDS_COLUMNS = ("image_id", "y0", "y1", "x0", "x1")


def read_dicom_pixels(path: str) -> Tuple[np.ndarray, str]:
    """(pixel_array, photometric).

    Primary path: the first-party native codec (GDCM-backed, preprocess/native/
    mammo_dicom.cpp) — decodes the RSNA JPEG-2000 and VinDr JPEG-Lossless transfer
    syntaxes with no Python imaging dependencies. pydicom remains a fallback for
    environments without the native build."""
    from .dicom_native import dicom_available, read_dicom_u16

    if dicom_available():
        pixels, mono1 = read_dicom_u16(path)
        return pixels, "MONOCHROME1" if mono1 else "MONOCHROME2"
    try:  # pragma: no cover - env without the native codec
        import pydicom
    except ImportError as e:
        raise RuntimeError(
            "neither the native DICOM codec (GDCM) nor pydicom is available; "
            "DICOM conversion requires one of them (the rest of the framework "
            "does not)."
        ) from e
    ds = pydicom.dcmread(path)
    return ds.pixel_array, str(getattr(ds, "PhotometricInterpretation", "MONOCHROME2"))


def convert_one(path: str, out_size: Tuple[int, int]) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """One DICOM -> (uint8 resized image, crop bounds). Prefers the native pipeline."""
    raw, photometric = read_dicom_pixels(path)
    if nb.native_available() and raw.dtype == np.uint16:
        trimmed = raw[5:-5, 5:-5]
        return nb.preprocess_mammogram_native(
            np.ascontiguousarray(trimmed), out_size, invert=photometric == "MONOCHROME1"
        )
    norm = normalize_dicom_pixels(raw, photometric)
    bounds = breast_roi_bounds(norm)
    y0, y1, x0, x1 = bounds
    return nb.area_resize(norm[y0:y1, x0:x1], out_size), bounds


class _PoolLoader:
    """Chunked front-runner over the native parallel pool: converts DICOMs in
    batches of ``chunk`` on every host core (dicom_native.batch_preprocess),
    serving results in order so peak memory stays one chunk. The DALI-pipeline
    equivalent of the reference's GPU decode stage
    (preprocess_image_to_png_kaggle.py:95-100)."""

    def __init__(self, paths, out_size, n_threads=0, chunk=256):
        self.paths = [str(p) for p in paths]
        self.out_size = out_size
        self.n_threads = n_threads
        self.chunk = chunk
        self.pos = 0
        self.cache = {}
        self.bounds = {}

    def _advance(self):
        from .dicom_native import _STATUS, batch_preprocess

        batch = self.paths[self.pos:self.pos + self.chunk]
        imgs, bounds, status = batch_preprocess(batch, self.out_size,
                                                n_threads=self.n_threads)
        for i, p in enumerate(batch):
            if status[i] != 0:
                raise ValueError(
                    f"DICOM conversion failed for {p}: {_STATUS.get(int(status[i]))}")
            self.cache[p] = imgs[i]
            self.bounds[p] = tuple(int(v) for v in bounds[i])
        self.pos += len(batch)

    def __call__(self, path: str) -> np.ndarray:
        while path not in self.cache and self.pos < len(self.paths):
            self._advance()
        return self.cache.pop(path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--height", type=int, default=1520)
    ap.add_argument("--width", type=int, default=912)
    ap.add_argument("--png", action="store_true", help="write PNGs instead of packed shards")
    ap.add_argument("--bounds-csv", default=None, help="write crop bounds for box remapping")
    ap.add_argument("--threads", type=int, default=0,
                    help="decode threads for the native parallel pool "
                    "(0 = all host cores, 1 = serial Python fallback path)")
    args = ap.parse_args(argv)

    paths = sorted(Path(args.in_dir).rglob("*.dicom")) + sorted(Path(args.in_dir).rglob("*.dcm"))
    out_size = (args.height, args.width)
    bounds_rows = []

    from .dicom_native import pool_available

    use_pool = args.threads != 1 and pool_available()
    if use_pool and not args.png:
        loader = _PoolLoader(paths, out_size, n_threads=args.threads)
        write_packed_shards([(p.stem, str(p)) for p in paths], args.out_dir, out_size,
                            loader=loader)
        bounds_rows = [
            {"image_id": Path(p).stem, "y0": b[0], "y1": b[1], "x0": b[2], "x1": b[3]}
            for p, b in loader.bounds.items()
        ]
    elif args.png:
        os.makedirs(args.out_dir, exist_ok=True)
        for p in paths:
            img, bounds = convert_one(str(p), out_size)
            write_png(os.path.join(args.out_dir, p.stem + ".png"), img)
            bounds_rows.append({"image_id": p.stem, "y0": bounds[0], "y1": bounds[1],
                                "x0": bounds[2], "x1": bounds[3]})
    else:
        cache = {}

        def loader(p):
            img, bounds = convert_one(p, out_size)
            cache[p] = bounds
            return img

        write_packed_shards([(p.stem, str(p)) for p in paths], args.out_dir, out_size,
                            loader=lambda p: loader(p))
        bounds_rows = [
            {"image_id": Path(p).stem, "y0": b[0], "y1": b[1], "x0": b[2], "x1": b[3]}
            for p, b in cache.items()
        ]

    if args.bounds_csv:
        write_table(Table(bounds_rows, BOUNDS_COLUMNS if bounds_rows else ()), args.bounds_csv)
    print(f"converted {len(paths)} DICOMs -> {args.out_dir}")


if __name__ == "__main__":
    main()
