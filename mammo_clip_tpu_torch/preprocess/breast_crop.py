"""Breast-ROI extraction (offline preprocessing; a copy of
``mammo_clip_tpu/preprocess/breast_crop.py``, numpy only).

Behavioral equivalent of the reference's longest-run-of-nonconstant-rows/cols
heuristic (reference: preprocess_image_to_png_vindr.py:35-76 ExtractBreast, and the
torch variant preprocess_image_to_png_kaggle.py:192-232): values <= 40 are treated as
background; a column/row is "breast" when its central 80% band has nonzero variance;
the longest contiguous run wins.

Unlike the reference (which returns the cropped pixels), we also expose the crop
BOUNDS so detection boxes can be remapped into the resized frame — the job of the
reference's separate preprocess_VinDr_detector.py:61-126 replay script.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _longest_true_run(mask: np.ndarray) -> Tuple[int, int]:
    """[start, end) of the longest contiguous run of True values."""
    best_start, best_len = 0, 0
    start = None
    for i, v in enumerate(mask.tolist() + [False]):
        if v and start is None:
            start = i
        elif not v and start is not None:
            if i - start > best_len:
                best_start, best_len = start, i - start
            start = None
    return best_start, best_start + best_len


def breast_roi_bounds(img: np.ndarray, background_threshold: int = 40) -> Tuple[int, int, int, int]:
    """(y0, y1, x0, x1) crop bounds of the breast region in a uint8 grayscale image."""
    assert img.ndim == 2
    work = np.where(img <= background_threshold, 0, img)
    h, w = work.shape

    band = work[h // 2 - int(h * 0.4) : h // 2 + int(h * 0.4)]
    col_mask = band.std(axis=0) != 0
    x0, x1 = _longest_true_run(col_mask)
    if x1 <= x0:
        x0, x1 = 0, w

    band2 = work[:, x0:x1]
    bw = band2.shape[1]
    row_mask = band2[:, max(bw // 2 - int(bw * 0.4), 0) : bw // 2 + int(bw * 0.4)].std(axis=1) != 0
    y0, y1 = _longest_true_run(row_mask)
    if y1 <= y0:
        y0, y1 = 0, h
    return y0, y1, x0, x1


def extract_breast_roi(img: np.ndarray, background_threshold: int = 40) -> np.ndarray:
    y0, y1, x0, x1 = breast_roi_bounds(img, background_threshold)
    return img[y0:y1, x0:x1]


def remap_boxes(
    boxes_xyxy: np.ndarray,
    crop_bounds: Tuple[int, int, int, int],
    out_size: Tuple[int, int],
) -> np.ndarray:
    """Remap original-frame boxes through crop + resize into the output frame
    (the reference's resized_{x,y}{min,max} computation,
    preprocess_VinDr_detector.py:61-126)."""
    y0, y1, x0, x1 = crop_bounds
    out_h, out_w = out_size
    sx = out_w / max(x1 - x0, 1)
    sy = out_h / max(y1 - y0, 1)
    out = np.asarray(boxes_xyxy, np.float32).copy()
    out[:, [0, 2]] = (out[:, [0, 2]] - x0) * sx
    out[:, [1, 3]] = (out[:, [1, 3]] - y0) * sy
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, out_w - 1)
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, out_h - 1)
    return out


def normalize_dicom_pixels(data: np.ndarray, photometric: str = "MONOCHROME2",
                           trim: int = 5) -> np.ndarray:
    """DICOM pixel array -> uint8: edge trim, MONOCHROME1 inversion, min-max
    (reference: preprocess_image_to_png_vindr.py:80-92)."""
    data = np.asarray(data, np.float32)
    if trim:
        data = data[trim:-trim, trim:-trim]
    if photometric == "MONOCHROME1":
        data = data.max() - data
    data = data - data.min()
    denom = max(float(data.max()), 1e-8)
    return (data / denom * 255).astype(np.uint8)
