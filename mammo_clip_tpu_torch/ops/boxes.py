"""Box utilities: IoU, RetinaNet box coding, anchor generation (port of
``mammo_clip_tpu/ops/boxes.py``). All shape-static.

* anchor lattice (reference: Detectors/retinanet/anchors.py:8-135): pyramid
  levels 3..7, strides 2^l, base sizes 2^(l+2), ratios {0.5,1,2}, scales
  {1,2^1/3,2^2/3}, centers at (stride*(i+0.5)); generated ONCE per static image
  shape in numpy, the same arrays as the JAX package's;
* box deltas normalized by std [0.1,0.1,0.2,0.2] (losses.py:142-162,
  detectors_utils.py BBoxTransform);
* IoU (calc_iou, losses.py:5-30).

The tensor functions take any leading batch dimensions: ``box_iou`` of
(..., A, 4) and (..., B, 4) is (..., A, B).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

BOX_STD = (0.1, 0.1, 0.2, 0.2)


def generate_level_anchors(base_size: float, ratios: Sequence[float],
                           scales: Sequence[float]) -> np.ndarray:
    """(num_ratios*num_scales, 4) anchors centered at origin, xyxy."""
    ratios = np.asarray(ratios, np.float64)
    scales = np.asarray(scales, np.float64)
    ws = base_size * np.tile(scales, len(ratios))
    areas = ws * ws
    r = np.repeat(ratios, len(scales))
    w = np.sqrt(areas / r)
    h = w * r
    return np.stack([-w / 2, -h / 2, w / 2, h / 2], axis=1).astype(np.float32)


def build_anchors(
    image_shape: Tuple[int, int],
    pyramid_levels: Sequence[int] = (3, 4, 5, 6, 7),
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
    scales: Sequence[float] = (1.0, 2 ** (1 / 3), 2 ** (2 / 3)),
) -> np.ndarray:
    """All anchors for a static (H, W), concatenated over levels -> (A, 4) xyxy,
    row-major over (level, y, x, anchor)."""
    H, W = image_shape
    out: List[np.ndarray] = []
    for lvl in pyramid_levels:
        stride = 2**lvl
        base = 2 ** (lvl + 2)
        cell = generate_level_anchors(base, ratios, scales)
        fh = -(-H // stride)
        fw = -(-W // stride)
        sx = (np.arange(fw) + 0.5) * stride
        sy = (np.arange(fh) + 0.5) * stride
        cx, cy = np.meshgrid(sx, sy)
        shifts = np.stack([cx.ravel(), cy.ravel(), cx.ravel(), cy.ravel()], axis=1)
        out.append((shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4).astype(np.float32))
    return np.concatenate(out, axis=0)


def _std(t: torch.Tensor) -> torch.Tensor:
    return torch.tensor(BOX_STD, dtype=t.dtype, device=t.device)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between (..., A, 4) and (..., B, 4) xyxy boxes -> (..., A, B)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (torch.clamp(a[..., 2] - a[..., 0], min=0)
              * torch.clamp(a[..., 3] - a[..., 1], min=0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0], min=0)
              * torch.clamp(b[..., 3] - b[..., 1], min=0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-8)


def encode_boxes(anchors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """xyxy anchors + matched gt (..., A, 4) -> normalized (dx,dy,dw,dh) targets.

    Centers come from the UNCLAMPED extents and only the log's w/h is clamped
    to 1, as the reference computes centers first (degenerate border-clipped
    boxes keep their true center)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = gt[..., 0] + 0.5 * gw
    gy = gt[..., 1] + 0.5 * gh
    gw = torch.clamp(gw, min=1.0)
    gh = torch.clamp(gh, min=1.0)
    d = torch.stack([(gx - ax) / aw, (gy - ay) / ah, torch.log(gw / aw),
                     torch.log(gh / ah)], dim=-1)
    return d / _std(d)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Inverse of encode_boxes (reference BBoxTransform, detectors_utils.py:162-222)."""
    d = deltas * _std(deltas)
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    cx = ax + d[..., 0] * aw
    cy = ay + d[..., 1] * ah
    w = torch.exp(d[..., 2]) * aw
    h = torch.exp(d[..., 3]) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def clip_boxes(boxes: torch.Tensor, image_shape: Tuple[int, int]) -> torch.Tensor:
    """Clip xyxy to image bounds (reference ClipBoxes, detectors_utils.py:225-252)."""
    H, W = image_shape
    return torch.stack([
        torch.clamp(boxes[..., 0], 0, W - 1),
        torch.clamp(boxes[..., 1], 0, H - 1),
        torch.clamp(boxes[..., 2], 0, W - 1),
        torch.clamp(boxes[..., 3], 0, H - 1),
    ], dim=-1)
