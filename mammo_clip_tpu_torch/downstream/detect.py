"""Detection evaluation: VOC mAP (port of ``mammo_clip_tpu/downstream/detect.py``,
numpy, copied).

Parity with the reference's evaluation machinery
(reference: Detectors/detectors_utils.py:43-159 and Detectors/experiments.py:175-273):
per-class greedy TP/FP matching at IoU 0.5 against unassigned ground truth, VOC-style
all-point AP (precision envelope), mean over classes excluding 'No Finding'
(experiments.py:265-271). The device emits fixed-size (K,) detection slates per
image (``models/retinanet.detect``) and this host-side module consumes them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-point interpolated AP with precision envelope
    (reference _compute_ap, detectors_utils.py:43-67)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / np.clip(area_a[:, None] + area_b[None, :] - inter, 1e-8, None)


def evaluate_map(
    detections: Sequence[Dict[str, np.ndarray]],
    annotations: Sequence[np.ndarray],
    num_classes: int,
    iou_threshold: float = 0.5,
    score_threshold: float = 0.05,
    class_names: Sequence[str] | None = None,
    exclude: Sequence[str] = ("No Finding",),
) -> Dict[str, float]:
    """Compute per-class AP and mAP.

    detections: per image dict {boxes (N,4), scores (N,), classes (N,), valid (N,)}.
    annotations: per image (M, 5) arrays [x1,y1,x2,y2,class], -1-padded rows allowed.
    """
    aps: Dict[int, float] = {}
    for c in range(num_classes):
        records: List[tuple] = []  # (score, img_idx, box)
        n_gt = 0
        gts: List[np.ndarray] = []
        for img_idx, (det, ann) in enumerate(zip(detections, annotations)):
            ann = np.asarray(ann)
            ann_c = ann[(ann[:, 4] == c)] if ann.size else np.zeros((0, 5))
            gts.append(ann_c[:, :4])
            n_gt += len(ann_c)
            mask = (np.asarray(det["classes"]) == c) & np.asarray(det["valid"], bool)
            mask &= np.asarray(det["scores"]) >= score_threshold
            for b, s in zip(np.asarray(det["boxes"])[mask], np.asarray(det["scores"])[mask]):
                records.append((float(s), img_idx, b))
        if n_gt == 0:
            continue
        records.sort(key=lambda r: -r[0])
        assigned = [np.zeros(len(g), bool) for g in gts]
        tp = np.zeros(len(records))
        fp = np.zeros(len(records))
        for i, (_, img_idx, box) in enumerate(records):
            gt = gts[img_idx]
            if len(gt) == 0:
                fp[i] = 1
                continue
            ious = _iou_matrix(box[None], gt)[0]
            j = int(np.argmax(ious))
            if ious[j] >= iou_threshold and not assigned[img_idx][j]:
                tp[i] = 1
                assigned[img_idx][j] = True
            else:
                fp[i] = 1
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / n_gt
        precision = ctp / np.clip(ctp + cfp, 1e-8, None)
        aps[c] = _voc_ap(recall, precision)

    result: Dict[str, float] = {}
    included = []
    for c, ap in aps.items():
        name = class_names[c] if class_names else str(c)
        result[f"AP/{name}"] = ap
        if name not in exclude:
            included.append(ap)
    result["mAP"] = float(np.mean(included)) if included else 0.0
    return result


# default VinDr detection classes (reference: train_detector.py:71-85)
VINDR_DETECTION_CLASSES = [
    "Mass",
    "Suspicious Calcification",
    "Architectural Distortion",
    "Global Asymmetry",
    "Focal Asymmetry",
    "Asymmetry",
    "Suspicious Lymph Node",
    "Nipple Retraction",
    "Skin Retraction",
    "Skin Thickening",
    "No Finding",
]
