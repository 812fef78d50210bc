"""Shape-static non-maximum suppression (port of ``mammo_clip_tpu/ops/nms.py``).

The reference calls torchvision's CUDA NMS on data-dependent shapes after a
score filter (reference: detector_model.py:331-354). The JAX package
redesigned it to static shapes; the port keeps that design, batched:

1. zero every score under the threshold and take the top-K candidates of each
   slate by a STABLE descending sort (equal scores keep the lower anchor
   first, as ``jax.lax.top_k`` does, so the zero-score padding matches);
2. one (N, K, K) IoU for all N slates (images x classes), then one greedy
   K-step loop over an (N, K) mask: each step touches every slate at once,
   and nothing in it reads a value back to the host, so a batch costs K
   steps of a few small kernels whatever N is;
3. emit fixed-size (K,) slates; suppressed and padded slots carry score 0 and
   are invalid.

Every function takes any leading batch dimensions. No torchvision.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .boxes import box_iou


def _top_candidates(boxes: torch.Tensor, scores: torch.Tensor, score_threshold: float,
                    top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes (..., A, 4) broadcastable to scores (..., A) -> the top
    min(top_k, A) boxes and thresholded scores of each slate, by score."""
    scores = torch.where(scores >= score_threshold, scores, torch.zeros_like(scores))
    k = min(top_k, scores.shape[-1])
    top_scores, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, idx = top_scores[..., :k], idx[..., :k]
    boxes = boxes.expand(*scores.shape, 4)
    return torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4)), top_scores


def _pad_slots(t: torch.Tensor, top_k: int, trailing: int = 0) -> torch.Tensor:
    """Pad the slot dimension (the one before ``trailing`` more) with zeros
    (False) to ``top_k``."""
    dim = t.dim() - 1 - trailing
    if t.shape[dim] >= top_k:
        return t
    shape = list(t.shape)
    shape[dim] = top_k - t.shape[dim]
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def static_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
               score_threshold: float = 0.05, top_k: int = 100
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over (..., A, 4) / (..., A) -> (..., top_k, 4) boxes,
    (..., top_k) scores, (..., top_k) valid mask, ordered by descending score;
    suppressed and padded slots have score 0 and valid=False.

    A slot's fate is settled by the time the loop reaches it: only kept
    higher-scoring slots suppress it. So each step clears, among the later
    slots, those that the step's slot overlaps, if it is still alive."""
    top_boxes, top_scores = _top_candidates(boxes, scores, score_threshold, top_k)
    k = top_scores.shape[-1]
    later = torch.ones(k, k, dtype=torch.bool, device=scores.device).triu(1)
    over = (box_iou(top_boxes, top_boxes) > iou_threshold) & later
    keep = top_scores > 0.0
    for i in range(k):
        keep &= ~(over[..., i, :] & keep[..., i:i + 1])
    out_scores = torch.where(keep, top_scores, torch.zeros_like(top_scores))
    return _pad_slots(top_boxes, top_k, 1), _pad_slots(out_scores, top_k), _pad_slots(keep, top_k)


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor, sigma: float = 0.5,
             iou_threshold: float = 0.5, score_threshold: float = 0.05, top_k: int = 100,
             method: str = "gaussian") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Soft-NMS (Bodla et al. 2017), shape-static: each selection DECAYS its
    neighbours' scores instead of killing them. gaussian: s *= exp(-iou^2 /
    sigma); linear: s *= (1 - iou) for iou > threshold. Returns (..., top_k,
    4) boxes in selection order, their decayed scores, and the valid mask
    (score still >= score_threshold after decay)."""
    if method not in ("gaussian", "linear"):
        raise ValueError(f"unknown soft-NMS method: {method}")
    top_boxes, top_scores = _top_candidates(boxes, scores, score_threshold, top_k)
    k = top_scores.shape[-1]
    iou = box_iou(top_boxes, top_boxes)
    cur = top_scores.clone()
    done = torch.zeros_like(cur, dtype=torch.bool)
    order = torch.zeros(cur.shape, dtype=torch.long, device=cur.device)
    neg_inf = torch.tensor(-float("inf"), dtype=cur.dtype, device=cur.device)
    one = torch.ones((), dtype=cur.dtype, device=cur.device)
    for i in range(k):
        # the highest score not yet emitted (the first of equals)
        j = torch.where(done, neg_inf, cur).argmax(dim=-1, keepdim=True)
        done.scatter_(-1, j, True)
        order[..., i] = j[..., 0]
        row = torch.gather(iou, -2, j[..., None].expand(*j.shape, k))[..., 0, :]
        if method == "gaussian":
            decay = torch.exp(-(row * row) / sigma)
        else:
            decay = torch.where(row > iou_threshold, 1.0 - row, one)
        cur = cur * torch.where(done, one, decay)  # emitted boxes keep their scores
    out_boxes = torch.gather(top_boxes, -2, order[..., None].expand(*order.shape, 4))
    out_scores = torch.gather(cur, -1, order)
    # >= : an undecayed box exactly AT the threshold passed the input filter
    valid = out_scores >= score_threshold
    out_scores = torch.where(valid, out_scores, torch.zeros_like(out_scores))
    return _pad_slots(out_boxes, top_k, 1), _pad_slots(out_scores, top_k), _pad_slots(valid, top_k)


def batched_class_nms(boxes: torch.Tensor, class_scores: torch.Tensor,
                      iou_threshold: float = 0.5, score_threshold: float = 0.05,
                      top_k_per_class: int = 100, nms: str = "hard",
                      soft_nms_sigma: float = 0.5
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class NMS (classes don't suppress each other, matching the
    reference's per-class torchvision call): boxes (..., A, 4), class_scores
    (..., A, C) -> (..., C*top_k, 4) boxes, scores, class ids, valid mask,
    class-major. ``nms`` picks hard suppression or gaussian soft-NMS; every
    class of every slate goes through one batched call."""
    per_class = class_scores.transpose(-1, -2)  # (..., C, A)
    b = boxes.unsqueeze(-3)  # (..., 1, A, 4)
    if nms == "soft":
        bb, ss, vv = soft_nms(b, per_class, sigma=soft_nms_sigma, iou_threshold=iou_threshold,
                              score_threshold=score_threshold, top_k=top_k_per_class)
    elif nms == "hard":
        bb, ss, vv = static_nms(b, per_class, iou_threshold, score_threshold, top_k_per_class)
    else:
        raise ValueError(f"unknown nms: {nms}")
    C = class_scores.shape[-1]
    lead = class_scores.shape[:-2]
    classes = torch.arange(C, device=class_scores.device)[:, None].expand(*lead, C,
                                                                         top_k_per_class)
    n = C * top_k_per_class
    return (bb.reshape(*lead, n, 4), ss.reshape(*lead, n), classes.reshape(*lead, n),
            vv.reshape(*lead, n))
