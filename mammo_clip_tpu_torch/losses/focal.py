"""RetinaNet focal + smooth-L1 losses, vectorized over (batch, anchors) (port of
``mammo_clip_tpu/losses/focal.py``).

Math parity with the reference FocalLoss (reference:
Detectors/retinanet/losses.py:33-168): IoU assignment <0.4 negative / >=0.5
positive / in-between ignored (losses.py:82-92), alpha-balanced focal BCE on
probabilities clipped to [1e-4, 1 - 1e-4], normalized by clamp(num_pos, 1)
(losses.py:95-121), smooth-L1 (beta=1/9) on std-normalized box deltas of the
positive anchors (losses.py:142-162). An image without boxes trains every
anchor toward 0 (losses.py:60-76). Annotations are (B, M, 5) rows
[x1, y1, x2, y2, class] padded with -1 rows (the reference's pad-collator,
dataset_concepts.py:185-205). Computed in fp32 whatever the predictions' dtype.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.boxes import box_iou, encode_boxes


def focal_loss(cls_pred: torch.Tensor, reg_pred: torch.Tensor, anchors: torch.Tensor,
               annotations: torch.Tensor, alpha: float = 0.25, gamma: float = 2.0
               ) -> Dict[str, torch.Tensor]:
    """cls_pred (B, A, C) post-sigmoid probabilities, reg_pred (B, A, 4),
    anchors (A, 4), annotations (B, M, 5) -> {classification, regression,
    total}: each image's losses, averaged over the batch."""
    C = cls_pred.shape[-1]
    gt = annotations.float()
    valid_gt = gt[..., 4] >= 0  # (B, M)
    has_gt = valid_gt.any(dim=-1)  # (B,)

    iou = box_iou(anchors.float()[None], gt[..., :4])  # (B, A, M)
    iou = torch.where(valid_gt[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(dim=-1)
    best_gt = iou.argmax(dim=-1)  # the first of equals, as jnp.argmax

    positive = (best_iou >= 0.5) & has_gt[:, None]
    negative = torch.where(has_gt[:, None], best_iou < 0.4, torch.ones_like(positive))
    ignored = ~(positive | negative)

    cls_p = torch.clamp(cls_pred.float(), 1e-4, 1.0 - 1e-4)
    gt_class = torch.gather(gt[..., 4], 1, best_gt).long()  # (B, A); -1 on padded rows
    targets = positive[..., None] & (gt_class[..., None]
                                     == torch.arange(C, device=gt_class.device))

    alpha_factor = torch.where(targets, alpha, 1.0 - alpha)
    focal_weight = torch.where(targets, 1.0 - cls_p, cls_p) ** gamma
    bce = -torch.where(targets, torch.log(cls_p), torch.log(1.0 - cls_p))
    cls_loss = alpha_factor * focal_weight * bce
    cls_loss = torch.where(ignored[..., None], torch.zeros_like(cls_loss), cls_loss)
    num_pos = torch.clamp(positive.float().sum(dim=-1), min=1.0)
    cls_loss = cls_loss.sum(dim=(1, 2)) / num_pos

    matched = torch.gather(gt[..., :4], 1, best_gt[..., None].expand(*best_gt.shape, 4))
    reg_targets = encode_boxes(anchors.float()[None], matched)
    diff = torch.abs(reg_targets - reg_pred.float())
    # torch-style smooth L1 with beta = 1/9 (losses.py:151-160)
    reg_loss = torch.where(diff <= 1.0 / 9.0, 0.5 * 9.0 * diff ** 2, diff - 0.5 / 9.0)
    reg_loss = torch.where(positive[..., None], reg_loss, torch.zeros_like(reg_loss))
    reg_loss = reg_loss.mean(dim=-1).sum(dim=-1) / num_pos
    reg_loss = torch.where(has_gt, reg_loss, torch.zeros_like(reg_loss))

    out = {"classification": cls_loss.mean(), "regression": reg_loss.mean()}
    out["total"] = out["classification"] + out["regression"]
    return out
