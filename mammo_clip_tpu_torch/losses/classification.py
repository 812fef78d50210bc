"""Classification losses (port of ``mammo_clip_tpu/losses/classification.py``).

``bce_with_logits_loss`` is the reference's ``Classification`` loss
(reference: breastclip/loss/classification.py:4-16): BCE-with-logits after
clamping negative (missing) labels to 0, done functionally instead of the
reference's in-place label mutation, with the weighted-BCE ``pos_weight`` of
the downstream classifier (reference: Classifiers/experiments.py:103-141,
pos_weight tables train_classifier.py:113-141). ``softmax_ce_loss`` is the CE
of the density / BIRADS heads. Both compute in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def bce_with_logits_loss(logits: torch.Tensor, targets: torch.Tensor,
                         pos_weight: Optional[float] = None, **_: object) -> torch.Tensor:
    """Mean binary cross entropy with logits; negative targets clamped to 0.

    With ``pos_weight`` w: loss = -[w * y * log(sigmoid(x)) + (1-y) * log(1-sigmoid(x))],
    as torch.nn.BCEWithLogitsLoss(pos_weight=...).
    """
    logits = logits.float()
    targets = torch.clamp(targets.float(), min=0.0)
    w_pos = 1.0 if pos_weight is None else pos_weight
    loss = -(w_pos * targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))
    return loss.mean()


def softmax_ce_loss(logits: torch.Tensor, labels: torch.Tensor, **_: object) -> torch.Tensor:
    """Multi-class CE for density (4-way) / BIRADS (3-way) heads
    (reference: Classifiers/experiments.py:103-108,140-141); labels are cast
    to int as the JAX loss does."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()
