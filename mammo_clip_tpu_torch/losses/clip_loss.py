"""Contrastive losses (port of ``mammo_clip_tpu/losses/clip_loss.py``).

Multi-positive symmetric InfoNCE and the single-pair ConVIRT variant. In one
process the global batch is the local batch: labels are ``arange(batch)`` and
no collective runs. Under a data-parallel process group (``core/mesh.py``)
both losses run over the global batch through ``parallel/shard_loss.py``
(gathered negatives, rank-offset labels, the ranks' mean). Logits are computed in fp32 (TF32 is left to the caller's
switches, which the port keeps off). Sub-terms are returned, never logged here.

total = (i2t + t2i)/2 + i2i_weight * i2i + t2t_weight * t2t, with the 4
view/text pairs averaged and label smoothing on i2t/t2i only (train only).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.mesh import data_size, data_sum


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE with torch-style label smoothing (target (1-s)*onehot + s/classes)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * (-logp.mean(dim=-1))
    return nll.mean()


def _pair_ce(a, b, scale, labels, smoothing):
    return cross_entropy(scale * (a.float() @ b.float().T), labels, smoothing)


def multi_positive_clip_loss(image_embeddings, text_embeddings, logit_scale,
                             text_embeddings2: Optional[torch.Tensor] = None,
                             image_view_embeddings: Optional[torch.Tensor] = None,
                             label_smoothing: float = 0.0, i2i_weight: float = 1.0,
                             t2t_weight: float = 0.5, is_train: bool = True,
                             **_: object) -> Dict[str, torch.Tensor]:
    """Multi-positive symmetric InfoNCE; degrades to the symmetric 2-term CLIP
    loss when the second view or text is absent."""
    if data_size() > 1:
        from ..parallel.shard_loss import gathered_clip_loss

        return gathered_clip_loss(
            image_embeddings, text_embeddings, logit_scale, text_embeddings2=text_embeddings2,
            image_view_embeddings=image_view_embeddings, label_smoothing=label_smoothing,
            i2i_weight=i2i_weight, t2t_weight=t2t_weight, is_train=is_train,
            group=data_sum().group)
    n = image_embeddings.shape[0]
    labels = torch.arange(n, device=image_embeddings.device)
    s = label_smoothing if is_train else 0.0
    scale = logit_scale.float()
    i1, t1 = image_embeddings, text_embeddings
    if text_embeddings2 is None or image_view_embeddings is None:
        loss_i2t = _pair_ce(i1, t1, scale, labels, s)
        loss_t2i = _pair_ce(t1, i1, scale, labels, s)
        return {"contrastive": (loss_i2t + loss_t2i) / 2.0, "i2t": loss_i2t, "t2i": loss_t2i}
    i2, t2 = image_view_embeddings, text_embeddings2
    loss_i2t = (_pair_ce(i1, t1, scale, labels, s) + _pair_ce(i2, t1, scale, labels, s)
                + _pair_ce(i1, t2, scale, labels, s) + _pair_ce(i2, t2, scale, labels, s)) / 4.0
    loss_t2i = (_pair_ce(t1, i1, scale, labels, s) + _pair_ce(t1, i2, scale, labels, s)
                + _pair_ce(t2, i1, scale, labels, s) + _pair_ce(t2, i2, scale, labels, s)) / 4.0
    loss_i2i = (_pair_ce(i1, i2, scale, labels, 0.0) + _pair_ce(i2, i1, scale, labels, 0.0)) / 2.0
    loss_t2t = (_pair_ce(t2, t1, scale, labels, 0.0) + _pair_ce(t1, t2, scale, labels, 0.0)) / 2.0
    total = (loss_i2t + loss_t2i) / 2.0 + i2i_weight * loss_i2i + t2t_weight * loss_t2t
    return {"contrastive": total, "i2t": loss_i2t, "t2i": loss_t2i, "i2i": loss_i2i,
            "t2t": loss_t2t}


def contrastive_clip_loss(image_embeddings, text_embeddings, logit_scale,
                          label_smoothing: float = 0.0, i2t_weight: float = 0.75,
                          t2i_weight: float = 0.25, is_train: bool = True,
                          **_: object) -> Dict[str, torch.Tensor]:
    """ConVIRT-style asymmetric single-pair loss: 0.75*i2t + 0.25*t2i."""
    if data_size() > 1:
        from ..parallel.shard_loss import gathered_contrastive_clip_loss

        return gathered_contrastive_clip_loss(
            image_embeddings, text_embeddings, logit_scale, label_smoothing=label_smoothing,
            i2t_weight=i2t_weight, t2i_weight=t2i_weight, is_train=is_train,
            group=data_sum().group)
    n = image_embeddings.shape[0]
    labels = torch.arange(n, device=image_embeddings.device)
    s = label_smoothing if is_train else 0.0
    scale = logit_scale.float()
    loss_i2t = _pair_ce(image_embeddings, text_embeddings, scale, labels, s)
    loss_t2i = _pair_ce(text_embeddings, image_embeddings, scale, labels, s)
    return {"contrastive": i2t_weight * loss_i2t + t2i_weight * loss_t2i,
            "i2t": loss_i2t, "t2i": loss_t2i}
