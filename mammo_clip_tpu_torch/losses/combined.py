"""Config-driven combined loss (port of ``mammo_clip_tpu/losses/combined.py``).

``build_loss(loss_config)`` returns ``loss_fn(outputs, batch, is_train) -> dict``
with per-loss sub-terms plus ``"total"`` = sum(loss * loss_ratio); losses with
``loss_ratio == 0`` are skipped. Each kind reports under its own key:
``breast_clip`` and ``breast_clip_contrastive`` under ``contrastive`` (so only
one of them may be on), ``classification`` (BCE of ``outputs["cls_pred"]``
against ``batch["target_class"]``) under ``classification``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from .classification import bce_with_logits_loss
from .clip_loss import contrastive_clip_loss, multi_positive_clip_loss

LossFn = Callable[[Dict, Dict, bool], Dict[str, torch.Tensor]]


def _contrastive(fn):
    def loss(outputs, batch, is_train, **cfg):
        return fn(image_embeddings=outputs["image_embeddings"],
                  text_embeddings=outputs["text_embeddings"],
                  text_embeddings2=outputs.get("text_embeddings2"),
                  image_view_embeddings=outputs.get("image_view_embeddings"),
                  logit_scale=outputs["logit_scale"], is_train=is_train, **cfg)
    return loss


def _classification(outputs, batch, is_train, **cfg):
    return {"classification": bce_with_logits_loss(outputs["cls_pred"], batch["target_class"],
                                                   **cfg)}


# kind -> (output key, fn(outputs, batch, is_train, **cfg) -> {key: loss, sub-terms...})
_KINDS = {"breast_clip": ("contrastive", _contrastive(multi_positive_clip_loss)),
          "breast_clip_contrastive": ("contrastive", _contrastive(contrastive_clip_loss)),
          "classification": ("classification", _classification)}


def build_loss(all_loss_config: Dict) -> LossFn:
    entries = []
    for name, cfg in all_loss_config.items():
        cfg = dict(cfg)
        ratio = cfg.pop("loss_ratio", 1.0)
        if ratio == 0.0:
            continue
        if name not in _KINDS:
            raise KeyError(f"Unknown loss: {name}")
        key, fn = _KINDS[name]
        entries.append((key, ratio, fn, cfg))
    keys = [e[0] for e in entries]
    if len(set(keys)) != len(keys):
        # both contrastive kinds report under 'contrastive' (the reference treats
        # them as alternatives); both on would overwrite the first's terms
        raise ValueError(f"duplicate loss output keys {keys}: enable only one "
                         "contrastive objective (or set loss_ratio: 0)")

    def loss_fn(outputs: Dict, batch: Dict, is_train: bool = True) -> Dict[str, torch.Tensor]:
        loss_dict: Dict[str, torch.Tensor] = {}
        total = None
        for key, ratio, fn, cfg in entries:
            sub = fn(outputs, batch, is_train, **cfg)
            for k, v in sub.items():
                loss_dict[k if k == key else f"{key}/{k}"] = v
            total = ratio * sub[key] if total is None else total + ratio * sub[key]
        loss_dict["total"] = total if total is not None else torch.zeros(())
        return loss_dict

    return loss_fn
