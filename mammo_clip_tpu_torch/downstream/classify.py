"""Downstream classification: linear probe / full finetune over the CLIP encoder
(port of ``mammo_clip_tpu/downstream/classify.py``).

* ``MammoClassifier`` rebuilds the image encoder from the checkpoint-embedded
  config (``models/clip.py::load_image_encoder``, under the name
  ``image_encoder``), optionally freezes it for linear probing, and puts a
  single Dense head on the pooled features (reference:
  Classifiers/models/breast_clip_classifier.py:6-57; lp-freeze :20-25).
* ``MammoEfficientNetClassifier`` is the pure-supervised baseline: EfficientNet
  + GeM pooling + 1-logit head (reference: breastclip/model/mamo_efficient_net.py:66-91).
* Hard-coded class-balance pos_weight tables (reference: train_classifier.py:113-141).
* Patient-laterality probability aggregation for RSNA CV scoring (reference:
  Classifiers/experiments.py:171-173 groupby(patient, laterality).mean()),
  without pandas.

The frozen (linear-probe) encoder runs in eval mode (BatchNorm running
statistics, no stochastic depth) under ``torch.no_grad()``: the JAX module's
``stop_gradient`` plus eval-mode BN, and the reference's custom ``train()``
that pins the encoder in eval (image_classification.py:50-61). An lp step
costs a forward on the encoder, and its parameters and statistics stay as
they are. The head and the logits are fp32 whatever the encoder's activation
type.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..data.metadata import Table
from ..models import init_parameters
from ..models.bert import Dense
from ..models.clip import image_encoder_state, load_image_encoder
from ..models.efficientnet import EfficientNet
from ..ops.pooling import gem_pool

# reference: train_classifier.py:113-141 — BCE pos_weight per dataset/label (fold tables
# collapsed to their common value; RSNA's per-fold values are ~46.5).
POS_WEIGHTS: Dict[str, float] = {
    "rsna/cancer": 46.5,
    "vindr/Mass": 15.573306,
    "vindr/Suspicious_Calcification": 37.296728,
}


class MammoClassifier(nn.Module):
    """CLIP-encoder classifier. ``image_encoder_config`` comes from the pretrain
    checkpoint's embedded config (the cross-stack contract); ``dtype`` is the
    encoder's activation type."""

    def __init__(self, image_encoder_config: Mapping, num_classes: int = 1,
                 freeze_encoder: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.freeze_encoder = freeze_encoder
        self.image_encoder = load_image_encoder(dict(image_encoder_config), dtype=dtype)
        self.head = Dense((self.image_encoder.out_dim,), (num_classes,))

    def trainable_parameters(self) -> List[Tuple[str, nn.Parameter]]:
        """The parameters an optimizer updates: the head's alone in a linear
        probe (the reference's ``requires_grad=False`` encoder), else all."""
        return [(n, p) for n, p in self.named_parameters()
                if not (self.freeze_encoder and n.startswith("image_encoder."))]

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if self.freeze_encoder:
            with torch.no_grad():
                feats = self.image_encoder(images, train=False)
        else:
            feats = self.image_encoder(images, train=train, generator=generator)
        pooled = feats["pooled"]
        return {"logits": self.head(pooled.float()), "pooled_features": pooled,
                "raw_features": feats["features"]}


class MammoEfficientNetClassifier(nn.Module):
    """Pure-supervised baseline ('pretrained_classifier'): EfficientNet + GeM + fc
    (reference: mamo_efficient_net.py:66-91, GeM p=3). ``in_channels`` is the
    images' channel count, which the JAX module reads from its first input."""

    def __init__(self, variant: str = "b5", num_classes: int = 1, gem_p: float = 3.0,
                 in_channels: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gem_p = gem_p
        self.encoder = EfficientNet(variant=variant, in_channels=in_channels, dtype=dtype)
        self.head = Dense((self.encoder.out_dim,), (num_classes,))

    def trainable_parameters(self) -> List[Tuple[str, nn.Parameter]]:
        return list(self.named_parameters())

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        feats = self.encoder(images, train=train, generator=generator)
        pooled = gem_pool(feats["features"].permute(0, 3, 1, 2), p=self.gem_p)
        return {"logits": self.head(pooled.float()), "pooled_features": pooled,
                "raw_features": feats["features"]}


def classifier_from_clip_checkpoint(clip_config: Mapping, clip_state: Mapping[str, torch.Tensor],
                                    num_classes: int, freeze_encoder: bool,
                                    dtype: torch.dtype = torch.float32, device="cpu",
                                    generator: Optional[torch.Generator] = None
                                    ) -> MammoClassifier:
    """Build a MammoClassifier on ``device`` and initialise its encoder from a CLIP
    model's state dict (``clip_state``, e.g. ``MammoCLIP.state_dict()``).

    Mirrors the reference's strict image_encoder.* load
    (breast_clip_classifier.py:12-17): the encoder's parameters and BatchNorm
    statistics are copied verbatim from the CLIP checkpoint; only the head is
    freshly initialised, from ``generator`` (a CPU one seeded 0 when None),
    as Flax's ``Dense`` is: a lecun-normal kernel and a zero bias.
    """
    model = MammoClassifier(dict(clip_config["model"]["image_encoder"]), num_classes=num_classes,
                            freeze_encoder=freeze_encoder, dtype=dtype)
    model.image_encoder.load_state_dict(image_encoder_state(clip_state))
    init_parameters(model.head, generator or torch.Generator().manual_seed(0))
    return model.to(device)


def group_means(keys: Sequence[tuple], columns: Mapping[str, np.ndarray]
                ) -> Tuple[List[tuple], Dict[str, np.ndarray]]:
    """``DataFrame.groupby(keys).mean()`` without pandas: the distinct keys,
    sorted as pandas sorts them (by each key's own type: integer ids
    numerically, strings lexicographically), and each column's mean per key,
    summed in float64 and returned in pandas' dtype (float32 stays float32,
    anything else becomes float64)."""
    order: Dict[tuple, List[int]] = {}
    for i, k in enumerate(keys):
        order.setdefault(tuple(k), []).append(i)
    groups = sorted(order)
    out = {}
    for name, col in columns.items():
        col = np.asarray(col)
        dtype = np.result_type(col.dtype, np.float32)
        out[name] = np.asarray([col[order[g]].astype(np.float64).mean() for g in groups],
                               dtype=dtype)
    return groups, out


def aggregate_rsna_predictions(rows: Table, pred_col: str = "pred",
                               label_col: str = "cancer") -> Table:
    """Patient-laterality groupby-mean aggregation for RSNA scoring
    (reference: Classifiers/experiments.py:56-77,171-173): one row per
    (patient_id, laterality) in pandas' sorted order, with the mean of
    ``pred_col`` and ``label_col``."""
    keys = [(r["patient_id"], r["laterality"]) for r in rows]
    groups, means = group_means(keys, {c: [r[c] for r in rows] for c in (pred_col, label_col)})
    return Table(({"patient_id": p, "laterality": lat, pred_col: means[pred_col][i],
                   label_col: means[label_col][i]} for i, (p, lat) in enumerate(groups)),
                 ("patient_id", "laterality", pred_col, label_col))


def rsna_aggregator(rows: Table):
    """``aggregate(preds, labels, meta)`` for ``train_classifier``: the
    predictions of ``rows`` (the validation fold, every row, in order) and
    their labels through ``aggregate_rsna_predictions``, as arrays in its
    order."""
    cols = ("patient_id", "laterality", "pred", "label")

    def aggregate(preds, labels, meta):
        if len(preds) != len(rows):
            raise ValueError(f"{len(preds)} predictions for {len(rows)} validation rows")
        agg = aggregate_rsna_predictions(
            Table((dict(zip(cols, (r["patient_id"], r["laterality"], p, y)))
                   for r, p, y in zip(rows, preds, labels)), cols), "pred", "label")
        return np.asarray([r["pred"] for r in agg]), np.asarray([r["label"] for r in agg])
    return aggregate
