"""Mammo-FActOR: region-to-sentence interpretability mapper (port of
``mammo_clip_tpu/interpret/factor.py``; reference:
notebooks/Mammo-Factor/Mammo-Factor.ipynb cells 1-3).

* attribute embeddings = L2-normalized mean of the attribute's prompt
  embeddings from the frozen CLIP text tower (cell 1);
* ``FactorMapper``: the frozen image encoder's raw feature map (B, H, W, C),
  any family's ``features``, is read as C per-channel "regions", each a
  flattened (H*W,) spatial signature; one 2-layer MLP per attribute
  (``proj{i}_fc1``, ``proj{i}_fc2``, Flax Denses) projects the signatures
  into the language space (cell 2), or one shared MLP with ``one_proj``;
  ``adapter`` blends 0.2 of the projection with 0.8 of the signature's first
  ``lang_dim`` entries;
* ``factor_loss``: region-attribute max-similarity contrastive loss at
  temperature 0.07 (cell 3), over every attribute with the absent ones
  masked out of the mean (a fixed shape, equal to the reference's selection).

The encoder stays outside (frozen, supplied features), so the mapper trains
with forward-only encoder cost.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.bert import Dense


class FactorMapper(nn.Module):
    """Per-attribute region projection heads over frozen CLIP feature maps."""

    def __init__(self, num_attributes: int, lang_dim: int = 512, spatial_dim: int = 0,
                 one_proj: bool = False, adapter: bool = False):
        super().__init__()
        self.num_attributes, self.lang_dim, self.spatial_dim = num_attributes, lang_dim, spatial_dim
        self.one_proj, self.adapter = one_proj, adapter
        self.n_proj = 1 if one_proj else num_attributes
        for i in range(self.n_proj):
            self.add_module(f"proj{i}_fc1", Dense((spatial_dim,), (spatial_dim,)))
            self.add_module(f"proj{i}_fc2", Dense((spatial_dim,), (lang_dim,)))

    def forward(self, raw_features: torch.Tensor) -> torch.Tensor:
        """raw_features (B, H, W, C) -> region embeddings (B, C, A, lang_dim)."""
        B, H, W, C = raw_features.shape
        if H * W != self.spatial_dim:
            raise ValueError(f"feature map {H}x{W} is not spatial_dim {self.spatial_dim}")
        flat = raw_features.reshape(B, H * W, C).transpose(1, 2).float()  # (B, C, HW)
        outs = []
        for i in range(self.n_proj):
            h = F.relu(getattr(self, f"proj{i}_fc1")(flat))
            h = getattr(self, f"proj{i}_fc2")(h)
            if self.adapter:
                h = 0.2 * h + 0.8 * flat[..., : self.lang_dim]
            outs.append(h)
        out = torch.stack(outs, dim=2)  # (B, C, n_proj, L)
        if self.one_proj:
            out = out.expand(B, C, self.num_attributes, self.lang_dim)
        return out


def factor_loss(region_embs: torch.Tensor, attr_embs: torch.Tensor, labels: torch.Tensor,
                temperature: float = 0.07) -> torch.Tensor:
    """Region-attribute max-similarity contrastive loss (notebook cell 3).

    ``region_embs`` (B, C, A, L) from ``FactorMapper``, ``attr_embs`` (A, L)
    L2-normalized, ``labels`` (B, A) binary. The regions are normalized by
    rsqrt(sum^2 + 1e-12), whose gradient stays finite at an exactly-zero row
    (the mapper can emit one at init); an image's similarity to an attribute
    is its regions' maximum, ties sharing the gradient as in JAX
    (``torch.amax``)."""
    regions = region_embs.float()
    regions = regions * torch.rsqrt((regions * regions).sum(dim=-1, keepdim=True) + 1e-12)
    sim_regions = torch.einsum("bcal,al->bca", regions, attr_embs.float())
    sim = torch.amax(sim_regions, dim=1) / temperature  # (B, A) image-attribute sims

    labels = labels.float()
    attr_present = (labels.sum(dim=0) > 0).float()  # (A,)
    inv = 1.0 - labels
    # denom[b, a] = exp(sim[b,a]) + sum_b' exp(sim[b',a] * inv[b',a])
    denom = torch.exp(sim) + torch.exp(sim * inv).sum(dim=0, keepdim=True)
    log_prob = sim - torch.log(denom)
    mask = labels * attr_present[None, :]
    n_terms = torch.clamp(mask.sum(), min=1.0)
    return -(log_prob * mask).sum() / n_terms


def attribute_embeddings(extractor, tokenizer, attribute_prompts: Dict[str, Sequence[str]],
                         max_length: int = 256) -> Dict[str, np.ndarray]:
    """attribute -> L2-normalized mean prompt embedding (notebook cell 1)."""
    out: Dict[str, np.ndarray] = {}
    for attr, prompts in attribute_prompts.items():
        enc = tokenizer(list(prompts), max_length=max_length)
        emb = extractor.encode_texts(enc["input_ids"], enc["attention_mask"])
        mean = emb.mean(axis=0)
        out[attr] = mean / np.linalg.norm(mean)
    return out
