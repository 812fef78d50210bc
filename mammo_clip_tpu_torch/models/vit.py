"""Vision Transformer image encoder with interpolated position embeddings
(port of ``mammo_clip_tpu/models/vit.py``).

Patch embedding as a strided conv with a bias, a CLS token, pre-norm blocks
(LayerNorm eps 1e-12, exact GELU) and a final LayerNorm; ``pooled`` is the
CLS token, ``features`` the patch tokens as a (B, H/p, W/p, D) map,
``tokens`` the whole sequence. The position embeddings are learned on a
``base_grid`` x ``base_grid`` grid and resized to the input's grid as
``jax.image.resize(..., "bilinear")`` does: half-pixel centres, antialiased
when the grid shrinks (``F.interpolate(..., antialias=True)``), plain
bilinear when it grows.

Attention keeps Flax's ``MultiHeadDotProductAttention`` tree (``attn.query``,
``key``, ``value`` with (D, heads, head_dim) kernels, ``attn.out`` with
(heads, head_dim, D)); q is divided by sqrt(head_dim) as Flax does, and the
softmax attention itself is ``ops/flash_attention.flash_attention`` on
contiguous (B, heads, S, head_dim) tensors in the activation type: the
hand-written kernel of ``csrc/flash_attention.cu`` on a CUDA tensor, its plain
version on a CPU tensor. The kernel keeps the (S, S) scores on chip and saves
only the log-sum-exp for the backward, which at 1520x912 (S = 5416) is what
lets a training step fit one card. The kernel takes no dropout, so a config
with ``dropout_rate`` > 0 raises (the JAX factory never sets it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention
from .bert import Dense, LayerNorm
from .efficientnet import Conv

LN_EPS = 1e-12  # HF ViTConfig.layer_norm_eps (weight-import parity)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    base_grid: int = 14  # pretraining grid (224/16); pos embeddings interpolate from it
    dropout_rate: float = 0.0

    @classmethod
    def tiny(cls) -> "ViTConfig":
        return cls(patch_size=8, hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64,
                   base_grid=4)


class ViTAttention(nn.Module):
    def __init__(self, features: int, heads: int):
        super().__init__()
        self.heads, self.head_dim = heads, features // heads
        self.query = Dense((features,), (heads, self.head_dim))
        self.key = Dense((features,), (heads, self.head_dim))
        self.value = Dense((features,), (heads, self.head_dim))
        self.out = Dense((heads, self.head_dim), (features,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bnsd = lambda t: t.transpose(1, 2).contiguous()  # (B, S, N, D) -> (B, N, S, D)
        q = self.query(x) / math.sqrt(self.head_dim)
        ctx = flash_attention(bnsd(q), bnsd(self.key(x)), bnsd(self.value(x)), 1.0)
        return self.out(ctx.transpose(1, 2))


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size, LN_EPS)
        self.attn = ViTAttention(cfg.hidden_size, cfg.num_heads)
        self.ln2 = LayerNorm(cfg.hidden_size, LN_EPS)
        self.fc1 = Dense((cfg.hidden_size,), (cfg.mlp_dim,))
        self.fc2 = Dense((cfg.mlp_dim,), (cfg.hidden_size,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="none"))


def resize_grid(grid: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(1, g, g, D) -> (1, gh, gw, D) as ``jax.image.resize(..., "bilinear")``."""
    g = grid.shape[1]
    if (gh, gw) == (g, g):
        return grid
    out = F.interpolate(grid.permute(0, 3, 1, 2), size=(gh, gw), mode="bilinear",
                        align_corners=False, antialias=gh < g or gw < g)
    return out.permute(0, 2, 3, 1)


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig = ViTConfig(), in_channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.dropout_rate > 0.0:
            raise NotImplementedError("ViT dropout_rate > 0: the flash-attention kernel "
                                      "takes no dropout")
        self.cfg, self.in_channels, self.dtype = cfg, in_channels, dtype
        d = cfg.hidden_size
        self.patch_embed = Conv(in_channels, d, cfg.patch_size, cfg.patch_size, bias=True)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embedding = nn.Parameter(torch.zeros(1, cfg.base_grid ** 2 + 1, d))
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", ViTBlock(cfg))
        self.ln_final = LayerNorm(d, LN_EPS)

    @property
    def out_dim(self) -> int:
        return self.cfg.hidden_size

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        cfg, dt = self.cfg, self.dtype
        B, H, W, C = x.shape
        p, d, g = cfg.patch_size, cfg.hidden_size, cfg.base_grid
        if C != self.in_channels or H % p or W % p:
            raise ValueError(f"expected NHWC with C={self.in_channels} and H, W divisible by "
                             f"the patch {p}, got {tuple(x.shape)}")
        patches = self.patch_embed(x.permute(0, 3, 1, 2).contiguous().to(dt))
        gh, gw = patches.shape[2:]
        tokens = patches.flatten(2).transpose(1, 2)  # (B, gh*gw, D)
        cls_pos, grid = self.pos_embedding[:, :1], self.pos_embedding[:, 1:]
        grid = resize_grid(grid.reshape(1, g, g, d), gh, gw).reshape(1, gh * gw, d)
        tokens = tokens + grid.to(dt)
        cls = (self.cls_token + cls_pos).expand(B, 1, d).to(dt)
        seq = torch.cat([cls, tokens], dim=1)
        for i in range(cfg.num_layers):
            seq = getattr(self, f"block_{i}")(seq)
        seq = self.ln_final(seq)
        return {"pooled": seq[:, 0], "features": seq[:, 1:].reshape(B, gh, gw, d),
                "tokens": seq}
