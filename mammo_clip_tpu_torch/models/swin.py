"""Swin Transformer image encoder (port of ``mammo_clip_tpu/models/swin.py``).

Swin-v1 topology: a p x p patch embedding (conv with a bias) and LayerNorm,
then stages of window attention with alternating shifted windows (roll by
-shift, attend, roll back by +shift, with the -1e9 mask between the regions
the roll brought together), and patch merging between stages: the 2x2
sub-grids concatenated in the space-to-depth order [(0,0),(0,1),(1,0),(1,1)],
LayerNorm, a Dense without bias to twice the channels. ``pooled`` is the
mean of the final LayerNorm's map, ``features`` the map itself (NHWC).

Each block's ``qkv`` is one DenseGeneral with a (C, 3, heads, head_dim)
kernel and ``proj`` contracts (heads, head_dim), as in the Flax tree; the
logits are cast to fp32 before the learned relative-position bias
(``rel_pos_table``, (2w-1)^2 x heads) and the shift mask are added, and the
softmax runs in fp32. Window attention is plain matmul and softmax (in JAX it
is XLA, not a Pallas kernel). There is no shift where a stage's grid is a
single window, and each stage's grid must divide by the window: an input
must divide by patch * window * 2^(stages - 1) (256 for Swin-T, so its
full-width input is 1536x1024, not 1520x912).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .bert import Dense, LayerNorm
from .efficientnet import Conv

LN_EPS = 1e-5  # HF SwinConfig.layer_norm_eps (weight-import parity)
MLP_RATIO = 4


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    embed_dim: int = 96
    depths: Sequence[int] = (2, 2, 6, 2)
    num_heads: Sequence[int] = (3, 6, 12, 24)
    window: int = 8

    @classmethod
    def tiny_test(cls) -> "SwinConfig":
        return cls(patch_size=4, embed_dim=16, depths=(1, 1), num_heads=(2, 2), window=4)

    @property
    def out_dim(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


def _window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def _window_reverse(windows: torch.Tensor, w: int, B: int, H: int, W: int) -> torch.Tensor:
    C = windows.shape[-1]
    x = windows.reshape(B, H // w, W // w, w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def _rel_pos_index(w: int) -> np.ndarray:
    """(w*w, w*w) indices into the (2w-1)^2 relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    coords = coords.reshape(2, -1)  # (2, w*w)
    rel = coords[:, :, None] - coords[:, None, :]  # (2, w*w, w*w)
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int32)


def _shift_mask(H: int, W: int, w: int, shift: int) -> np.ndarray:
    """(num_windows, w*w, w*w) additive mask for shifted-window attention."""
    img = np.zeros((1, H, W, 1), np.int32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    wins = img.reshape(1, H // w, w, W // w, w, 1).transpose(0, 1, 3, 2, 4, 5)
    wins = wins.reshape(-1, w * w)
    diff = wins[:, :, None] != wins[:, None, :]
    return np.where(diff, -1e9, 0.0).astype(np.float32)


class SwinBlock(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, heads: int):
        super().__init__()
        w = cfg.window
        self.window, self.heads, self.head_dim = w, heads, dim // heads
        self.ln1 = LayerNorm(dim, LN_EPS)
        self.qkv = Dense((dim,), (3, heads, self.head_dim))
        self.rel_pos_table = nn.Parameter(torch.zeros((2 * w - 1) ** 2, heads))
        self.proj = Dense((heads, self.head_dim), (dim,))
        self.ln2 = LayerNorm(dim, LN_EPS)
        self.fc1 = Dense((dim,), (dim * MLP_RATIO,))
        self.fc2 = Dense((dim * MLP_RATIO,), (dim,))
        self.register_buffer("rel_index", torch.from_numpy(_rel_pos_index(w).reshape(-1)).long(),
                             persistent=False)
        self._masks: Dict[tuple, torch.Tensor] = {}

    def _mask(self, H: int, W: int, shift: int, device) -> torch.Tensor:
        key = (H, W, shift, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(_shift_mask(H, W, self.window, shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        B, H, W, C = x.shape
        w, n, ww = self.window, self.heads, self.window ** 2
        h = self.ln1(x)
        if shift:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        qkv = self.qkv(_window_partition(h, w))  # (B*nW, ww, 3, heads, head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B*nW, heads, ww, hd)
        logits = ((q * self.head_dim ** -0.5) @ k.transpose(-1, -2)).float()
        bias = self.rel_pos_table.float()[self.rel_index].reshape(ww, ww, n)
        logits = logits + bias.permute(2, 0, 1)[None]
        if shift:
            mask = self._mask(H, W, shift, x.device)  # (nW, ww, ww)
            logits = (logits.reshape(B, mask.shape[0], n, ww, ww)
                      + mask[None, :, None]).reshape(-1, n, ww, ww)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = self.proj((attn @ v).transpose(1, 2))  # (B*nW, ww, C)
        out = _window_reverse(out, w, B, H, W)
        if shift:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        x = x + out
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="none"))


class SwinTransformer(nn.Module):
    def __init__(self, cfg: SwinConfig = SwinConfig(), in_channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.in_channels, self.dtype = cfg, in_channels, dtype
        p, dim = cfg.patch_size, cfg.embed_dim
        self.patch_embed = Conv(in_channels, dim, p, p, bias=True)
        self.patch_ln = LayerNorm(dim, LN_EPS)
        for stage, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            if stage > 0:
                self.add_module(f"merge_ln{stage}", LayerNorm(4 * dim, LN_EPS))
                self.add_module(f"merge{stage}", Dense((4 * dim,), (2 * dim,), use_bias=False))
                dim *= 2
            for i in range(depth):
                self.add_module(f"stage{stage}_block{i}", SwinBlock(cfg, dim, heads))
        self.final_ln = LayerNorm(dim, LN_EPS)

    @property
    def out_dim(self) -> int:
        return self.cfg.out_dim

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        cfg, w = self.cfg, self.cfg.window
        if x.dim() != 4 or x.shape[-1] != self.in_channels:
            raise ValueError(f"expected NHWC with C={self.in_channels}, got {tuple(x.shape)}")
        x = self.patch_embed(x.permute(0, 3, 1, 2).contiguous().to(self.dtype))
        x = self.patch_ln(x.permute(0, 2, 3, 1))
        for stage, depth in enumerate(cfg.depths):
            if stage > 0:  # patch merging: 2x2 space-to-depth + linear reduction
                B, H, W, C = x.shape
                x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
                x = x.reshape(B, H // 2, W // 2, 4 * C)
                x = getattr(self, f"merge{stage}")(getattr(self, f"merge_ln{stage}")(x))
            if x.shape[1] % w or x.shape[2] % w:
                raise ValueError(
                    f"stage {stage} feature map {x.shape[1]}x{x.shape[2]} not divisible by "
                    f"window {w}; pick input sizes divisible by patch*window*2^stages")
            for i in range(depth):
                # no shift when the grid is a single window (Swin v1 / HF semantics)
                shift = 0 if i % 2 == 0 or min(x.shape[1], x.shape[2]) <= w else w // 2
                x = getattr(self, f"stage{stage}_block{i}")(x, shift)
        x = self.final_ln(x)
        return {"pooled": x.float().mean(dim=(1, 2)).to(x.dtype), "features": x}
