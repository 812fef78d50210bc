"""Mammo-CLIP's training augmentation in plain PyTorch.

Per image: min-max to [0, 1], then (x - mean) / std; horizontal and vertical
flips, an affine map (rotation, shear, scale, translation) and an elastic
displacement (uniform noise at 1/8 resolution, separably blurred at sigma/8,
upsampled bilinearly), resampled in one bilinear gather with the background
(black) outside. The random draws come from the caller's generator in this
order: hflip, vflip, affine gate, rotation, shear, scale, translation (each
one value a sample), then the elastic noise and its gate.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def standardize(images: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    x = images.float()
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    return ((x - lo) / torch.clamp(hi - lo, min=1e-8) - mean) / std


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def inverse_maps(g, n: int, h: int, w: int, a: Dict, device) -> torch.Tensor:
    """(n, 2, 3) maps from an output pixel (x, y, 1) to its source pixel."""
    u = lambda *shape: torch.rand(shape, generator=g, device=device)
    hflip = torch.where(u(n) < a["hflip_p"], -1.0, 1.0)
    vflip = torch.where(u(n) < a["vflip_p"], -1.0, 1.0)
    on = (u(n) < a["affine_p"]).float()
    deg = math.pi / 180.0
    theta = _uniform(g, (n,), -a["rotate_deg"], a["rotate_deg"], device) * deg * on
    shear = _uniform(g, (n,), -a["shear_deg"], a["shear_deg"], device) * deg * on
    scale = 1.0 + (_uniform(g, (n,), a["scale_min"], a["scale_max"], device) - 1.0) * on
    shift = _uniform(g, (n, 2), -a["translate_frac"], a["translate_frac"], device)
    shift = shift * on[:, None] * torch.tensor([w, h], device=device, dtype=torch.float32)
    sx, sy = scale * hflip, scale * vflip
    f00, f01 = sx * torch.cos(theta), -sy * torch.sin(theta + shear)
    f10, f11 = sx * torch.sin(theta), sy * torch.cos(theta + shear)
    det = f00 * f11 - f01 * f10
    i00, i01, i10, i11 = f11 / det, -f01 / det, -f10 / det, f00 / det
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    tx = -(i00 * (cx + shift[:, 0]) + i01 * (cy + shift[:, 1])) + cx
    ty = -(i10 * (cx + shift[:, 0]) + i11 * (cy + shift[:, 1])) + cy
    return torch.stack([torch.stack([i00, i01, tx], -1), torch.stack([i10, i11, ty], -1)], 1)


def _gauss(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    return k / k.sum()


def displacement(g, n: int, h: int, w: int, a: Dict, device) -> torch.Tensor:
    """(n, h, w, 2) elastic displacement in pixels."""
    down = a.get("elastic_downsample", 8)
    hh, ww = max(h // down, 2), max(w // down, 2)
    noise = _uniform(g, (n, hh, ww, 2), -1.0, 1.0, device)
    sigma = a["elastic_sigma"] / down
    radius = max(int(3 * sigma), 1)
    k = _gauss(sigma, radius, device)
    t = noise.permute(0, 3, 1, 2).reshape(n * 2, 1, hh, ww)
    t = F.conv2d(t, k.view(1, 1, -1, 1), padding=(radius, 0))
    t = F.conv2d(t, k.view(1, 1, 1, -1), padding=(0, radius))
    field = t.reshape(n, 2, hh, ww)
    gate = (torch.rand((n, 1, 1, 1), generator=g, device=device) < a["elastic_p"]).float()
    low = field.permute(0, 2, 3, 1) * a["elastic_alpha"] * gate
    up = F.interpolate(low.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                       align_corners=False)
    return up.permute(0, 2, 3, 1)


def bilinear(images: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample (n, h, w, c) at (n, h, w, 2) pixel coordinates; 0 outside."""
    n, h, w, c = images.shape
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    flat = images.reshape(n, h * w, c)

    def tap(yy, xx):
        inside = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h))[..., None]
        idx = (yy.clamp(0, h - 1).long() * w + xx.clamp(0, w - 1).long()).reshape(n, h * w, 1)
        return flat.gather(1, idx.expand(n, h * w, c)).reshape(n, h, w, c) * inside

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bottom = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bottom * fy


def augment(images: torch.Tensor, g, a: Dict, mean: float, std: float) -> torch.Tensor:
    """(n, h, w, c) uint8 -> (n, h, w, c) float32, augmented for training."""
    x = standardize(images, mean, std)
    n, h, w, _ = x.shape
    maps = inverse_maps(g, n, h, w, a, x.device)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x.device),
                            torch.arange(w, dtype=torch.float32, device=x.device),
                            indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    xy = torch.einsum("bij,hwj->bhwi", maps, grid)
    if a["elastic_p"] > 0:
        xy = xy + displacement(g, n, h, w, a, x.device)
    black = (0.0 - mean) / std
    return bilinear(x - black, xy) + black
