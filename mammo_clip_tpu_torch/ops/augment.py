"""On-device augmentation + normalization (port of ``mammo_clip_tpu/ops/augment.py``).

Per-image min-max + mean/std normalization, then (train only) flips and an
affine transform composed into ONE per-sample 2x3 inverse matrix, plus an
elastic displacement synthesized at 1/8 resolution (uniform noise -> separable
Gaussian blur at sigma/8 -> bilinear upsample), all resampled by a SINGLE
bilinear gather per image with a constant (background) border. Random draws
come from an explicit ``torch.Generator``, so they differ from the JAX
package's; the distributions are the same. The JAX package's two-pass
gather-free warp (``ops/warp.py``) is a TPU reformulation of ``warp_bilinear``
and is not ported. ``augment_batch_with_boxes`` warps the same way and maps
detection boxes through the same transform.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    hflip_p: float = 0.5
    vflip_p: float = 0.5
    affine_p: float = 0.5
    rotate_deg: float = 20.0
    translate_frac: float = 0.1
    scale_min: float = 0.8
    scale_max: float = 1.2
    shear_deg: float = 20.0
    elastic_p: float = 0.5
    elastic_alpha: float = 10.0
    elastic_sigma: float = 15.0
    elastic_downsample: int = 8
    elastic_fullres_amp: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "AugmentConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def minmax_standardize(images: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """Per-image min-max to [0,1] then (x - mean)/std; returns float32."""
    x = images.float()
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    x = (x - lo) / torch.clamp(hi - lo, min=1e-8)
    return (x - mean) / std


def _uniform(generator, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)


def sample_affine_matrices(generator: Optional[torch.Generator], batch: int, height: int,
                           width: int, cfg: AugmentConfig, device="cpu") -> torch.Tensor:
    """Per-sample 2x3 INVERSE maps (dst pixel -> src pixel), composing flips +
    affine about the image center, acting on homogeneous (x, y, 1). (B, 2, 3) fp32."""
    u = lambda *shape: torch.rand(shape, generator=generator, device=device)
    hflip = torch.where(u(batch) < cfg.hflip_p, -1.0, 1.0)
    vflip = torch.where(u(batch) < cfg.vflip_p, -1.0, 1.0)
    apply = (u(batch) < cfg.affine_p).float()
    deg = math.pi / 180.0
    theta = _uniform(generator, (batch,), -cfg.rotate_deg, cfg.rotate_deg, device) * deg * apply
    shear = _uniform(generator, (batch,), -cfg.shear_deg, cfg.shear_deg, device) * deg * apply
    scale = 1.0 + (_uniform(generator, (batch,), cfg.scale_min, cfg.scale_max, device)
                   - 1.0) * apply
    trans = _uniform(generator, (batch, 2), -cfg.translate_frac, cfg.translate_frac, device)
    trans = trans * apply[:, None] * torch.tensor([width, height], device=device,
                                                  dtype=torch.float32)
    # forward linear part in skimage's AffineTransform parametrization (shear is
    # an angle added to the rotation of the y basis column)
    sx, sy = scale * hflip, scale * vflip
    f00, f01 = sx * torch.cos(theta), -sy * torch.sin(theta + shear)
    f10, f11 = sx * torch.sin(theta), sy * torch.cos(theta + shear)
    det = f00 * f11 - f01 * f10
    inv00, inv01 = f11 / det, -f01 / det
    inv10, inv11 = -f10 / det, f00 / det
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    tx = -(inv00 * (cx + trans[:, 0]) + inv01 * (cy + trans[:, 1])) + cx
    ty = -(inv10 * (cx + trans[:, 0]) + inv11 * (cy + trans[:, 1])) + cy
    row0 = torch.stack([inv00, inv01, tx], dim=-1)
    row1 = torch.stack([inv10, inv11, ty], dim=-1)
    return torch.stack([row0, row1], dim=1)


def _gaussian_kernel(sigma: float, radius: int, device="cpu") -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    return k / k.sum()


def sample_elastic_lowres(generator: Optional[torch.Generator], batch: int, height: int,
                          width: int, cfg: AugmentConfig, device="cpu") -> torch.Tensor:
    """(B, hh, ww, 2) low-res displacement field IN PIXELS (alpha and the
    per-sample p-gate applied): blurred uniform noise at 1/elastic_downsample."""
    d = cfg.elastic_downsample
    hh, ww = max(height // d, 2), max(width // d, 2)
    noise = _uniform(generator, (batch, hh, ww, 2), -1.0, 1.0, device)
    sigma_low = cfg.elastic_sigma / d
    radius = max(int(3 * sigma_low), 1)
    kern = _gaussian_kernel(sigma_low, radius, device)
    amp = cfg.elastic_alpha
    if cfg.elastic_fullres_amp:
        kf = _gaussian_kernel(cfg.elastic_sigma, max(int(3 * cfg.elastic_sigma), 1))
        amp = amp * float((kf * kf).sum() / (kern.cpu() * kern.cpu()).sum())
    t = noise.permute(0, 3, 1, 2).reshape(batch * 2, 1, hh, ww)
    t = F.conv2d(t, kern.view(1, 1, -1, 1), padding=(radius, 0))
    t = F.conv2d(t, kern.view(1, 1, 1, -1), padding=(0, radius))
    blurred = t.reshape(batch, 2, hh, ww).permute(0, 2, 3, 1)
    gate = (torch.rand((batch, 1, 1, 1), generator=generator, device=device)
            < cfg.elastic_p).float()
    return blurred * amp * gate


def upsample_displacement(lowres: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, hh, ww, 2) -> (B, H, W, 2) bilinear with half-pixel centers (the
    semantics of jax.image.resize 'bilinear' when upsampling)."""
    t = F.interpolate(lowres.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                      align_corners=False)
    return t.permute(0, 2, 3, 1)


def sample_elastic_displacement(generator, batch: int, height: int, width: int,
                                cfg: AugmentConfig, device="cpu") -> torch.Tensor:
    """(B, H, W, 2) displacement in pixels: the low-res field bilinearly upsampled."""
    lowres = sample_elastic_lowres(generator, batch, height, width, cfg, device)
    return upsample_displacement(lowres, height, width)


def warp_bilinear(images: torch.Tensor, src_xy: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample ``images`` (B,H,W,C) at ``src_xy`` (B,H,W,2) pixel coords
    (x, y order). Out-of-range taps read 0 (constant border)."""
    B, H, W, C = images.shape
    x, y = src_xy[..., 0], src_xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    flat = images.reshape(B, H * W, C)

    def tap(yy, xx):
        valid = ((xx >= 0) & (xx < W) & (yy >= 0) & (yy < H))[..., None]
        idx = (yy.clamp(0, H - 1).long() * W + xx.clamp(0, W - 1).long()).reshape(B, H * W, 1)
        vals = flat.gather(1, idx.expand(B, H * W, C)).reshape(B, H, W, C)
        return vals * valid

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def affine_grid(matrices: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Apply per-sample 2x3 maps to the dst pixel grid -> (B,H,W,2) src coords (x,y)."""
    dev = matrices.device
    gy, gx = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev),
                            indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (H, W, 3)
    return torch.einsum("bij,hwj->bhwi", matrices, grid)


def apply_warp(x: torch.Tensor, mats: torch.Tensor, disp: Optional[torch.Tensor],
               mean: float, std: float) -> torch.Tensor:
    """Warp standardized images with dst->src maps and an optional displacement;
    the border reads the standardized value of black."""
    B, H, W, _ = x.shape
    coords = affine_grid(mats, H, W)
    if disp is not None:
        coords = coords + disp
    background = (0.0 - mean) / std
    return warp_bilinear(x - background, coords) + background


def augment_batch(images: torch.Tensor, generator: Optional[torch.Generator],
                  cfg: AugmentConfig, mean: float, std: float, train: bool = True,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """normalize -> (train only) flip+affine+elastic in one warp."""
    out_dtype = out_dtype or torch.float32
    x = minmax_standardize(images, mean, std)
    if not train or max(cfg.hflip_p, cfg.vflip_p, cfg.affine_p, cfg.elastic_p) == 0.0:
        return x.to(out_dtype)
    B, H, W, _ = x.shape
    mats = sample_affine_matrices(generator, B, H, W, cfg, x.device)
    disp = (sample_elastic_displacement(generator, B, H, W, cfg, x.device)
            if cfg.elastic_p > 0 else None)
    return apply_warp(x, mats, disp, mean, std).to(out_dtype)


def augment_two_views(images, views, generator, cfg: AugmentConfig, mean: float, std: float,
                      train: bool = True, out_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augment both CLIP views in one call; each sample gets its own draw."""
    B = images.shape[0]
    out = augment_batch(torch.cat([images, views], 0), generator, cfg, mean, std,
                        train=train, out_dtype=out_dtype)
    return out[:B], out[B:]


def augment_batch_with_boxes(images: torch.Tensor, boxes: torch.Tensor,
                             generator: Optional[torch.Generator], cfg: AugmentConfig,
                             mean: float, std: float, train: bool = True,
                             matrices: Optional[torch.Tensor] = None,
                             lowres: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Box-aware augmentation for detection (reference: imgaug's box-tracking
    Sequential incl. ElasticTransformation, Datasets/dataset_utils.py:54-73):
    the images are warped with the sampled flips/affine/elastic field, and the
    box corners (``boxes`` (B, N, 5) xyxy + class, -1-padded rows) are mapped
    through the SAME composed transform; padded rows stay -1.

    ``matrices`` (B, 2, 3) and ``lowres`` (B, hh, ww, 2) replace the draws when
    given (the elastic field is drawn only when ``cfg.elastic_p > 0``).

    Elastic corner tracking: the warp reads out[d] = in[A·d + t + disp(d)], so
    a source point s lands at the d solving s = A·d + t + disp(d). To first
    order in the smooth, small field: d ~= d_aff - A^{-1}·disp(d_aff) with
    d_aff = A^{-1}(s - t); the correction evaluates the low-res field at the
    affine-mapped corner."""
    x = minmax_standardize(images, mean, std)
    if not train:
        return x, boxes
    B, H, W, _ = x.shape
    mats = (matrices if matrices is not None
            else sample_affine_matrices(generator, B, H, W, cfg, x.device))
    if lowres is None and cfg.elastic_p > 0:
        lowres = sample_elastic_lowres(generator, B, H, W, cfg, x.device)
    disp = upsample_displacement(lowres, H, W) if lowres is not None else None
    warped = apply_warp(x, mats, disp, mean, std)

    boxes = boxes.float()
    valid = boxes[..., 4:5] >= 0
    corners = torch.stack([boxes[..., [0, 1]], boxes[..., [2, 1]], boxes[..., [0, 3]],
                           boxes[..., [2, 3]]], dim=2)  # (B, N, 4, 2)
    N = corners.shape[1]
    mapped = transform_points(mats, corners.reshape(B, N * 4, 2))
    if lowres is not None:
        d_at = elastic_at_points(lowres, mapped, H, W)
        mapped = mapped - torch.einsum("bij,bnj->bni", _inverse_2x2(mats), d_at)
    mapped = mapped.reshape(B, N, 4, 2)
    lo, hi = mapped.amin(dim=2), mapped.amax(dim=2)
    new_boxes = torch.cat([lo[..., 0:1].clamp(0, W - 1), lo[..., 1:2].clamp(0, H - 1),
                           hi[..., 0:1].clamp(0, W - 1), hi[..., 1:2].clamp(0, H - 1),
                           boxes[..., 4:5]], dim=-1)
    return warped, torch.where(valid, new_boxes, torch.full_like(new_boxes, -1.0))


def elastic_at_points(lowres: torch.Tensor, points_xy: torch.Tensor, height: int,
                      width: int) -> torch.Tensor:
    """The low-res displacement field (B, hh, ww, 2) bilinearly interpolated at
    full-res pixel coords (B, P, 2) (x, y) -> (B, P, 2), with the half-pixel
    centers of ``upsample_displacement``: the value the image warp used there."""
    B, hh, ww, _ = lowres.shape
    u = ((points_xy[..., 0] + 0.5) * (ww / width) - 0.5).clamp(0.0, ww - 1.0)
    v = ((points_xy[..., 1] + 0.5) * (hh / height) - 0.5).clamp(0.0, hh - 1.0)
    u0 = torch.floor(u).clamp(0, ww - 2) if ww > 1 else torch.zeros_like(u)
    v0 = torch.floor(v).clamp(0, hh - 2) if hh > 1 else torch.zeros_like(v)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    flat = lowres.reshape(B, hh * ww, 2)

    def tap(vi, ui):
        idx = (vi * ww + ui).long()[..., None].expand(*vi.shape, 2)
        return torch.gather(flat, 1, idx)

    top = tap(v0, u0) * (1 - fu) + tap(v0, u0 + 1) * fu
    bot = tap(v0 + 1, u0) * (1 - fu) + tap(v0 + 1, u0 + 1) * fu
    return top * (1 - fv) + bot * fv


def _inverse_2x2(matrices: torch.Tensor) -> torch.Tensor:
    """(B, 2, 2) inverse of the linear part of (B, 2, 3) dst->src maps."""
    a = matrices[:, :, :2]
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    return torch.stack([torch.stack([a[:, 1, 1] / det, -a[:, 0, 1] / det], dim=-1),
                        torch.stack([-a[:, 1, 0] / det, a[:, 0, 0] / det], dim=-1)], dim=1)


def transform_points(matrices: torch.Tensor, points_xy: torch.Tensor) -> torch.Tensor:
    """Map points (B, N, 2) with the FORWARD transform, given the inverse
    (dst->src) maps (B, 2, 3) of ``sample_affine_matrices``:
    src = A dst + t  =>  dst = A^-1 (src - t)."""
    rel = points_xy - matrices[:, :, 2][:, None, :]
    return torch.einsum("bij,bnj->bni", _inverse_2x2(matrices), rel)
