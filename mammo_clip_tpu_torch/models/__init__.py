"""Model factory (port of ``mammo_clip_tpu/models/__init__.py::build_model``)."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .bert import BertConfig, BertEncoder, Dense, pool_text
from .clip import MammoCLIP, load_image_encoder
from .efficientnet import EfficientNet, default_detector_taps, head_filters, scaled_block_args
from .resnet import Bottleneck, ResNet
from .retinanet import RetinaNet, anchors_for, detect, detect_multiscale, init_heads
from .swin import SwinBlock, SwinConfig, SwinTransformer
from .vit import ViT, ViTBlock, ViTConfig

__all__ = ["BertConfig", "BertEncoder", "Bottleneck", "EfficientNet", "MammoCLIP", "ResNet",
           "RetinaNet", "SwinBlock", "SwinConfig", "SwinTransformer", "ViT", "ViTBlock",
           "ViTConfig", "anchors_for", "build_model", "default_detector_taps", "detect",
           "detect_multiscale", "head_filters", "init_heads", "init_parameters",
           "load_image_encoder", "pool_text", "scaled_block_args"]


def _truncated_normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] (``jax.random.truncated_normal``'s
    bounds), by the inverse CDF of a uniform draw."""
    lo = 0.5 * math.erfc(2.0 / math.sqrt(2.0))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(shape, generator=generator, device=device)
    return torch.erfinv(2.0 * u - 1.0).clamp(-2.0, 2.0) * math.sqrt(2.0)


@torch.no_grad()
def init_parameters(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter from ``generator`` with the Flax defaults' families:
    lecun-normal (truncated, fan-in) kernels, normal(1/sqrt(features))
    embeddings, ones for norm scales, zeros for biases; the ViT's
    ``cls_token`` zeros and ``pos_embedding`` normal(0.02), Swin's
    ``rel_pos_table`` truncated normal(0.02). A Dense kernel's fan-in is the
    product of the axes it contracts (H * head_dim for an attention output, as
    Flax's DenseGeneral counts it), a conv kernel's I*kh*kw. ``logit_scale``
    keeps its log(1/temperature) value."""
    dense_fan_in = {f"{n}.kernel" if n else "kernel": math.prod(m.in_shape)
                    for n, m in model.named_modules() if isinstance(m, Dense)}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            if name in dense_fan_in:
                fan_in = dense_fan_in[name]
            elif p.dim() == 4:  # conv OIHW: fan-in is I*kh*kw
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            else:
                fan_in = p.shape[0]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            p.copy_(_truncated_normal(p.shape, generator, p.device) * std)
        elif leaf == "embedding":
            t = torch.randn(p.shape, generator=generator, device=p.device)
            p.copy_(t / math.sqrt(p.shape[1]))
        elif leaf == "pos_embedding":
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * 0.02)
        elif leaf == "rel_pos_table":
            p.copy_(_truncated_normal(p.shape, generator, p.device) * 0.02)
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "cls_token"):
            p.zero_()


def build_model(model_config: Dict, dtype: torch.dtype = torch.float32,
                device="cuda", generator: Optional[torch.Generator] = None) -> MammoCLIP:
    """name -> model dispatch. Parameters are fp32 on ``device``, drawn from
    ``generator`` (a fresh one seeded 0 when None); ``dtype`` is the activation type."""
    name = model_config.get("name", "clip_custom")
    if name != "clip_custom":
        raise KeyError(f"unknown model name: {name}")
    model = MammoCLIP(dict(model_config), dtype=dtype).to(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init_parameters(model, generator)
    return model
