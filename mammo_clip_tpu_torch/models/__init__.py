"""Model factory (port of ``mammo_clip_tpu/models/__init__.py::build_model``)."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .bert import BertConfig, BertEncoder, pool_text
from .clip import MammoCLIP
from .efficientnet import EfficientNet, default_detector_taps, head_filters, scaled_block_args
from .retinanet import RetinaNet, anchors_for, detect, detect_multiscale, init_heads

__all__ = ["BertConfig", "BertEncoder", "EfficientNet", "MammoCLIP", "RetinaNet", "anchors_for",
           "build_model", "default_detector_taps", "detect", "detect_multiscale",
           "head_filters", "init_heads", "init_parameters", "pool_text", "scaled_block_args"]


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
    embeddings, ones for norm scales, zeros for biases. ``logit_scale`` keeps
    its log(1/temperature) value."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            if p.dim() == 4:  # conv OIHW: fan-in is I*kh*kw
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            elif name.endswith("attention.output.kernel"):  # (heads, head_dim, H)
                fan_in = p.shape[0] * p.shape[1]
            else:  # Dense (in, *out)
                fan_in = p.shape[0]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            p.copy_(_truncated_normal(p.shape, generator, p.device) * std)
        elif leaf == "embedding":
            t = torch.randn(p.shape, generator=generator, device=p.device)
            p.copy_(t / math.sqrt(p.shape[1]))
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf == "bias":
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
