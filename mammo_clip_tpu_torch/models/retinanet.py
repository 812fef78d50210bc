"""RetinaNet detection head over the CLIP EfficientNet backbone (port of
``mammo_clip_tpu/models/retinanet.py``).

Capability parity with the reference detector
(reference: Detectors/retinanet/detector_model.py):

* FPN P3..P7 at 256 channels from the backbone taps C3, C4 and the conv head
  C5 (stride 32). The reference upsamples C3/C4 by 2 inside the FPN
  (detector_model.py:81-112), so the pyramid sits at strides 8/16/32/64/128,
  matching the anchor lattice (``ops/boxes.build_anchors``);
* shared 4-conv regression and classification subnets, 9 anchors per
  location (detector_model.py:115-239); the classification output is a
  sigmoid (in fp32) with the prior bias -log((1-0.01)/0.01)
  (detector_model.py:288-292);
* backbone taps: b5 blocks [26,37] + head, b2 [15,21] + head
  (detector_model.py:374-391), ``efficientnet.default_detector_taps``; the
  FPN takes the widths of the encoder that was built, so a flagship
  (``tpu_optimized``) checkpoint's config backs it too (b5: 128 and 512
  channels, where the reference layout has 176 and 512);
* the backbone always runs in eval mode: BatchNorm on its running statistics
  (the reference's frozen BN, detector_model.py:297-305), no stochastic
  depth, and so never the fused MBConv kernel. Its parameters still take
  gradients unless ``freeze_backbone``.

Submodules carry the Flax tree's names (``image_encoder``, ``fpn.p3_lateral``
... ``fpn.p7``, ``box_subnet.conv0`` ... ``.out``, ``class_subnet.*``), so
``convert/from_jax.py`` carries a JAX RetinaNet's variables across. Convs are
TF-SAME (stride-2 P6/P7 pad (0, 1) on an even input). The heads' NCHW output
is permuted to NHWC before it is flattened, so the anchor order is row-major
over (y, x, anchor) as in the JAX heads and the lattice.

Inference is shape-static: decode -> clip -> per-class static NMS
(``ops/nms.py``) for the whole batch at once.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.boxes import build_anchors, clip_boxes, decode_boxes
from ..ops.nms import batched_class_nms
from .clip import efficientnet_variant, image_encoder_state, load_image_encoder
from .efficientnet import Conv, default_detector_taps

PRIOR = 0.01


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 on NCHW (torch nn.Upsample(scale_factor=2, 'nearest'))."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class FPN(nn.Module):
    """P3..P7 pyramid from (C3, C4, C5), NCHW; the reference topology incl. the
    x2 upsampling of the C3/C4 taps (detector_model.py:81-112)."""

    def __init__(self, in_channels: Sequence[int], feature_size: int = 256):
        super().__init__()
        c3, c4, c5 = in_channels
        f = feature_size
        self.p5_lateral = Conv(c5, f, 1, bias=True)
        self.p5_out = Conv(f, f, 3, bias=True)
        self.p4_lateral = Conv(c4, f, 1, bias=True)
        self.p4_out = Conv(f, f, 3, bias=True)
        self.p3_lateral = Conv(c3, f, 1, bias=True)
        self.p3_out = Conv(f, f, 3, bias=True)
        self.p6 = Conv(c5, f, 3, stride=2, bias=True)
        self.p7 = Conv(f, f, 3, stride=2, bias=True)

    def forward(self, c3, c4, c5):
        p5 = self.p5_lateral(c5)  # stride 32
        p5_up = _upsample2(p5)  # stride 16
        p5_out = self.p5_out(p5)
        p4 = _upsample2(self.p4_lateral(c4)) + p5_up  # 32 -> 16
        p4_up = _upsample2(p4)  # stride 8
        p4_out = self.p4_out(p4)
        p3 = _upsample2(self.p3_lateral(c3)) + p4_up  # 16 -> 8
        p3_out = self.p3_out(p3)
        p6 = self.p6(c5)  # stride 64
        p7 = self.p7(F.relu(p6))  # stride 128
        return [p3_out, p4_out, p5_out, p6, p7]


class _Subnet(nn.Module):
    """4x (conv3x3 + relu) -> conv3x3 to ``num_anchors * per_anchor``; the
    output flattened to (B, H*W*num_anchors, per_anchor)."""

    def __init__(self, per_anchor: int, num_anchors: int = 9, feature_size: int = 256):
        super().__init__()
        self.per_anchor = per_anchor
        for i in range(4):
            self.add_module(f"conv{i}", Conv(feature_size, feature_size, 3, bias=True))
        self.out = Conv(feature_size, num_anchors * per_anchor, 3, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
        x = self.out(x).permute(0, 2, 3, 1)  # NHWC: anchors row-major over (y, x, a)
        return x.reshape(x.shape[0], -1, self.per_anchor)


class BoxSubnet(_Subnet):
    """Shared regression subnet: 4 deltas per anchor."""

    def __init__(self, num_anchors: int = 9, feature_size: int = 256):
        super().__init__(4, num_anchors, feature_size)


class ClassSubnet(_Subnet):
    """Shared classification subnet; emits fp32 sigmoid probabilities."""

    def __init__(self, num_classes: int, num_anchors: int = 9, feature_size: int = 256):
        super().__init__(num_classes, num_anchors, feature_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(super().forward(x).float())


class RetinaNet(nn.Module):
    """Backbone + FPN + shared subnets. ``forward(images NHWC)`` returns
    per-anchor ``class_probs`` (B, A, C) fp32 and ``box_deltas`` (B, A, 4) in
    the activation type; ``losses.focal.focal_loss`` trains it and ``detect``
    reads it. ``dtype`` is the activation type; parameters stay fp32."""

    def __init__(self, image_encoder_config: Mapping, num_classes: int,
                 freeze_backbone: bool = False, feature_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ie = dict(image_encoder_config)
        variant = efficientnet_variant(ie["name"])
        ie["feature_taps"] = default_detector_taps(variant)
        self.freeze_backbone = freeze_backbone
        self.image_encoder = load_image_encoder(ie, dtype=dtype)
        self.fpn = FPN(self.image_encoder.tap_channels(), feature_size)
        self.box_subnet = BoxSubnet(feature_size=feature_size)
        self.class_subnet = ClassSubnet(num_classes, feature_size=feature_size)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``train`` and ``generator`` are accepted for the step's calling
        convention; the backbone runs in eval mode either way."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_backbone):
            feats = self.image_encoder(images, train=False)
        nchw = lambda t: t.permute(0, 3, 1, 2)
        c3, c4 = (nchw(t) for t in feats["taps"])
        levels = self.fpn(c3, c4, nchw(feats["features"]))
        reg = torch.cat([self.box_subnet(p) for p in levels], dim=1)
        cls = torch.cat([self.class_subnet(p) for p in levels], dim=1)
        return {"class_probs": cls, "box_deltas": reg}


@torch.no_grad()
def init_heads(model: RetinaNet, generator: torch.Generator) -> None:
    """Initialise the FPN and the subnets as Flax does: lecun-normal kernels
    (``models.init_parameters``) and zero biases, but the classification
    output's prior bias -log((1-0.01)/0.01)."""
    from . import init_parameters  # the package imports this module

    for part in (model.fpn, model.box_subnet, model.class_subnet):
        init_parameters(part, generator)
    model.class_subnet.out.bias.fill_(-math.log((1.0 - PRIOR) / PRIOR))


def retinanet_from_clip_checkpoint(clip_config: Mapping,
                                   clip_state: Mapping[str, torch.Tensor], num_classes: int,
                                   freeze_backbone: bool = False,
                                   dtype: torch.dtype = torch.float32, device="cpu",
                                   generator: Optional[torch.Generator] = None) -> RetinaNet:
    """A RetinaNet on ``device`` over the image encoder of a CLIP model's state
    dict (``clip_state``, e.g. ``MammoCLIP.state_dict()``): the backbone's
    parameters and BatchNorm statistics are copied verbatim, the FPN and the
    subnets initialised by ``init_heads`` from ``generator`` (a CPU one seeded
    0 when None)."""
    model = RetinaNet(dict(clip_config["model"]["image_encoder"]), num_classes,
                      freeze_backbone=freeze_backbone, dtype=dtype)
    model.image_encoder.load_state_dict(image_encoder_state(clip_state))
    init_heads(model, generator or torch.Generator().manual_seed(0))
    return model.to(device)


def anchors_for(image_shape: Tuple[int, int]) -> np.ndarray:
    """Static per-shape anchor lattice (see ops/boxes.build_anchors)."""
    return build_anchors(image_shape)


def detect(outputs: Mapping[str, torch.Tensor], anchors: torch.Tensor,
           image_shape: Tuple[int, int], score_threshold: float = 0.05,
           iou_threshold: float = 0.5, top_k_per_class: int = 100, nms: str = "hard",
           soft_nms_sigma: float = 0.5) -> Dict[str, torch.Tensor]:
    """Decode + clip + per-class NMS for a whole batch -> dict of (B, C*K, ...)
    tensors: boxes, scores, classes, valid. Reference eval path:
    detector_model.py:331-354 (score > 0.05 filter, NMS at 0.5). ``nms='soft'``
    swaps in gaussian soft-NMS (overlapping boxes are score-decayed, not
    killed)."""
    boxes = clip_boxes(decode_boxes(anchors, outputs["box_deltas"].float()), image_shape)
    b, s, c, v = batched_class_nms(boxes, outputs["class_probs"].float(), iou_threshold,
                                   score_threshold, top_k_per_class, nms, soft_nms_sigma)
    return {"boxes": b, "scores": s, "classes": c, "valid": v}


def scaled_shape(base: Tuple[int, int], scale: float) -> Tuple[int, int]:
    """(H, W) times ``scale``, each snapped to the FPN stride (32), at least 32."""
    return tuple(max(32, int(round(n * scale / 32)) * 32) for n in base)


def resize_bilinear(images: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize with half-pixel centers, antialiased when it
    shrinks: ``jax.image.resize(..., 'bilinear')``'s semantics."""
    x = F.interpolate(images.permute(0, 3, 1, 2), size=size, mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def detect_multiscale(apply_fn: Callable[[torch.Tensor], Mapping[str, torch.Tensor]],
                      images: torch.Tensor, scales: Sequence[float],
                      score_threshold: float = 0.05, iou_threshold: float = 0.5,
                      top_k_per_class: int = 100, nms: str = "hard",
                      soft_nms_sigma: float = 0.5) -> Dict[str, torch.Tensor]:
    """Multi-scale inference: run ``apply_fn`` (images NHWC -> the model's
    outputs) at each scale (the image resized, its sides snapped to the FPN
    stride), map every candidate box back to the base frame, and run ONE
    per-class NMS over the merged pool, so a detection found at any scale can
    suppress duplicates from the others. Returns the same dict as ``detect``."""
    base = (images.shape[1], images.shape[2])
    all_boxes, all_probs = [], []
    for s in scales:
        sh, sw = scaled_shape(base, s)
        imgs = images if (sh, sw) == base else resize_bilinear(images, (sh, sw))
        out = apply_fn(imgs)
        anchors = torch.from_numpy(build_anchors((sh, sw))).to(images.device)
        boxes = clip_boxes(decode_boxes(anchors, out["box_deltas"].float()), (sh, sw))
        rescale = torch.tensor([base[1] / sw, base[0] / sh, base[1] / sw, base[0] / sh],
                               dtype=boxes.dtype, device=boxes.device)
        all_boxes.append(boxes * rescale)
        all_probs.append(out["class_probs"].float())
    b, s_, c, v = batched_class_nms(torch.cat(all_boxes, 1), torch.cat(all_probs, 1),
                                    iou_threshold, score_threshold, top_k_per_class, nms,
                                    soft_nms_sigma)
    return {"boxes": b, "scores": s_, "classes": c, "valid": v}
