"""Operations and bytes from shapes: the model FLOPs of a step, the bound of a
fused MBConv call and of a flash-attention call, and the card's peaks.

Model FLOPs count each multiply-add of a convolution or matrix product as 2,
once: no recomputation (rematerialisation, a kernel's own recompute), no
padding (the fused route's tile padding), and no elementwise work, as MFU is
defined (Chowdhery et al., 2022). A training step counts 3x its forward (the
backward takes the input and the weight gradients, each the forward's cost).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .clip import image_width, is_vit
from .efficientnet import blocks, head_width, stem_width, variant_of

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def _out(size: int, stride: int) -> int:
    return -(-size // stride)


def effnet_forward_flops(variant: str, h: int, w: int, in_channels: int = 1) -> float:
    """FLOPs of one image through the tower (convolutions and SE products)."""
    h, w = _out(h, 2), _out(w, 2)
    total = 2.0 * h * w * stem_width(variant) * in_channels * 9
    for b in blocks(variant):
        e = b.expanded
        if b.expand != 1:
            total += 2.0 * h * w * b.cin * e
        h, w = _out(h, b.stride), _out(w, b.stride)
        total += 2.0 * h * w * e * b.kernel * b.kernel
        total += 2.0 * 2 * e * b.squeeze
        total += 2.0 * h * w * e * b.cout
    return total + 2.0 * h * w * blocks(variant)[-1].cout * head_width(variant)


def bert_forward_flops(t: Dict, seq: int) -> float:
    """FLOPs of one sequence of ``seq`` tokens through the text tower."""
    h, i = t["hidden_size"], t["intermediate_size"]
    per_layer = 2.0 * seq * (4 * h * h + 2 * h * i) + 4.0 * seq * seq * h
    return t["num_layers"] * per_layer


def vit_forward_flops(v: Dict, h: int, w: int, in_channels: int = 1) -> float:
    p, d, m = v["patch_size"], v["hidden_size"], v["mlp_dim"]
    n = (h // p) * (w // p)
    s = n + 1
    per_layer = 2.0 * s * (4 * d * d + 2 * d * m) + 4.0 * s * s * d
    return 2.0 * n * d * in_channels * p * p + v["num_layers"] * per_layer


def image_forward_flops(model: Dict, h: int, w: int) -> float:
    e = model["image_encoder"]
    if is_vit(model):
        return vit_forward_flops(e, h, w, e.get("in_channels", 1))
    return effnet_forward_flops(variant_of(e["name"]), h, w, e.get("in_channels", 1))


def clip_forward_flops(model: Dict, h: int, w: int, seq: int, images: int,
                       texts: int) -> float:
    """``images`` images and ``texts`` texts through towers and projections."""
    d = model["projection_head"]["proj_dim"]
    t = model["text_encoder"]
    return (images * (image_forward_flops(model, h, w) + 2.0 * image_width(model) * d)
            + texts * (bert_forward_flops(t, seq) + 2.0 * t["hidden_size"] * d))


def train_step_flops(model: Dict, h: int, w: int, seq: int, images: int, texts: int) -> float:
    return 3.0 * clip_forward_flops(model, h, w, seq, images, texts)


# -- fused MBConv ---------------------------------------------------------------------

def fused_blocks(variant: str, h: int, w: int, max_expanded: int = 256
                 ) -> List[Tuple[str, int, int, int, int, int, int]]:
    """(form, C, E, C2, squeeze, valid_h, valid_w) of the blocks the fused route
    takes: k=3, stride 1, expanded width <= ``max_expanded``."""
    h, w = _out(h, 2), _out(w, 2)
    out = []
    for b in blocks(variant):
        if b.kernel == 3 and b.stride == 1 and b.expanded <= max_expanded:
            out.append(("e6" if b.expand != 1 else "e1", b.cin, b.expanded, b.cout, b.squeeze,
                        h, w))
        h, w = _out(h, b.stride), _out(w, b.stride)
    return out


def mbconv_bound_s(form: str, n: int, c: int, e: int, c2: int, squeeze: int, vh: int,
                   vw: int, backward: bool, bf16: bool = True) -> float:
    """The least time of one fused call: the largest of its I/O bytes over the
    HBM rate, its channel products over the tensor cores' peak (bf16, or TF32
    for fp32 activations) and its depthwise stencil over the fp32 peak. Each
    product of the function counts once; bytes at the valid N x vh x vw."""
    p = n * vh * vw
    nparam = 9 * e + 2 * e + 2 * e * squeeze + squeeze + e + e * c2 + 2 * c2
    if form == "e6":
        nparam += c * e + 2 * e
    prod = 2.0 * p * e * c2 + (2.0 * p * c * e if form == "e6" else 0.0)
    stencil = 2.0 * 9 * p * e
    item = 2 if bf16 else 4
    if backward:
        nbytes = item * p * (2 * c + c2) + 8 * nparam
        prod, stencil = 2 * prod, 2 * stencil
    else:
        nbytes = item * p * (c + c2) + 4 * nparam
    return max(nbytes / HBM_BYTES_PER_S, prod / PEAK["bf16" if bf16 else "tf32"],
               stencil / PEAK["fp32"])


def mbconv_step_bound_s(variant: str, n: int, h: int, w: int, passes: int) -> float:
    """Bound of one training step's fused calls: forward and backward of every
    fused block, ``passes`` tower passes of ``n`` images."""
    return passes * sum(mbconv_bound_s(form, n, c, e, c2, sq, vh, vw, bwd)
                        for form, c, e, c2, sq, vh, vw in fused_blocks(variant, h, w)
                        for bwd in (False, True))


# -- flash attention ------------------------------------------------------------------

def flash_bound_s(b: int, heads: int, s: int, d: int, backward: bool) -> float:
    """The least time of one bf16 flash call on (b, heads, s, d): the forward
    takes 2 products of b*heads*s*s*d (QK^T, PV), the backward 4 (dP, dV, dQ,
    dK), whatever the kernel recomputes; bytes: q, k, v in and o, lse out, or
    q, k, v, o, dO, lse in and dq, dk, dv out."""
    elems, rows = b * heads * s * d, b * heads * s
    products = (4 if backward else 2) * 2.0 * b * heads * s * s * d
    nbytes = (8 if backward else 4) * 2 * elems + 4 * rows
    return max(nbytes / HBM_BYTES_PER_S, products / PEAK["bf16"])
