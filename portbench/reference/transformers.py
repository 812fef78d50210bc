"""BERT (the text tower) and ViT (an image tower) in plain PyTorch, over a dict
of named weights.

BERT-base as Devlin et al. (2019) and HuggingFace's ``BertModel`` define it
(BioClinicalBERT's widths): word + position + token-type embeddings,
LayerNorm (eps 1e-12), dropout 0.1 on the embeddings, the attention
probabilities, the attention output and the FFN output, post-norm layers,
exact GELU, and the last hidden state pooled at the last unmasked token
(Mammo-CLIP's ``eos`` pooling). Dropout masks are uniform draws from the
caller's generator compared with the keep rate, made in that order.

ViT-B/16 as Dosovitskiy et al. (2021) and HuggingFace's ``ViTModel`` define
it: a 16x16 patch conv with bias, a CLS token, position embeddings learned
on a 14x14 grid and resized bilinearly (half-pixel centres, antialiased only
when the grid shrinks) to the input's grid, pre-norm layers (LayerNorm eps
1e-12), exact GELU, a final LayerNorm, the CLS token pooled. Departure, for
memory only: each image runs alone and each layer under
``torch.utils.checkpoint`` in train mode (the tower has no dropout and
nothing crosses images).

Names follow the measured program's state dict (``text_encoder.layer_3.
attention.query.kernel`` is (hidden, heads, head_dim)).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .precision import Precision

BERT_LN_EPS = 1e-12
VIT_LN_EPS = 1e-12


def bert_param_shapes(t: Dict, prefix: str = "text_encoder.") -> Dict[str, tuple]:
    h, n, i = t["hidden_size"], t["num_heads"], t["intermediate_size"]
    d = h // n
    out = {f"{prefix}word_embeddings.embedding": (t["vocab_size"], h),
           f"{prefix}position_embeddings.embedding": (t["max_position_embeddings"], h),
           f"{prefix}token_type_embeddings.embedding": (2, h),
           f"{prefix}embeddings_ln.scale": (h,), f"{prefix}embeddings_ln.bias": (h,)}
    for j in range(t["num_layers"]):
        p = f"{prefix}layer_{j}."
        for qkv in ("query", "key", "value"):
            out[f"{p}attention.{qkv}.kernel"] = (h, n, d)
            out[f"{p}attention.{qkv}.bias"] = (n, d)
        out[f"{p}attention.output.kernel"] = (n, d, h)
        out[f"{p}attention.output.bias"] = (h,)
        out[f"{p}attention_ln.scale"] = (h,)
        out[f"{p}attention_ln.bias"] = (h,)
        out[f"{p}intermediate.kernel"] = (h, i)
        out[f"{p}intermediate.bias"] = (i,)
        out[f"{p}ffn_output.kernel"] = (i, h)
        out[f"{p}ffn_output.bias"] = (h,)
        out[f"{p}ffn_ln.scale"] = (h,)
        out[f"{p}ffn_ln.bias"] = (h,)
    return out


def vit_param_shapes(v: Dict, in_channels: int = 1, prefix: str = "image_encoder."
                     ) -> Dict[str, tuple]:
    h, n, m, p, g = (v["hidden_size"], v["num_heads"], v["mlp_dim"], v["patch_size"],
                     v["base_grid"])
    d = h // n
    out = {f"{prefix}patch_embed.kernel": (h, in_channels, p, p),
           f"{prefix}patch_embed.bias": (h,),
           f"{prefix}cls_token": (1, 1, h), f"{prefix}pos_embedding": (1, g * g + 1, h)}
    for j in range(v["num_layers"]):
        b = f"{prefix}block_{j}."
        out[f"{b}ln1.scale"] = (h,)
        out[f"{b}ln1.bias"] = (h,)
        for qkv in ("query", "key", "value"):
            out[f"{b}attn.{qkv}.kernel"] = (h, n, d)
            out[f"{b}attn.{qkv}.bias"] = (n, d)
        out[f"{b}attn.out.kernel"] = (n, d, h)
        out[f"{b}attn.out.bias"] = (h,)
        out[f"{b}ln2.scale"] = (h,)
        out[f"{b}ln2.bias"] = (h,)
        out[f"{b}fc1.kernel"] = (h, m)
        out[f"{b}fc1.bias"] = (m,)
        out[f"{b}fc2.kernel"] = (m, h)
        out[f"{b}fc2.bias"] = (h,)
    out[f"{prefix}ln_final.scale"] = (h,)
    out[f"{prefix}ln_final.bias"] = (h,)
    return out


def dense(x, kernel, bias, prec: Precision, n_in: int = 1):
    """x @ kernel + bias over x's last ``n_in`` dims; kernel (*in, *out)."""
    k = kernel.reshape(math.prod(kernel.shape[:n_in]), -1)
    lead = x.shape[:x.dim() - n_in]
    y = prec.operand(x.reshape(-1, k.shape[0])) @ prec.operand(k)
    y = prec.result(y)
    if bias is not None:
        y = y + bias.reshape(-1)
    return y.reshape(*lead, *kernel.shape[n_in:])


def layer_norm(x, w, name, eps):
    return F.layer_norm(x, (x.shape[-1],), w[name + ".scale"], w[name + ".bias"], eps)


def dropout(x, rate: float, generator):
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def bert(w: Dict[str, torch.Tensor], t: Dict, ids: torch.Tensor, mask: torch.Tensor,
         prec: Precision, train: bool, generator: Optional[torch.Generator] = None,
         prefix: str = "text_encoder.") -> torch.Tensor:
    """(B, S) ids and mask -> (B, hidden) pooled at the last unmasked token."""
    rate = t.get("dropout_rate", 0.1) if train else 0.0
    h, n = t["hidden_size"], t["num_heads"]
    d = h // n
    B, S = ids.shape
    pos = torch.arange(S, device=ids.device)
    x = (w[prefix + "word_embeddings.embedding"][ids]
         + w[prefix + "position_embeddings.embedding"][pos][None]
         + w[prefix + "token_type_embeddings.embedding"][0][None, None])
    x = dropout(layer_norm(x, w, prefix + "embeddings_ln", BERT_LN_EPS), rate, generator)
    keep = mask.bool()[:, None, None, :]
    for j in range(t["num_layers"]):
        lp = f"{prefix}layer_{j}."
        p = lp + "attention."
        q, k, v = (dense(x, w[p + m + ".kernel"], w[p + m + ".bias"], prec).transpose(1, 2)
                   for m in ("query", "key", "value"))
        s = prec.result(prec.operand(q * d ** -0.5) @ prec.operand(k.transpose(-1, -2)))
        s = s.masked_fill(~keep, torch.finfo(torch.float32).min)
        probs = dropout(torch.softmax(s, dim=-1), rate, generator)
        ctx = prec.result(prec.operand(probs) @ prec.operand(v)).transpose(1, 2)
        a = dense(ctx, w[p + "output.kernel"], w[p + "output.bias"], prec, n_in=2)
        x = layer_norm(x + dropout(a, rate, generator), w, lp + "attention_ln", BERT_LN_EPS)
        f = F.gelu(dense(x, w[lp + "intermediate.kernel"], w[lp + "intermediate.bias"], prec))
        f = dense(f, w[lp + "ffn_output.kernel"], w[lp + "ffn_output.bias"], prec)
        x = layer_norm(x + dropout(f, rate, generator), w, lp + "ffn_ln", BERT_LN_EPS)
    last = mask.sum(dim=-1).long() - 1
    return x[torch.arange(B, device=x.device), last]


def resize_grid(grid: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(1, g, g, D) -> (1, gh, gw, D), bilinear with half-pixel centres."""
    g = grid.shape[1]
    if (gh, gw) == (g, g):
        return grid
    out = F.interpolate(grid.permute(0, 3, 1, 2), size=(gh, gw), mode="bilinear",
                        align_corners=False, antialias=gh < g or gw < g)
    return out.permute(0, 2, 3, 1)


class ViTTower:
    def __init__(self, w: Dict[str, torch.Tensor], v: Dict, prec: Precision,
                 prefix: str = "image_encoder."):
        self.w, self.v, self.prec, self.prefix = w, v, prec, prefix

    def layer(self, j: int, x: torch.Tensor) -> torch.Tensor:
        w, prec, b = self.w, self.prec, f"{self.prefix}block_{j}."
        n = self.v["num_heads"]
        d = self.v["hidden_size"] // n
        y = layer_norm(x, w, b + "ln1", VIT_LN_EPS)
        q, k, vv = (dense(y, w[f"{b}attn.{m}.kernel"], w[f"{b}attn.{m}.bias"], prec)
                    .transpose(1, 2) for m in ("query", "key", "value"))
        s = prec.result(prec.operand(q / math.sqrt(d)) @ prec.operand(k.transpose(-1, -2)))
        ctx = prec.result(prec.operand(torch.softmax(s, dim=-1)) @ prec.operand(vv))
        x = x + dense(ctx.transpose(1, 2), w[b + "attn.out.kernel"], w[b + "attn.out.bias"],
                      prec, n_in=2)
        y = layer_norm(x, w, b + "ln2", VIT_LN_EPS)
        y = F.gelu(dense(y, w[b + "fc1.kernel"], w[b + "fc1.bias"], prec))
        return x + dense(y, w[b + "fc2.kernel"], w[b + "fc2.bias"], prec)

    def one(self, image: torch.Tensor, train: bool) -> torch.Tensor:
        """(1, H, W, C) -> (1, hidden): the CLS token after the final LayerNorm."""
        w, v, p = self.w, self.v, self.prefix
        ps, h, g = v["patch_size"], v["hidden_size"], v["base_grid"]
        x = image.permute(0, 3, 1, 2).float()
        kern = self.prec.operand(w[p + "patch_embed.kernel"])
        patches = self.prec.result(F.conv2d(self.prec.operand(x), kern, None, ps))
        patches = patches + w[p + "patch_embed.bias"].view(1, -1, 1, 1)
        gh, gw = patches.shape[2:]
        tokens = patches.flatten(2).transpose(1, 2)
        pos = w[p + "pos_embedding"]
        grid = resize_grid(pos[:, 1:].reshape(1, g, g, h), gh, gw).reshape(1, gh * gw, h)
        cls = w[p + "cls_token"] + pos[:, :1]
        x = torch.cat([cls, tokens + grid], dim=1)
        for j in range(v["num_layers"]):
            x = (checkpoint(self.layer, j, x, use_reentrant=False) if train
                 else self.layer(j, x))
        return layer_norm(x, w, p + "ln_final", VIT_LN_EPS)[:, 0]

    def __call__(self, images: torch.Tensor, train: bool,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return torch.cat([self.one(images[i:i + 1], train) for i in range(images.shape[0])])


def vit_grid(v: Dict, height: int, width: int) -> Tuple[int, int]:
    return height // v["patch_size"], width // v["patch_size"]
