"""Mammo-CLIP in plain PyTorch: the dual encoder, its multi-positive loss, a
training step with AdamW, and eval-mode embeddings.

The model (Ghosh et al., 2024, Mammo-CLIP): an image tower (EfficientNet or
ViT), the BERT text tower, a linear projection of each to ``proj_dim``,
L2-normalised embeddings and a learned ``logit_scale`` (exp of it scales
the similarities). A sample carries two image views and two reports; the
loss is the symmetric InfoNCE over the four view/report pairs (i2t, t2i),
plus ``i2i_weight`` x the view/view and ``t2t_weight`` x the report/report
terms, each a mean cross-entropy against the diagonal.

Random draws follow Mammo-CLIP's port order for one step from a generator
seeded by ``step_seed``: augmentation of all views (first views, then the
second views, in one call), the first views' tower, the text tower on both
reports (first reports, then the second), the second views' tower.

The optimizer is AdamW (Loshchilov & Hutter) with decoupled weight decay on
every parameter, betas (0.9, 0.999), eps 1e-8, and the learning rate of the
reference recipe's schedule: linear warm-up, then cos^2 decay.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from . import augment as aug
from .efficientnet import Tower, head_width, param_shapes as effnet_shapes, variant_of
from .precision import Precision, fp32_only
from .transformers import ViTTower, bert, bert_param_shapes, dense, vit_param_shapes


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """The seed of step ``step``'s generator in a run seeded ``seed``."""
    return (seed * 1_000_003 + step + rank * 1_000_000_007) % (2 ** 63)


def is_vit(model: Dict) -> bool:
    e = model["image_encoder"]
    return str(e.get("name", "")).startswith("vit") or e.get("model_type") == "vit"


def image_width(model: Dict) -> int:
    e = model["image_encoder"]
    return e["hidden_size"] if is_vit(model) else head_width(variant_of(e["name"]))


def param_shapes(model: Dict) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """({parameter: shape}, {buffer: shape}) of the CLIP model ``model`` (the
    config's ``model`` section), named as the measured program names them."""
    e = model["image_encoder"]
    buffers: Dict[str, tuple] = {}
    if is_vit(model):
        params = vit_param_shapes(e, e.get("in_channels", 1))
    else:
        params, buffers = effnet_shapes(variant_of(e["name"]), e.get("in_channels", 1))
    params.update(bert_param_shapes(model["text_encoder"]))
    d = model["projection_head"]["proj_dim"]
    params["image_projection.projection.kernel"] = (image_width(model), d)
    params["image_projection.projection.bias"] = (d,)
    params["text_projection.projection.kernel"] = (model["text_encoder"]["hidden_size"], d)
    params["text_projection.projection.bias"] = (d,)
    params["logit_scale"] = ()
    return params, buffers


class CLIP:
    def __init__(self, w: Dict[str, torch.Tensor], model: Dict, prec: Precision,
                 bn_stats: Optional[list] = None):
        self.w, self.model, self.prec = w, model, prec
        e = model["image_encoder"]
        self.tower = (ViTTower(w, e, prec) if is_vit(model) else
                      Tower(w, variant_of(e["name"]), prec,
                            drop_connect_rate=e.get("drop_connect_rate", 0.2), stats=bn_stats))

    def _normed(self, feats, name):
        y = dense(feats, self.w[name + ".kernel"], self.w[name + ".bias"], self.prec)
        return y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)

    def embed_images(self, x, train: bool, g=None):
        return self._normed(self.tower(x, train, g), "image_projection.projection")

    def embed_texts(self, ids, mask, train: bool, g=None):
        return self._normed(bert(self.w, self.model["text_encoder"], ids, mask, self.prec,
                                 train, g), "text_projection.projection")


def _ce(logits: torch.Tensor) -> torch.Tensor:
    labels = torch.arange(logits.shape[0], device=logits.device)
    return -torch.log_softmax(logits, dim=-1).gather(-1, labels[:, None])[:, 0].mean()


def multi_positive_loss(i1, i2, t1, t2, scale, i2i_weight: float, t2t_weight: float):
    pair = lambda a, b: _ce(scale * (a @ b.T))
    i2t = (pair(i1, t1) + pair(i2, t1) + pair(i1, t2) + pair(i2, t2)) / 4.0
    t2i = (pair(t1, i1) + pair(t1, i2) + pair(t2, i1) + pair(t2, i2)) / 4.0
    i2i = (pair(i1, i2) + pair(i2, i1)) / 2.0
    t2t = (pair(t2, t1) + pair(t1, t2)) / 2.0
    return (i2t + t2i) / 2.0 + i2i_weight * i2i + t2t_weight * t2t


def learning_rate(base: float, step: int, total: int, warmup: int) -> float:
    if step < warmup:
        return base * step / max(1, warmup)
    frac = (step - warmup) / (total - warmup)
    return base * max(math.cos(frac * math.pi / 2.0) ** 2, 0.0)


def clip_loss(clip: CLIP, cfg: Dict, batch: Dict[str, torch.Tensor],
              g) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step's loss and embeddings: augmentation, towers and loss, drawing
    from ``g``. The embeddings are named as the program's outputs name them."""
    data, a, loss = cfg["data"], cfg["augment"], cfg["loss"]["breast_clip"]
    n = batch["images"].shape[0]
    x = aug.augment(torch.cat([batch["images"], batch["image_views"]]), g, a, data["mean"],
                    data["std"])
    i1 = clip.embed_images(x[:n], True, g)
    t = clip.embed_texts(torch.cat([batch["input_ids"], batch["input_ids2"]]),
                         torch.cat([batch["attention_mask"], batch["attention_mask2"]]), True, g)
    i2 = clip.embed_images(x[n:], True, g)
    scale = torch.exp(clip.w["logit_scale"])
    embeddings = {"image_embeddings": i1, "image_view_embeddings": i2,
                  "text_embeddings": t[:n], "text_embeddings2": t[n:]}
    return (multi_positive_loss(i1, i2, t[:n], t[n:], scale, loss["i2i_weight"],
                                loss["t2t_weight"]), embeddings)


def train_steps(weights: Dict[str, torch.Tensor], cfg: Dict, batches: List[Dict],
                seed: int, schedule: Dict, prec: Precision = Precision("fp32"),
                rows: Optional[int] = None) -> Dict[str, list]:
    """``len(batches)`` training steps from ``weights`` (not modified). Returns
    each step's loss, each leaf's first gradient norm, each leaf's change
    after the last step, by name, and the first step's embeddings (host
    arrays). ``rows`` keeps only that many samples of every batch (a fault
    that a correctness limit has to catch)."""
    opt = cfg["optimizer"]
    b1, b2, eps, wd = (opt.get("beta1", 0.9), opt.get("beta2", 0.999), opt.get("eps", 1e-8),
                       opt.get("weight_decay", 1e-4))
    names = list(weights)
    w = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w.items()}
    clip = CLIP(w, cfg["model"], prec)
    device = next(iter(w.values())).device
    g = torch.Generator(device=device)
    losses, first_grad, first_emb = [], {}, {}
    with fp32_only():
        for k, batch in enumerate(batches):
            if rows is not None:
                batch = {key: t[:rows] for key, t in batch.items()}
            g.manual_seed(step_seed(seed, k))
            loss, emb = clip_loss(clip, cfg, batch, g)
            grads = torch.autograd.grad(loss, [w[n] for n in names], allow_unused=True)
            losses.append(float(loss.detach()))
            if k == 0:
                first_emb = {key: e.detach().cpu().numpy() for key, e in emb.items()}
            del emb
            lr = learning_rate(opt["lr"], k, schedule["total_steps"], schedule["warmup_steps"])
            t = k + 1
            with torch.no_grad():
                for name, gr in zip(names, grads):
                    gr = torch.zeros_like(w[name]) if gr is None else gr
                    if k == 0:
                        first_grad[name] = float(torch.linalg.vector_norm(gr))
                    p = w[name]
                    p.mul_(1.0 - lr * wd)
                    m[name].mul_(b1).add_(gr, alpha=1.0 - b1)
                    v2[name].mul_(b2).addcmul_(gr, gr, value=1.0 - b2)
                    denom = (v2[name] / (1.0 - b2 ** t)).sqrt_().add_(eps)
                    p.addcdiv_(m[name], denom, value=-lr / (1.0 - b1 ** t))
            del grads
    change = {n: float(torch.linalg.vector_norm(w[n].detach() - weights[n].float()))
              for n in names}
    return {"loss": losses, "grad": first_grad, "change": change, "embeddings": first_emb}


@torch.no_grad()
def embed(weights: Dict[str, torch.Tensor], cfg: Dict, images: torch.Tensor,
          ids: torch.Tensor, mask: torch.Tensor, prec: Precision = Precision("fp32"),
          rows: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode image embeddings of uint8 ``images`` (n, h, w, c) and text
    embeddings of ``ids``/``mask``, ``rows`` at a time (nothing crosses rows
    in eval mode)."""
    data = cfg["data"]
    w = {k: v.float() for k, v in weights.items()}
    clip = CLIP(w, cfg["model"], prec)
    with fp32_only():
        img = torch.cat([clip.embed_images(aug.standardize(images[i:i + rows], data["mean"],
                                                           data["std"]), False)
                         for i in range(0, images.shape[0], rows)])
        txt = torch.cat([clip.embed_texts(ids[i:i + rows], mask[i:i + rows], False)
                         for i in range(0, ids.shape[0], rows)])
    return img, txt


@torch.no_grad()
def batch_statistics(weights: Dict[str, torch.Tensor], cfg: Dict,
                     images: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every BatchNorm's train-mode batch (mean, var) of the image tower on
    ``images``, in the order of ``efficientnet.param_shapes``'s buffers."""
    data, e = cfg["data"], cfg["model"]["image_encoder"]
    stats: list = []
    tower = Tower({k: v.float() for k, v in weights.items()}, variant_of(e["name"]),
                  Precision("fp32"), drop_connect_rate=0.0, stats=stats)
    with fp32_only():
        tower(aug.standardize(images, data["mean"], data["std"]), True)
    return stats
