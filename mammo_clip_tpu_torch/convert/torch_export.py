"""The port's state dict -> reference torch checkpoint (port of
``mammo_clip_tpu/convert/torch_export.py``, the inverse of ``torch_import``).

Lets models trained by the port be consumed by the reference codebase and by
any tooling built around its public checkpoints: emits a torch ``.tar`` with the
reference payload layout ``{"model": state_dict, "config": <embedded config>, "epoch",
"train_loss"}`` (reference: trainer.py:219-230) using the reference's module names
(image_encoder._conv_stem..., text_encoder.text_encoder.<HF BERT>,
image_projection.projection, logit_scale). The input is the port model's
state dict, whose names are the Flax tree's; it is unflattened into that tree
(``convert/from_jax.py::variables_from_state_dict``) and exported as the JAX
package exports a tree.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .from_jax import variables_from_state_dict


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr).copy())


def _conv(arr):  # HWIO -> OIHW
    return _t(np.transpose(np.asarray(arr), (3, 2, 0, 1)))


def _linear(arr):  # (I, O) -> (O, I)
    return _t(np.asarray(arr).T)


def export_efficientnet(params: Dict, stats: Dict, prefix: str = "image_encoder.") -> Dict:
    sd: Dict[str, Any] = {}

    def bn(src_p: Dict, src_s: Dict, dst: str):
        sd[dst + ".weight"] = _t(src_p["scale"])
        sd[dst + ".bias"] = _t(src_p["bias"])
        sd[dst + ".running_mean"] = _t(src_s["mean"])
        sd[dst + ".running_var"] = _t(src_s["var"])

    sd[prefix + "_conv_stem.weight"] = _conv(params["stem_conv"]["kernel"])
    bn(params["stem_bn"], stats["stem_bn"], prefix + "_bn0")
    block_ids = sorted(
        (int(m.group(1)) for k in params if (m := re.match(r"block_(\d+)$", k))),
    )
    for i in block_ids:
        p = params[f"block_{i}"]
        s = stats[f"block_{i}"]
        d = f"{prefix}_blocks.{i}."
        if "expand_conv" in p:
            sd[d + "_expand_conv.weight"] = _conv(p["expand_conv"]["kernel"])
            bn(p["bn0"], s["bn0"], d + "_bn0")
        sd[d + "_depthwise_conv.weight"] = _conv(p["depthwise_conv"]["kernel"])
        bn(p["bn1"], s["bn1"], d + "_bn1")
        if "se" in p:
            sd[d + "_se_reduce.weight"] = _conv(p["se"]["reduce"]["kernel"])
            sd[d + "_se_reduce.bias"] = _t(p["se"]["reduce"]["bias"])
            sd[d + "_se_expand.weight"] = _conv(p["se"]["expand"]["kernel"])
            sd[d + "_se_expand.bias"] = _t(p["se"]["expand"]["bias"])
        sd[d + "_project_conv.weight"] = _conv(p["project_conv"]["kernel"])
        bn(p["bn2"], s["bn2"], d + "_bn2")
    sd[prefix + "_conv_head.weight"] = _conv(params["head_conv"]["kernel"])
    bn(params["head_bn"], stats["head_bn"], prefix + "_bn1")
    return sd


def export_bert(params: Dict, prefix: str = "text_encoder.text_encoder.") -> Dict:
    sd: Dict[str, Any] = {}
    emb = prefix + "embeddings."
    sd[emb + "word_embeddings.weight"] = _t(params["word_embeddings"]["embedding"])
    sd[emb + "position_embeddings.weight"] = _t(params["position_embeddings"]["embedding"])
    sd[emb + "token_type_embeddings.weight"] = _t(params["token_type_embeddings"]["embedding"])
    sd[emb + "LayerNorm.weight"] = _t(params["embeddings_ln"]["scale"])
    sd[emb + "LayerNorm.bias"] = _t(params["embeddings_ln"]["bias"])
    layer_ids = sorted(
        (int(m.group(1)) for k in params if (m := re.match(r"layer_(\d+)$", k))),
    )
    for i in layer_ids:
        p = params[f"layer_{i}"]
        d = f"{prefix}encoder.layer.{i}."
        att = p["attention"]
        hidden = att["output"]["bias"].shape[-1]
        for name in ("query", "key", "value"):
            k = np.asarray(att[name]["kernel"])  # (H, N, D)
            b = np.asarray(att[name]["bias"])  # (N, D)
            sd[d + f"attention.self.{name}.weight"] = _t(k.reshape(hidden, -1).T)
            sd[d + f"attention.self.{name}.bias"] = _t(b.reshape(-1))
        wo = np.asarray(att["output"]["kernel"])  # (N, D, H)
        sd[d + "attention.output.dense.weight"] = _t(wo.reshape(-1, hidden).T)
        sd[d + "attention.output.dense.bias"] = _t(att["output"]["bias"])
        sd[d + "attention.output.LayerNorm.weight"] = _t(p["attention_ln"]["scale"])
        sd[d + "attention.output.LayerNorm.bias"] = _t(p["attention_ln"]["bias"])
        sd[d + "intermediate.dense.weight"] = _linear(p["intermediate"]["kernel"])
        sd[d + "intermediate.dense.bias"] = _t(p["intermediate"]["bias"])
        sd[d + "output.dense.weight"] = _linear(p["ffn_output"]["kernel"])
        sd[d + "output.dense.bias"] = _t(p["ffn_output"]["bias"])
        sd[d + "output.LayerNorm.weight"] = _t(p["ffn_ln"]["scale"])
        sd[d + "output.LayerNorm.bias"] = _t(p["ffn_ln"]["bias"])
    return sd


def export_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port model's state dict -> reference-named torch state dict."""
    variables = variables_from_state_dict(state_dict)
    params = variables["params"]
    stats = variables["batch_stats"]
    sd = export_efficientnet(params["image_encoder"], stats.get("image_encoder", {}))
    if "text_encoder" in params:
        sd.update(export_bert(params["text_encoder"]))
    if "image_projection" in params:
        sd["image_projection.projection.weight"] = _linear(
            params["image_projection"]["projection"]["kernel"])
        sd["image_projection.projection.bias"] = _t(
            params["image_projection"]["projection"]["bias"])
        sd["text_projection.projection.weight"] = _linear(
            params["text_projection"]["projection"]["kernel"])
        sd["text_projection.projection.bias"] = _t(
            params["text_projection"]["projection"]["bias"])
    if "logit_scale" in params:
        sd["logit_scale"] = _t(params["logit_scale"]).reshape(())
    return sd


def export_clip_checkpoint(
    state_dict: Mapping[str, torch.Tensor],
    path: str,
    config: Optional[Dict] = None,
    epoch: int = 0,
    train_loss: float = 0.0,
) -> None:
    """Write a reference-format .tar (torch pickle) with the embedded-config contract."""
    payload = {
        "model": export_state_dict(state_dict),
        "config": dict(config or {}),
        "epoch": epoch,
        "train_loss": train_loss,
    }
    torch.save(payload, path)
