"""Reference torch checkpoint -> Flax-shaped parameter tree (port of
``mammo_clip_tpu/convert/torch_import.py``).

The public Mammo-CLIP checkpoints (b2-model-best-epoch-10.tar / b5-...-epoch-7.tar,
reference README.md:363-374) are torch pickles whose ``"model"`` state dict uses the
reference's module names:

  image_encoder._conv_stem.weight / ._bn0.* / ._blocks.{i}.{_expand_conv,_bn0,
  _depthwise_conv,_bn1,_se_reduce,_se_expand,_project_conv,_bn2}.* /
  _conv_head.weight / _bn1.*                  (efficientnet_custom.py:163-211)
  text_encoder.text_encoder.<HF BertModel>    (text_encoder.py:18-25)
  image_projection.projection.* / text_projection.projection.*  (projection.py:7)
  logit_scale                                  (clip.py:39-43)

This module maps those tensors onto the JAX package's MammoCLIP parameter tree
(nested dicts of numpy arrays, leaf for leaf what the JAX importer gives), which
``convert/from_jax.py::load_jax_variables`` loads into the port's model. Layouts:
conv OIHW -> HWIO, linear (O,I) -> (I,O), BERT attention (H,H) -> (H, heads,
head_dim) kernels, BN running stats -> batch_stats. The classifier head ``_fc``
and HF's pooler are not part of the CLIP model and are ignored.

``convert_hf_vit`` and ``convert_hf_swin`` map a Hugging Face ``ViTModel`` /
``SwinModel`` state dict (any mapping of HF names to torch tensors or numpy
arrays; ``transformers`` itself is not needed) onto the ViT / Swin encoder's
Flax-shaped subtree, loaded the same way.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()  # torch tensor


def _conv(t) -> np.ndarray:
    return _np(t).transpose(2, 3, 1, 0)  # OIHW -> HWIO


def _linear_kernel(t) -> np.ndarray:
    return _np(t).T  # (O, I) -> (I, O)


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _convert_bn(sd, prefix: str, params: Dict, stats: Dict, out_name: Tuple[str, ...]):
    _set(params, out_name + ("scale",), _np(sd[prefix + ".weight"]))
    _set(params, out_name + ("bias",), _np(sd[prefix + ".bias"]))
    _set(stats, out_name + ("mean",), _np(sd[prefix + ".running_mean"]))
    _set(stats, out_name + ("var",), _np(sd[prefix + ".running_var"]))


def convert_efficientnet(sd: Dict[str, Any], prefix: str = "image_encoder.") -> Tuple[Dict, Dict]:
    """Reference lukemelas EfficientNet state dict -> (params, batch_stats) subtrees
    of the EfficientNet."""
    params: Dict = {}
    stats: Dict = {}
    stem = _conv(sd[prefix + "_conv_stem.weight"])  # HWIO
    if stem.shape[2] == 3:
        # The public checkpoints are trained on grayscale replicated to RGB
        # (reference: imagetext.py:121 Image.open(...).convert('RGB'); the custom
        # EfficientNet keeps its 3-channel stem, efficientnet_custom.py:174). On
        # replicated-gray inputs conv3ch(x,x,x) == conv1ch(x) with the kernel summed
        # over the input axis: exact, and a third of the input traffic.
        stem = stem.sum(axis=2, keepdims=True)
    _set(params, ("stem_conv", "kernel"), stem)
    _convert_bn(sd, prefix + "_bn0", params, stats, ("stem_bn",))

    n_blocks = 1 + max(
        int(m.group(1))
        for k in sd
        if (m := re.match(re.escape(prefix) + r"_blocks\.(\d+)\.", k))
    )
    for i in range(n_blocks):
        src = f"{prefix}_blocks.{i}."
        dst = (f"block_{i}",)
        if src + "_expand_conv.weight" in sd:
            _set(params, dst + ("expand_conv", "kernel"), _conv(sd[src + "_expand_conv.weight"]))
            _convert_bn(sd, src + "_bn0", params, stats, dst + ("bn0",))
        _set(params, dst + ("depthwise_conv", "kernel"), _conv(sd[src + "_depthwise_conv.weight"]))
        _convert_bn(sd, src + "_bn1", params, stats, dst + ("bn1",))
        if src + "_se_reduce.weight" in sd:
            _set(params, dst + ("se", "reduce", "kernel"), _conv(sd[src + "_se_reduce.weight"]))
            _set(params, dst + ("se", "reduce", "bias"), _np(sd[src + "_se_reduce.bias"]))
            _set(params, dst + ("se", "expand", "kernel"), _conv(sd[src + "_se_expand.weight"]))
            _set(params, dst + ("se", "expand", "bias"), _np(sd[src + "_se_expand.bias"]))
        _set(params, dst + ("project_conv", "kernel"), _conv(sd[src + "_project_conv.weight"]))
        _convert_bn(sd, src + "_bn2", params, stats, dst + ("bn2",))

    _set(params, ("head_conv", "kernel"), _conv(sd[prefix + "_conv_head.weight"]))
    _convert_bn(sd, prefix + "_bn1", params, stats, ("head_bn",))
    return params, stats


def convert_bert(sd: Dict[str, Any], num_heads: int, prefix: str = "text_encoder.text_encoder.") -> Dict:
    """HF BertModel state dict -> the BertEncoder's params subtree."""
    params: Dict = {}
    emb = prefix + "embeddings."
    _set(params, ("word_embeddings", "embedding"), _np(sd[emb + "word_embeddings.weight"]))
    _set(params, ("position_embeddings", "embedding"), _np(sd[emb + "position_embeddings.weight"]))
    _set(params, ("token_type_embeddings", "embedding"), _np(sd[emb + "token_type_embeddings.weight"]))
    _set(params, ("embeddings_ln", "scale"), _np(sd[emb + "LayerNorm.weight"]))
    _set(params, ("embeddings_ln", "bias"), _np(sd[emb + "LayerNorm.bias"]))

    n_layers = 1 + max(
        int(m.group(1))
        for k in sd
        if (m := re.match(re.escape(prefix) + r"encoder\.layer\.(\d+)\.", k))
    )
    for i in range(n_layers):
        src = f"{prefix}encoder.layer.{i}."
        dst = (f"layer_{i}",)
        hidden = _np(sd[src + "attention.self.query.weight"]).shape[0]
        head_dim = hidden // num_heads
        for name in ("query", "key", "value"):
            w = _linear_kernel(sd[src + f"attention.self.{name}.weight"])  # (H, H)
            b = _np(sd[src + f"attention.self.{name}.bias"])
            _set(params, dst + ("attention", name, "kernel"), w.reshape(hidden, num_heads, head_dim))
            _set(params, dst + ("attention", name, "bias"), b.reshape(num_heads, head_dim))
        wo = _linear_kernel(sd[src + "attention.output.dense.weight"])  # (H_in, H_out)
        _set(params, dst + ("attention", "output", "kernel"), wo.reshape(num_heads, head_dim, hidden))
        _set(params, dst + ("attention", "output", "bias"), _np(sd[src + "attention.output.dense.bias"]))
        _set(params, dst + ("attention_ln", "scale"), _np(sd[src + "attention.output.LayerNorm.weight"]))
        _set(params, dst + ("attention_ln", "bias"), _np(sd[src + "attention.output.LayerNorm.bias"]))
        _set(params, dst + ("intermediate", "kernel"), _linear_kernel(sd[src + "intermediate.dense.weight"]))
        _set(params, dst + ("intermediate", "bias"), _np(sd[src + "intermediate.dense.bias"]))
        _set(params, dst + ("ffn_output", "kernel"), _linear_kernel(sd[src + "output.dense.weight"]))
        _set(params, dst + ("ffn_output", "bias"), _np(sd[src + "output.dense.bias"]))
        _set(params, dst + ("ffn_ln", "scale"), _np(sd[src + "output.LayerNorm.weight"]))
        _set(params, dst + ("ffn_ln", "bias"), _np(sd[src + "output.LayerNorm.bias"]))
    return params


def convert_state_dict(sd: Dict[str, Any], num_heads: int = 12) -> Dict[str, Dict]:
    """Full reference BreastClip state dict -> {'params': ..., 'batch_stats': ...}."""
    enc_params, enc_stats = convert_efficientnet(sd, "image_encoder.")
    variables: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    variables["params"]["image_encoder"] = enc_params
    variables["batch_stats"]["image_encoder"] = enc_stats
    if any(k.startswith("text_encoder.") for k in sd):
        variables["params"]["text_encoder"] = convert_bert(sd, num_heads)
    if "image_projection.projection.weight" in sd:
        variables["params"]["image_projection"] = {
            "projection": {
                "kernel": _linear_kernel(sd["image_projection.projection.weight"]),
                "bias": _np(sd["image_projection.projection.bias"]),
            }
        }
        variables["params"]["text_projection"] = {
            "projection": {
                "kernel": _linear_kernel(sd["text_projection.projection.weight"]),
                "bias": _np(sd["text_projection.projection.bias"]),
            }
        }
    if "logit_scale" in sd:
        variables["params"]["logit_scale"] = _np(sd["logit_scale"]).reshape(())
    return variables


def convert_hf_vit(sd: Dict[str, Any], num_heads: int = 12) -> Dict:
    """HF ``ViTModel`` state dict -> models/vit.ViT params subtree.

    The reference loads pretrained HF ViTs as alternative image encoders
    (breastclip/model/modules/image_encoder.py:17-48 with
    ``interpolate_pos_encoding=True``). The public checkpoints feed grayscale
    replicated to RGB, so a 3-channel patch embedding collapses EXACTLY to a
    1-channel one by summing the kernel over the input axis (same identity as
    the EfficientNet stem above). Note: our pos-embedding interpolation is
    bilinear (HF uses bicubic); at the pretraining grid they agree exactly.
    """
    params: Dict = {}
    emb = "embeddings."
    _set(params, ("cls_token",), _np(sd[emb + "cls_token"]))
    _set(params, ("pos_embedding",), _np(sd[emb + "position_embeddings"]))
    patch = _conv(sd[emb + "patch_embeddings.projection.weight"])
    if patch.shape[2] == 3:
        patch = patch.sum(axis=2, keepdims=True)
    _set(params, ("patch_embed", "kernel"), patch)
    _set(params, ("patch_embed", "bias"), _np(sd[emb + "patch_embeddings.projection.bias"]))

    n_layers = 1 + max(
        int(m.group(1))
        for k in sd
        if (m := re.match(r"encoder\.layer\.(\d+)\.", k))
    )
    for i in range(n_layers):
        src = f"encoder.layer.{i}."
        dst = (f"block_{i}",)
        hidden = _np(sd[src + "attention.attention.query.weight"]).shape[0]
        head_dim = hidden // num_heads
        _set(params, dst + ("ln1", "scale"), _np(sd[src + "layernorm_before.weight"]))
        _set(params, dst + ("ln1", "bias"), _np(sd[src + "layernorm_before.bias"]))
        for name in ("query", "key", "value"):
            w = _linear_kernel(sd[src + f"attention.attention.{name}.weight"])
            b = _np(sd[src + f"attention.attention.{name}.bias"])
            _set(params, dst + ("attn", name, "kernel"), w.reshape(hidden, num_heads, head_dim))
            _set(params, dst + ("attn", name, "bias"), b.reshape(num_heads, head_dim))
        wo = _linear_kernel(sd[src + "attention.output.dense.weight"])
        _set(params, dst + ("attn", "out", "kernel"), wo.reshape(num_heads, head_dim, hidden))
        _set(params, dst + ("attn", "out", "bias"), _np(sd[src + "attention.output.dense.bias"]))
        _set(params, dst + ("ln2", "scale"), _np(sd[src + "layernorm_after.weight"]))
        _set(params, dst + ("ln2", "bias"), _np(sd[src + "layernorm_after.bias"]))
        _set(params, dst + ("fc1", "kernel"), _linear_kernel(sd[src + "intermediate.dense.weight"]))
        _set(params, dst + ("fc1", "bias"), _np(sd[src + "intermediate.dense.bias"]))
        _set(params, dst + ("fc2", "kernel"), _linear_kernel(sd[src + "output.dense.weight"]))
        _set(params, dst + ("fc2", "bias"), _np(sd[src + "output.dense.bias"]))
    _set(params, ("ln_final", "scale"), _np(sd["layernorm.weight"]))
    _set(params, ("ln_final", "bias"), _np(sd["layernorm.bias"]))
    return params


def convert_hf_swin(sd: Dict[str, Any], num_heads) -> Dict:
    """HF ``SwinModel`` state dict -> models/swin.SwinTransformer params subtree.

    Reference analogue: the HuggingfaceImageEncoder 'swin' option
    (breastclip/model/modules/image_encoder.py:17-48, factory
    modules/__init__.py:20-34). ``num_heads`` is the per-stage head tuple.

    Layout notes:
    * our qkv is ONE DenseGeneral with kernel (C, 3, heads, head_dim) — HF's
      separate query/key/value stack on axis 1;
    * patch merging: HF concatenates the 2x2 sub-grids in order
      [(0,0),(1,0),(0,1),(1,1)] while our space-to-depth reshape produces
      [(0,0),(0,1),(1,0),(1,1)] — the reduction kernel's input rows (and the
      merge LayerNorm vectors) are permuted accordingly;
    * the 3-channel patch embedding collapses to 1 channel by summing over the
      input axis (exact on replicated-gray input).
    """
    params: Dict = {}
    emb = "embeddings."
    patch = _conv(sd[emb + "patch_embeddings.projection.weight"])
    if patch.shape[2] == 3:
        patch = patch.sum(axis=2, keepdims=True)
    _set(params, ("patch_embed", "kernel"), patch)
    _set(params, ("patch_embed", "bias"), _np(sd[emb + "patch_embeddings.projection.bias"]))
    _set(params, ("patch_ln", "scale"), _np(sd[emb + "norm.weight"]))
    _set(params, ("patch_ln", "bias"), _np(sd[emb + "norm.bias"]))

    n_stages = 1 + max(
        int(m.group(1))
        for k in sd
        if (m := re.match(r"encoder\.layers\.(\d+)\.", k))
    )
    for s in range(n_stages):
        heads = num_heads[s]
        n_blocks = 1 + max(
            int(m.group(1))
            for k in sd
            if (m := re.match(rf"encoder\.layers\.{s}\.blocks\.(\d+)\.", k))
        )
        for i in range(n_blocks):
            src = f"encoder.layers.{s}.blocks.{i}."
            dst = (f"stage{s}_block{i}",)
            hidden = _np(sd[src + "attention.self.query.weight"]).shape[0]
            head_dim = hidden // heads
            _set(params, dst + ("ln1", "scale"), _np(sd[src + "layernorm_before.weight"]))
            _set(params, dst + ("ln1", "bias"), _np(sd[src + "layernorm_before.bias"]))
            qkv_w = np.stack(
                [_linear_kernel(sd[src + f"attention.self.{n}.weight"]) for n in
                 ("query", "key", "value")], axis=1)  # (C, 3, C)
            qkv_b = np.stack(
                [_np(sd[src + f"attention.self.{n}.bias"]) for n in
                 ("query", "key", "value")], axis=0)  # (3, C)
            _set(params, dst + ("qkv", "kernel"),
                 qkv_w.reshape(hidden, 3, heads, head_dim))
            _set(params, dst + ("qkv", "bias"), qkv_b.reshape(3, heads, head_dim))
            _set(params, dst + ("rel_pos_table",),
                 _np(sd[src + "attention.self.relative_position_bias_table"]))
            wo = _linear_kernel(sd[src + "attention.output.dense.weight"])
            _set(params, dst + ("proj", "kernel"), wo.reshape(heads, head_dim, hidden))
            _set(params, dst + ("proj", "bias"), _np(sd[src + "attention.output.dense.bias"]))
            _set(params, dst + ("ln2", "scale"), _np(sd[src + "layernorm_after.weight"]))
            _set(params, dst + ("ln2", "bias"), _np(sd[src + "layernorm_after.bias"]))
            _set(params, dst + ("fc1", "kernel"), _linear_kernel(sd[src + "intermediate.dense.weight"]))
            _set(params, dst + ("fc1", "bias"), _np(sd[src + "intermediate.dense.bias"]))
            _set(params, dst + ("fc2", "kernel"), _linear_kernel(sd[src + "output.dense.weight"]))
            _set(params, dst + ("fc2", "bias"), _np(sd[src + "output.dense.bias"]))
        down = f"encoder.layers.{s}.downsample."
        if down + "reduction.weight" in sd:
            # HF downsample at the END of stage s == our merge at the START of
            # stage s+1. Re-order the 4C input rows from HF's sub-grid order
            # [(0,0),(1,0),(0,1),(1,1)] to our s2d order [(0,0),(0,1),(1,0),(1,1)].
            red = _linear_kernel(sd[down + "reduction.weight"])  # (4C, 2C)
            c = red.shape[0] // 4
            perm = np.concatenate([np.arange(c) + j * c for j in (0, 2, 1, 3)])
            _set(params, (f"merge{s + 1}", "kernel"), red[perm])
            _set(params, (f"merge_ln{s + 1}", "scale"), _np(sd[down + "norm.weight"])[perm])
            _set(params, (f"merge_ln{s + 1}", "bias"), _np(sd[down + "norm.bias"])[perm])
    _set(params, ("final_ln", "scale"), _np(sd["layernorm.weight"]))
    _set(params, ("final_ln", "bias"), _np(sd["layernorm.bias"]))
    return params


def convert_clip_checkpoint(path: str, num_heads: int = 12) -> Tuple[Dict, Optional[Dict]]:
    """Load a reference .tar checkpoint and return (variables, embedded_config_dict).

    The embedded config (reference trainer.py:220-229) drives the MammoCLIP rebuild,
    preserving the checkpoint-carries-its-config contract. A reference checkpoint
    is a full pickle, so it is read with ``weights_only=False``: load only files
    from a source you trust. An embedded config that is not a plain mapping (the
    reference's Hydra run may store an OmegaConf object) raises rather than being
    replaced by a default.
    """
    import torch

    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    except ModuleNotFoundError as e:
        raise RuntimeError(
            f"{path} pickles an object of module {e.name!r}, which is not installed "
            "(an OmegaConf config needs omegaconf); convert its embedded config to a "
            "plain dict to load it here") from e
    sd = ckpt["model"] if "model" in ckpt else ckpt
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    config = ckpt.get("config")
    if config is not None and not isinstance(config, Mapping):
        raise TypeError(
            f"{path} embeds a config of type {type(config).__name__}, not a plain mapping "
            "(an OmegaConf object needs omegaconf's to_container); the model cannot be "
            "rebuilt from it")
    variables = convert_state_dict(sd, num_heads=num_heads)
    return variables, config
