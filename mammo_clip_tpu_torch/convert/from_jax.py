"""JAX parameter tree <-> the port's state dict.

The port names its parameters and buffers after the Flax tree of the JAX
package (``image_encoder.block_4.bn1.scale``, ``text_encoder.layer_0.attention
.query.kernel``...). Conversion flattens ``{"params", "batch_stats"}`` (nested
dicts of numpy arrays) with dotted keys and turns 4-D conv kernels from Flax's
HWIO into torch's OIHW; every other leaf keeps its shape. The BatchNorm
running statistics (``mean``, ``var``) are the ``batch_stats`` collection.

The other image encoders keep their Flax trees too. ResNet's
(``stem_conv``, ``stem_bn``, ``stage{s}_block{i}.{conv1..3, bn1..3,
downsample, downsample_bn}``) is convs and BatchNorms like EfficientNet's.
ViT's (``patch_embed``, ``cls_token`` and ``pos_embedding``, (1, 1, D) and
(1, g*g+1, D), ``block_{i}.{ln1, attn.{query,key,value,out}, ln2, fc1, fc2}``,
``ln_final``) and Swin's (``patch_embed``, ``patch_ln``,
``stage{s}_block{i}.{ln1, qkv, rel_pos_table, proj, ln2, fc1, fc2}``,
``merge_ln{s}``, ``merge{s}``, ``final_ln``) keep their DenseGeneral kernels
as they are: (D, heads, head_dim) for q/k/v and (heads, head_dim, D) for an
attention output. Swin's ``qkv`` kernel, (C, 3, heads, head_dim), is the one
4-D kernel that is not a conv kernel: it keeps its shape both ways.
Mammo-FActOR's mapper (``proj{i}_fc1``, ``proj{i}_fc2``) is Flax Denses.

The same holds for the downstream classifiers' trees: ``MammoClassifier``'s
``image_encoder`` and ``MammoEfficientNetClassifier``'s ``encoder``, each with
a ``head`` that is a Flax Dense (``head.kernel`` (in, classes) and
``head.bias``, kept as they are), so both packages can start from one set of
weights. So it does for RetinaNet's tree: ``image_encoder`` (the backbone's
explicit Flax name), ``fpn`` (``p3_lateral`` ... ``p7``) and ``box_subnet`` /
``class_subnet`` (``conv0``-``conv3``, ``out``), all Flax Convs with a bias.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _is_conv_kernel(path, arr) -> bool:
    """A 4-D ``kernel`` leaf, except Swin's (C, 3, heads, head_dim) ``qkv``."""
    return path[-1] == "kernel" and arr.ndim == 4 and not (len(path) > 1 and path[-2] == "qkv")


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``variables``: {"params": ..., "batch_stats": ...} as nested dicts of arrays."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            arr = np.asarray(leaf, dtype=np.float32)
            if collection == "params" and _is_conv_kernel(path, arr):
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            out[".".join(path)] = torch.tensor(arr)
    return out


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Copy a JAX tree into ``model`` in place; every key must match both ways."""
    missing, unexpected = model.load_state_dict(state_dict_from_jax(variables), strict=False)
    if missing or unexpected:
        raise KeyError(f"JAX tree does not match the model: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")


def variables_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """The inverse of ``state_dict_from_jax``: the port's state dict ->
    {"params": ..., "batch_stats": ...} as nested dicts of fp32 numpy arrays,
    4-D conv kernels back in HWIO."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        path = name.split(".")
        arr = t.detach().cpu().float().numpy()
        collection = "batch_stats" if path[-1] in ("mean", "var") else "params"
        if collection == "params" and _is_conv_kernel(path, arr):
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        node = out[collection]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out
