"""A fake of the PUBLIC Mammo-CLIP ``.tar`` checkpoint contract (port of
``parity/fake_checkpoint.py``).

The public checkpoints (huggingface shawn24/Mammo-CLIP b5-model-best-epoch-7.tar /
b2-model-best-epoch-10.tar, reference README.md:363-374) are not in this
repository, so the import path is exercised against a fake with their format:
the reference custom EfficientNet state dict with its 3-channel RGB stem
(imagetext.py:121 feeds gray->RGB), the extra ``_fc`` head (ignored on import),
HF ``BertModel`` keys at the BioClinicalBERT shape (pooler included), ``module.``
DDP prefixes, and the embedded Hydra config (reference trainer.py:220-229 save
format). Keys, shapes and dtypes are those of the repository's fake; the BERT
tensors are drawn here with HF's initialisation (normal(0, 0.02) weights, the
padding row of the word embeddings zero, unit LayerNorm scales, zero biases)
instead of by ``transformers``, which the card machine does not have.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..models.efficientnet import head_filters, scaled_block_args, stem_filters

_EPOCH = {"b2": 10, "b5": 7}  # the public checkpoints' best epochs
_BERT = dict(vocab_size=28996, hidden=768, layers=12, intermediate=3072, positions=512,
             token_types=2)


def _bert_state_dict(g: torch.Generator) -> Dict[str, torch.Tensor]:
    """HF BertModel's state dict at the BioClinicalBERT shape, HF's init."""
    c = _BERT
    h = c["hidden"]
    sd: Dict[str, torch.Tensor] = {}

    def normal(*shape):
        return 0.02 * torch.randn(*shape, generator=g)

    def linear(name, n_out, n_in):
        sd[name + ".weight"] = normal(n_out, n_in)
        sd[name + ".bias"] = torch.zeros(n_out)

    def layer_norm(name):
        sd[name + ".weight"] = torch.ones(h)
        sd[name + ".bias"] = torch.zeros(h)

    words = normal(c["vocab_size"], h)
    words[0] = 0.0  # padding_idx
    sd["embeddings.word_embeddings.weight"] = words
    sd["embeddings.position_embeddings.weight"] = normal(c["positions"], h)
    sd["embeddings.token_type_embeddings.weight"] = normal(c["token_types"], h)
    layer_norm("embeddings.LayerNorm")
    for i in range(c["layers"]):
        p = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            linear(p + f"attention.self.{name}", h, h)
        linear(p + "attention.output.dense", h, h)
        layer_norm(p + "attention.output.LayerNorm")
        linear(p + "intermediate.dense", c["intermediate"], h)
        linear(p + "output.dense", h, c["intermediate"])
        layer_norm(p + "output.LayerNorm")
    linear("pooler.dense", h, h)
    return sd


def fake_public_payload(
    variant: str = "b2",
    image_hw: Tuple[int, int] = (128, 96),
    text_max_length: int = 24,
    seed: int = 0,
) -> Dict:
    """The payload a public ``.tar`` holds, with random weights at the REAL
    state-dict shapes for ``variant``."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.05

    def bn(prefix, c):
        sd[prefix + ".weight"] = torch.ones(c) + 0.05 * torch.randn(c, generator=g)
        sd[prefix + ".bias"] = 0.05 * torch.randn(c, generator=g)
        sd[prefix + ".running_mean"] = 0.05 * torch.randn(c, generator=g)
        sd[prefix + ".running_var"] = torch.ones(c)
        sd[prefix + ".num_batches_tracked"] = torch.tensor(100)

    # image encoder: the reference custom EfficientNet with its 3-channel stem
    p = "image_encoder."
    stem = stem_filters(variant)
    sd[p + "_conv_stem.weight"] = t(stem, 3, 3, 3)
    bn(p + "_bn0", stem)
    for i, a in enumerate(scaled_block_args(variant)):
        b = f"{p}_blocks.{i}."
        exp = a.in_filters * a.expand_ratio
        if a.expand_ratio != 1:
            sd[b + "_expand_conv.weight"] = t(exp, a.in_filters, 1, 1)
            bn(b + "_bn0", exp)
        sd[b + "_depthwise_conv.weight"] = t(exp, 1, a.kernel, a.kernel)
        bn(b + "_bn1", exp)
        sq = max(1, int(a.in_filters * a.se_ratio))
        sd[b + "_se_reduce.weight"] = t(sq, exp, 1, 1)
        sd[b + "_se_reduce.bias"] = t(sq)
        sd[b + "_se_expand.weight"] = t(exp, sq, 1, 1)
        sd[b + "_se_expand.bias"] = t(exp)
        sd[b + "_project_conv.weight"] = t(a.out_filters, exp, 1, 1)
        bn(b + "_bn2", a.out_filters)
    head = head_filters(variant)
    last = scaled_block_args(variant)[-1].out_filters
    sd[p + "_conv_head.weight"] = t(head, last, 1, 1)
    bn(p + "_bn1", head)
    sd[p + "_fc.weight"] = t(1, head)  # extra key (num_classes=1): ignored on import
    sd[p + "_fc.bias"] = t(1)

    for k, v in _bert_state_dict(g).items():
        sd["text_encoder.text_encoder." + k] = v

    sd["image_projection.projection.weight"] = t(512, head)
    sd["image_projection.projection.bias"] = t(512)
    sd["text_projection.projection.weight"] = t(512, 768)
    sd["text_projection.projection.bias"] = t(512)
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))

    name = {"b2": "tf_efficientnetv2-detect", "b5": "tf_efficientnet_b5_ns-detect"}
    ref_cfg = {  # the reference's embedded Hydra config shape (trainer.py:220-229)
        "model": {
            "image_encoder": {"source": "cnn", "name": name[variant],
                              "pretrained": True, "model_type": "cnn"},
            "text_encoder": {"source": "huggingface", "gradient_checkpointing": False,
                             "name": "emilyalsentzer/Bio_ClinicalBERT",
                             "pooling": "eos"},
            "projection_head": {"name": "linear", "proj_dim": 512, "dropout": 0.1},
            "temperature": 0.07,
        },
        "base": {"image_size_h": image_hw[0], "image_size_w": image_hw[1],
                 "mean": 0.3089279, "std": 0.2505356,
                 "text_max_length": text_max_length},
    }
    return {"model": {f"module.{k}": v for k, v in sd.items()},
            "optimizer": {}, "scheduler": {}, "config": ref_cfg,
            "epoch": _EPOCH.get(variant, 0), "train_loss": 0.41}


def make_fake_public_tar(
    path: str,
    variant: str = "b2",
    image_hw: Tuple[int, int] = (128, 96),
    text_max_length: int = 24,
    seed: int = 0,
) -> str:
    """Write ``fake_public_payload(...)`` as a reference-format ``.tar`` at
    ``path`` and return ``path``."""
    torch.save(fake_public_payload(variant, image_hw, text_max_length, seed), path)
    return path
