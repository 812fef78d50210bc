"""Inputs and weights made from the seed.

``host_batches`` is the one generator of every traffic mix. A mix's
``images`` give the batch keys of uint8 images and the rows of each; its
``texts`` give the (ids, mask) key pairs and the rows of each, with lengths
drawn uniformly in [``length_min``, the configuration's ``text_max_length``]
and zero ids past them. Sizes come from the configuration's ``data``; an
image tower that takes more than one channel (``in_channels``, 3 for a
HuggingFace ViT) gets the gray plane repeated, as a grayscale image read as
RGB. Every seed gets the same shapes; only values and lengths move.

``make_weights`` draws every parameter on the card from the seed in one
call, in fp32 (the type the program keeps them in): HuggingFace's
``initializer_range`` 0.02 normal for every kernel and embedding (BERT's and
ViT's published init; EfficientNet's kernels are followed by BatchNorm, so
their scale does not matter), ones for norm scales, zeros for biases,
``log(1 / temperature)`` for the logit scale; BatchNorm running statistics
start at mean 0, variance 1.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

INIT_STD = 0.02


def host_batches(traffic: Dict, cfg: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """``traffic['pool']`` host batches (numpy) of the mix for the
    configuration ``cfg`` (a configuration file's ``config``)."""
    rng = np.random.default_rng([seed, 1])
    data = cfg["data"]
    h, w, s = data["image_size_h"], data["image_size_w"], data["text_max_length"]
    vocab = cfg["model"]["text_encoder"]["vocab_size"]
    channels = cfg["model"]["image_encoder"].get("in_channels", 1)
    out = []
    for _ in range(traffic["pool"]):
        batch: Dict[str, np.ndarray] = {}
        for key in traffic["images"]["keys"]:
            gray = rng.integers(0, 256, size=(traffic["images"]["rows"], h, w, 1),
                                dtype=np.uint8)
            batch[key] = np.repeat(gray, channels, axis=3) if channels > 1 else gray
        t = traffic["texts"]
        for ids_key, mask_key in t["keys"]:
            lengths = rng.integers(t["length_min"], s + 1, size=t["rows"])
            mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int64)
            batch[ids_key] = rng.integers(1, vocab, size=(t["rows"], s)) * mask
            batch[mask_key] = mask
        out.append(batch)
    return out


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def make_weights(params: Dict[str, tuple], buffers: Dict[str, tuple], seed: int, device,
                 temperature: float = 0.07) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed)
    drawn = [n for n in params if n.rsplit(".", 1)[-1] in
             ("kernel", "embedding", "pos_embedding", "cls_token")]
    sizes = [math.prod(params[n]) for n in drawn]
    flat = torch.randn(sum(sizes), generator=g, device=device).mul_(INIT_STD)
    out = dict(zip(drawn, (t.view(params[n]) for n, t in zip(drawn, flat.split(sizes)))))
    for name, shape in params.items():
        if name in out:
            continue
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            out[name] = torch.ones(shape, device=device)
        elif leaf == "bias":
            out[name] = torch.zeros(shape, device=device)
        elif name == "logit_scale":
            out[name] = torch.tensor(math.log(1.0 / temperature), device=device)
        else:
            raise KeyError(f"no rule to make {name}")
    for name, shape in buffers.items():
        out[name] = (torch.zeros if name.endswith(".mean") else torch.ones)(shape, device=device)
    return {n: out[n] for n in list(params) + list(buffers)}
