"""MammoCLIP dual encoder (port of ``mammo_clip_tpu/models/clip.py``).

Image encoder (EfficientNet, or ResNet, Swin or ViT by name) + BERT text
encoder + projection heads + learnable ``logit_scale`` initialised to
log(1/temperature). Images are NHWC; embeddings
are L2-normalised in fp32. Both texts of a sample go through ONE BERT call
(exact: nothing in the text tower crosses the batch); the two image views take
SEPARATE tower passes, because BatchNorm batch statistics over a joint batch
would change the training semantics.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from .bert import BertConfig, BertEncoder, pool_text
from .efficientnet import EfficientNet
from .projection import make_projection_head
from .resnet import ResNet
from .swin import SwinConfig, SwinTransformer
from .vit import ViT, ViTConfig


def bert_config_from_model_config(model_config: Dict) -> BertConfig:
    """The text encoder's options, as the JAX package's function of the same name
    reads them. One knob is the port's own: ``dropout_rate``, which the JAX
    function ignores (its BERT always uses ``BertConfig``'s 0.1); the parity
    tests set it to compare without dropout. ``seq_parallel`` is carried over
    (``models/bert.py``: sequence shards over a split encoder's model axis)."""
    t = model_config["text_encoder"]
    return BertConfig(
        vocab_size=t.get("vocab_size", 28996),
        hidden_size=t.get("hidden_size", 768),
        num_layers=t.get("num_layers", 12),
        num_heads=t.get("num_heads", 12),
        intermediate_size=t.get("intermediate_size", 3072),
        max_position_embeddings=t.get("max_position_embeddings", 512),
        dropout_rate=t.get("dropout_rate", 0.1),
        remat=t.get("gradient_checkpointing", False),
        fused_qkv=t.get("fused_qkv", False),
        amp_attn_scores=t.get("amp_attn_scores", False),
        seq_parallel=t.get("seq_parallel", False),
    )


def efficientnet_variant(name: str) -> str:
    """Map encoder names (incl. the reference's quirk aliases) to a variant."""
    aliases = {"tf_efficientnetv2-detect": "b2", "tf_efficientnet_b5_ns-detect": "b5"}
    if name in aliases:
        return aliases[name]
    if name.startswith(("efficientnet-", "tf_efficientnet_")):
        for variant in ("b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7"):
            if variant in name:
                return variant
    raise ValueError(f"unknown image encoder name: {name}")


def load_image_encoder(config: Dict, dtype: torch.dtype = torch.float32) -> nn.Module:
    """Image-encoder factory, dispatching as the JAX package's does: ``resnet*``
    to ResNet (an unknown resnet name raises ``KeyError``), ``swin*`` or
    ``model_type: swin`` to Swin, ``vit*`` or ``model_type: vit`` to ViT, any
    other name to EfficientNet with every option of the config, the flagship
    (``tpu_optimized`` and its ``tpu_*`` widths) included (``feature_taps``:
    the blocks whose outputs it also returns, as ``out["taps"]``). Every
    encoder returns ``pooled`` and ``features`` and has ``out_dim``; the
    EfficientNet-only keys are ignored for the other families, as in JAX
    (``quant_int8_k5`` and ``s2d_exec`` among them). ``s2d_exec`` with
    ``packed_residuals`` raises ``ValueError``, as JAX's encoder refuses it."""
    name = str(config.get("name", "efficientnet-b5"))
    in_channels = config.get("in_channels", 1)
    if name.startswith("resnet"):
        return ResNet(variant=name, in_channels=in_channels, dtype=dtype)
    if name.startswith("swin") or config.get("model_type") == "swin":
        swin_cfg = SwinConfig(
            patch_size=config.get("patch_size", 4),
            embed_dim=config.get("embed_dim", 96),
            depths=tuple(config.get("depths", (2, 2, 6, 2))),
            num_heads=tuple(config.get("num_heads", (3, 6, 12, 24))),
            window=config.get("window", 8),
        )
        return SwinTransformer(cfg=swin_cfg, in_channels=in_channels, dtype=dtype)
    if name.startswith("vit") or config.get("model_type") == "vit":
        vit_cfg = ViTConfig(
            patch_size=config.get("patch_size", 16),
            hidden_size=config.get("hidden_size", 768),
            num_layers=config.get("num_layers", 12),
            num_heads=config.get("num_heads", 12),
            mlp_dim=config.get("mlp_dim", 3072),
            base_grid=config.get("base_grid", 14),
        )
        return ViT(cfg=vit_cfg, in_channels=in_channels, dtype=dtype)
    # packed_residuals is accepted and not passed on: a lane layout of the TPU for
    # remat's saved block inputs (a reshape, the same math); NCHW has no lane padding
    if config.get("s2d_exec") and config.get("packed_residuals"):
        raise ValueError("s2d_exec is its own layout regime: packed_residuals cannot be "
                         "combined with it")
    return EfficientNet(
        variant=efficientnet_variant(name),
        in_channels=in_channels,
        drop_connect_rate=config.get("drop_connect_rate", 0.2),
        remat=config.get("remat", False),
        remat_max_reduction=config.get("remat_max_reduction", 16),
        fused_mbconv=config.get("fused_mbconv", False),
        tpu_optimized=config.get("tpu_optimized", False),
        tpu_front_blocks=config.get("tpu_front_blocks", 2),
        tpu_front_expand=config.get("tpu_front_expand", 1),
        tpu_dense_widths=config.get("tpu_dense_widths", True),
        tpu_slim_stage3=config.get("tpu_slim_stage3", 0),
        tpu_slim_stage4=config.get("tpu_slim_stage4", 0),
        tpu_slim_stage5=config.get("tpu_slim_stage5", 0),
        tpu_slim_stage6=config.get("tpu_slim_stage6", 0),
        tpu_slim_stage7=config.get("tpu_slim_stage7", 0),
        quant_int8_k5=config.get("quant_int8_k5", False),
        s2d_exec=config.get("s2d_exec", False),
        pooling=config.get("pooling", "avg"),
        dtype=dtype,
        feature_taps=tuple(config.get("feature_taps", ())),
    )


def image_encoder_state(clip_state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The image encoder's parameters and BatchNorm statistics out of a CLIP
    model's state dict (``MammoCLIP.state_dict()``), without their
    ``image_encoder.`` prefix."""
    prefix = "image_encoder."
    encoder = {k[len(prefix):]: v for k, v in clip_state.items() if k.startswith(prefix)}
    if not encoder:
        raise KeyError("CLIP checkpoint missing image_encoder")
    return encoder


class MammoCLIP(nn.Module):
    """Dual encoder. ``model_config`` follows core.config.default_pretrain_config."""

    def __init__(self, model_config: Dict, dtype: torch.dtype = torch.float32):
        super().__init__()
        mc = dict(model_config)
        self.image_encoder = load_image_encoder(dict(mc["image_encoder"]), dtype=dtype)
        self.text_encoder = BertEncoder(bert_config_from_model_config(mc), dtype=dtype)
        self.text_pooling = mc["text_encoder"].get("pooling", "eos")
        self.has_projection = "projection_head" in mc
        if self.has_projection:
            ph = dict(mc["projection_head"])
            self.image_projection = make_projection_head(ph, self.image_encoder.out_dim)
            self.text_projection = make_projection_head(ph, self.text_encoder.out_dim)
        temperature = mc.get("temperature", 0.07)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / temperature)))

    def encode_image(self, images, train: bool = False, generator=None):
        return self.image_encoder(images, train=train, generator=generator)["pooled"]

    def encode_text(self, input_ids, attention_mask, train: bool = False, generator=None):
        hidden = self.text_encoder(input_ids, attention_mask, train=train, generator=generator)
        return pool_text(hidden, attention_mask, self.text_pooling)

    def _project_normalize(self, feats, projection, train, generator):
        emb = projection(feats, train, generator) if projection is not None else feats
        emb = emb.float()
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)

    def embed_image(self, images, train: bool = False, generator=None):
        feats = self.encode_image(images, train, generator)
        proj = self.image_projection if self.has_projection else None
        return self._project_normalize(feats, proj, train, generator)

    def embed_text(self, input_ids, attention_mask, train: bool = False, generator=None):
        feats = self.encode_text(input_ids, attention_mask, train, generator)
        proj = self.text_projection if self.has_projection else None
        return self._project_normalize(feats, proj, train, generator)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """batch keys: images (N,H,W,C); input_ids/attention_mask (N,S); optional
        image_views, input_ids2/attention_mask2 for the multi-positive loss."""
        out = {"image_embeddings": self.embed_image(batch["images"], train, generator),
               "logit_scale": torch.exp(self.logit_scale)}
        if "input_ids2" in batch and "image_views" in batch:
            n = batch["input_ids"].shape[0]
            both = self.embed_text(
                torch.cat([batch["input_ids"], batch["input_ids2"]], 0),
                torch.cat([batch["attention_mask"], batch["attention_mask2"]], 0),
                train, generator)
            out["text_embeddings"], out["text_embeddings2"] = both[:n], both[n:]
            out["image_view_embeddings"] = self.embed_image(batch["image_views"], train,
                                                            generator)
        else:
            out["text_embeddings"] = self.embed_text(batch["input_ids"],
                                                     batch["attention_mask"], train, generator)
        return out
