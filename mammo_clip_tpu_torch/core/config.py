"""Unified configuration system (port of ``mammo_clip_tpu/core/config.py``).

A plain-Python copy: ``yaml`` is imported only inside the functions that read or
write YAML, so the port imports on a machine without it. Overrides parse their
values as YAML scalars when PyYAML is present (as the JAX package does) and as
JSON otherwise, so a JSON value reads the same on both machines.

The reference uses two disjoint config systems — Hydra/OmegaConf for pretraining
(/root/reference/src/codebase/train.py:13) and argparse for downstream
(/root/reference/src/codebase/train_classifier.py:14). This module replaces both with a
single nested-dict config with attribute access, YAML/JSON round-trip, and dotted-path
overrides. The critical contract preserved from the reference is that **checkpoints embed
their own config** (reference: trainer.py:220-229 saves ``ckpt["config"]``; every
downstream consumer rebuilds the encoder from it, e.g. breast_clip_classifier.py:10-17).
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, Iterator, Mapping, Optional


class Config(dict):
    """A nested dict with attribute access. Values that are mappings are wrapped lazily."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(value, Mapping) and not isinstance(value, Config):
            value = Config(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    # -- conversion ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            if isinstance(v, Mapping):
                out[k] = Config(v).to_dict()
            elif isinstance(v, (list, tuple)):
                out[k] = [Config(x).to_dict() if isinstance(x, Mapping) else x for x in v]
            else:
                out[k] = v
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls(json.loads(s))

    # -- access helpers --------------------------------------------------------------
    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, Mapping):
                nxt = Config()
                node[part] = nxt
            elif not isinstance(nxt, Config):
                nxt = Config(nxt)
                node[part] = nxt
            node = nxt
        node[parts[-1]] = value

    def merged(self, other: Mapping) -> "Config":
        """Deep merge: `other` wins on leaf conflicts."""
        out = Config(copy.deepcopy(self.to_dict()))
        _deep_merge(out, other)
        return out

    def apply_overrides(self, overrides: Iterator[str]) -> "Config":
        """Apply `a.b.c=value` CLI-style overrides (see the module docstring)."""
        out = Config(copy.deepcopy(self.to_dict()))
        for ov in overrides:
            key, _, raw = ov.partition("=")
            out.set_path(key.strip(), _parse_value(raw))
        return out


def _parse_value(raw: str) -> Any:
    """An override's value: YAML when PyYAML is importable, else JSON, else the text."""
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(raw)
        except ValueError:
            return raw
    return yaml.safe_load(raw)


def _deep_merge(dst: Config, src: Mapping) -> None:
    for k, v in src.items():
        if isinstance(v, Mapping) and isinstance(dst.get(k), Mapping):
            sub = dst[k] if isinstance(dst[k], Config) else Config(dst[k])
            dst[k] = sub
            _deep_merge(sub, v)
        else:
            dst[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v


def load_config(path: str, overrides: Optional[list] = None) -> Config:
    import yaml

    with open(path) as f:
        cfg = Config(yaml.safe_load(f) or {})
    if overrides:
        cfg = cfg.apply_overrides(overrides)
    return cfg


def save_config(cfg: Config, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(Config(cfg).to_dict(), f, sort_keys=False)


# --------------------------------------------------------------------------------------
# Canonical configs. Values mirror the reference recipe:
#   resolution/mean/std      configs/pre_train_b5_clip.yaml:23-27
#   temperature 0.07         configs/model/clip_b5_det_clinical.yaml:2
#   proj_dim 512, linear     configs/model/clip_b5_det_clinical.yaml:20-23
#   loss weights             configs/loss/breast_clip.yaml:1-5
#   AdamW lr 5e-5 wd 1e-4    configs/optimizer/adamw.yaml:4-5
#   15 epochs / 1 warmup     configs/scheduler/cosine_epoch15_warmup1.yaml:3-4
# --------------------------------------------------------------------------------------

def tiny_test_config() -> Config:
    """Miniature end-to-end config (b0 @ 64x64, 2-layer BERT) for tests/dry-runs."""
    cfg = default_pretrain_config("b2")
    cfg.model.image_encoder.name = "efficientnet-b0"
    cfg.model.text_encoder.update(
        vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, max_position_embeddings=64,
    )
    cfg.model.projection_head.proj_dim = 32
    cfg.data.update(image_size_h=64, image_size_w=64, text_max_length=16,
                    batch_size_per_device=2)
    cfg.scheduler.update(epochs=2, warmup_epochs=1)
    return cfg


def default_pretrain_config(variant: str = "b5") -> Config:
    assert variant in ("b2", "b5")
    return Config(
        {
            "seed": 10,
            "model": {
                "name": "clip_custom",
                "temperature": 0.07,
                "image_encoder": {
                    "source": "cnn",
                    "name": f"efficientnet-{variant}",
                    "model_type": "cnn",
                    "pretrained": False,
                },
                "text_encoder": {
                    "source": "bert",
                    "name": "emilyalsentzer/Bio_ClinicalBERT",
                    "pooling": "eos",
                    "gradient_checkpointing": False,
                    "vocab_size": 28996,
                    "hidden_size": 768,
                    "num_layers": 12,
                    "num_heads": 12,
                    "intermediate_size": 3072,
                    "max_position_embeddings": 512,
                },
                "projection_head": {"name": "linear", "proj_dim": 512, "dropout": 0.1},
            },
            "loss": {
                "breast_clip": {
                    "label_smoothing": 0.0,
                    "i2i_weight": 1.0,
                    "t2t_weight": 0.5,
                    "loss_ratio": 1.0,
                }
            },
            "optimizer": {"name": "adamw", "lr": 5.0e-5, "weight_decay": 1.0e-4},
            "scheduler": {"name": "warmup_cosine_sq", "epochs": 15, "warmup_epochs": 1},
            "data": {
                "image_size_h": 1520,
                "image_size_w": 912,
                "mean": 0.3089279,
                "std": 0.25053555408335154,
                "text_max_length": 256,
                "batch_size_per_device": 4 if variant == "b5" else 6,
            },
            "augment": {
                "hflip_p": 0.5,
                "vflip_p": 0.5,
                "affine_p": 0.5,
                "rotate_deg": 20.0,
                "translate_frac": 0.1,
                "scale_min": 0.8,
                "scale_max": 1.2,
                "shear_deg": 20.0,
                "elastic_p": 0.5,
                "elastic_alpha": 10.0,
                "elastic_sigma": 15.0,
            },
            "train": {
                "dtype": "bfloat16",
                "loss_best": "contrastive",
                "log_every": 30,
                "remat": True,
            },
            "mesh": {"data": -1, "model": 1},
        }
    )
