"""Unified configuration system (port of ``mammo_clip_tpu/core/config.py``).

A plain-Python copy: ``yaml`` is imported only inside the functions that read or
write YAML, so the port imports on a machine without it. Override values are
read by the module's own YAML 1.1 scalar and flow parser (``_parse_value``), so
a value means the same with or without PyYAML: what ``yaml.safe_load`` gives,
except that ``1e-4`` is a float (PyYAML leaves it as text) and that binary,
sexagesimal (``1:30``) and ``_``-grouped numbers stay text.

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
import math
import re
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


_BOOLS = {w: v for v, words in ((True, ("yes", "true", "on")), (False, ("no", "false", "off")))
          for word in words for w in (word, word.capitalize(), word.upper())}
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(0x[0-9a-fA-F]+|0[0-7]+|0|[1-9][0-9]*)")
# YAML 1.1's floats without "_", plus exponents without a dot or a sign ("1e-4", "5E3")
_FLOAT = re.compile(r"[-+]?([0-9]+(\.[0-9]*)?|\.[0-9]+)([eE][-+]?[0-9]+)?")
_SPECIAL_FLOATS = {f"{s}.{w}": v for w, v in (("inf", math.inf), ("Inf", math.inf),
                                               ("INF", math.inf)) for s, v in
                   (("", v), ("+", v), ("-", -v))}
_SPECIAL_FLOATS.update({".nan": math.nan, ".NaN": math.nan, ".NAN": math.nan})


def _plain_scalar(text: str) -> Any:
    """YAML 1.1 resolution of an unquoted scalar, as ``yaml.safe_load`` does it,
    except that an exponent needs no dot or sign (PyYAML reads ``1e-4`` as text)
    and that binary, sexagesimal (``1:30``) and ``_``-grouped numbers stay text."""
    text = text.strip()
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if text in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text]
    if _INT.fullmatch(text):
        sign, digits = (-1 if text[0] == "-" else 1), text.lstrip("+-")
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        return sign * int(digits, 8 if digits[0] == "0" and len(digits) > 1 else 10)
    if _FLOAT.fullmatch(text) and any(c.isdigit() for c in text) and (
            "." in text or "e" in text.lower()):
        return float(text)
    return text


class _FlowParser:
    """Quoted scalars and (nested) flow sequences and mappings: ``[1, a]``,
    ``{"k": [true, ~]}``, ``{k: v}``."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\r\n":
            self.i += 1

    def _peek(self) -> str:
        self._ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def _expect(self, ch: str):
        if self._peek() != ch:
            raise ValueError(f"expected {ch!r} at {self.i} in {self.s!r}")
        self.i += 1

    def value(self, in_flow: bool, is_key: bool = False) -> Any:
        ch = self._peek()
        if ch == "[":
            return self._sequence()
        if ch == "{":
            return self._mapping()
        if ch and ch in "\"'":
            return self._quoted(ch)
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            nxt = self.s[self.i + 1] if self.i + 1 < len(self.s) else " "
            if in_flow and c in ",]}":
                break
            if is_key and c == ":" and (nxt in " \t,]}" or not in_flow):
                break
            self.i += 1
        return _plain_scalar(self.s[start:self.i])

    def _quoted(self, q: str) -> str:
        j = self.i + 1
        try:
            while self.s[j] != q or (q == "'" and self.s[j + 1:j + 2] == "'"):
                j += 2 if self.s[j] in ("\\" if q == '"' else "'") else 1
        except IndexError:
            raise ValueError(f"unterminated quote in {self.s!r}") from None
        body, self.i = self.s[self.i + 1:j], j + 1
        return body.replace("''", "'") if q == "'" else json.loads(f'"{body}"')

    def _sequence(self) -> list:
        self._expect("[")
        out = []
        while self._peek() != "]":
            out.append(self.value(in_flow=True))
            if self._peek() != ",":
                break
            self.i += 1
        self._expect("]")
        return out

    def _mapping(self) -> dict:
        self._expect("{")
        out = {}
        while self._peek() != "}":
            key = self.value(in_flow=True, is_key=True)
            self._expect(":")
            out[key] = (None if self._peek() in (",", "}") else self.value(in_flow=True))
            if self._peek() != ",":
                break
            self.i += 1
        self._expect("}")
        return out


def _parse_value(raw: str) -> Any:
    """An override's value with YAML 1.1's meaning of a plain or quoted scalar or
    a flow collection (what ``yaml.safe_load`` gives), with or without PyYAML:
    ``True/yes/on`` and ``false/No/OFF`` are bools, ``~``, ``null`` and the empty
    string None, ``010`` octal, ``0x1F`` hex. Exponents need no dot or sign
    (``1e-4`` is a float; PyYAML leaves it as text). Anything else is the text."""
    text = raw.strip()
    if not text or text[0] not in "[{\"'":
        return _plain_scalar(text)
    p = _FlowParser(text)
    try:
        value = p.value(in_flow=False)
    except ValueError:
        return text
    return value if p._peek() == "" else text


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
