"""Checkpoint -> (model, config) loading for evaluation (port of
``mammo_clip_tpu/eval/loading.py``).

Accepts both checkpoint formats, preserving the reference's cross-stack contract
(a checkpoint embeds its model config; reference evaluator.py:26-48 rebuilds from it):

* the port's checkpoint directories, written by ``train/checkpoint.py``
  (``<root>/<step>/state.pt`` + ``config.json``, where the JAX package has Orbax):
  a run directory holding ``checkpoints/``, or a step root such as ``best/``;
* reference torch ``.tar`` / ``.pt`` / ``.pth`` files (the public checkpoints),
  imported by ``convert/torch_import.py``.

The model comes back in eval mode on ``device`` with its weights loaded; the JAX
function's separate ``variables`` are the module's own parameters and buffers.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from ..core.config import Config, default_pretrain_config
from ..models import build_model
from ..models.clip import MammoCLIP
from ..train.checkpoint import PAYLOAD, latest_step
from ..utils.device import resolve_device


def _reference_config_to_ours(ref_cfg: Dict) -> Config:
    """Map the reference's embedded Hydra config to our schema (best-effort)."""
    cfg = default_pretrain_config("b5")
    model = ref_cfg.get("model", {})
    name = model.get("image_encoder", {}).get("name", "")
    if name:
        cfg.model.image_encoder.name = name
    base = ref_cfg.get("base", {})
    for src, dst in [
        ("image_size_h", "image_size_h"),
        ("image_size_w", "image_size_w"),
        ("mean", "mean"),
        ("std", "std"),
        ("text_max_length", "text_max_length"),
    ]:
        if src in base:
            cfg.data[dst] = base[src]
    ph = model.get("projection_head")
    if ph:
        cfg.model.projection_head = Config(
            {"name": ph.get("name", "linear"), "proj_dim": ph.get("proj_dim", 512),
             "dropout": ph.get("dropout", 0.1)}
        )
    if "temperature" in model:
        cfg.model.temperature = model["temperature"]
    pooling = model.get("text_encoder", {}).get("pooling")
    if pooling:
        cfg.model.text_encoder.pooling = pooling
    return cfg


def load_clip_for_eval(path: str, dtype: torch.dtype = torch.float32, use_ema: bool = False,
                       device="cuda") -> Tuple[MammoCLIP, Config]:
    """Returns (MammoCLIP in eval mode on ``device``, config); ``dtype`` is the
    activation type.

    ``use_ema=True`` serves the exponential-moving-average weights when the
    checkpoint carries them (train with ``optimizer.ema_decay``); raises if
    requested but absent (silently evaluating the raw weights would be a
    quality-reporting hazard). Torch ``.tar`` imports never carry EMA."""
    device = resolve_device(device)
    if path.endswith((".tar", ".pt", ".pth")):
        from ..convert.from_jax import load_jax_variables
        from ..convert.torch_import import convert_clip_checkpoint

        if use_ema:
            raise ValueError(f"use_ema requested but {path} is a reference checkpoint, "
                             "which carries no EMA")
        variables, ref_cfg = convert_clip_checkpoint(path)
        cfg = _reference_config_to_ours(ref_cfg or {})
        model = build_model(cfg.model.to_dict(), dtype=dtype, device=device)
        load_jax_variables(model, variables)
        return model.eval(), cfg

    # a port checkpoint: the run dir containing checkpoints/, or a step root
    root = path
    if os.path.isdir(os.path.join(path, "checkpoints")):
        root = os.path.join(path, "checkpoints")
    step = latest_step(root)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {root}")
    cfg_path = os.path.join(root, str(step), "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(f"checkpoint {root}/{step} lacks its embedded config.json")
    with open(cfg_path) as f:
        cfg = Config.from_json(f.read())
    # mmap: only the tensors read (the model's, not the optimizer's) leave the disk
    payload = torch.load(os.path.join(root, str(step), PAYLOAD), map_location="cpu",
                         weights_only=True, mmap=True)
    state = dict(payload["model"])
    if use_ema:
        if payload.get("ema") is None:
            raise ValueError(f"use_ema requested but checkpoint {root}/{step} has no EMA "
                             "(train with optimizer.ema_decay > 0)")
        state.update(payload["ema"])
    model = build_model(cfg.model.to_dict(), dtype=dtype, device=device)
    model.load_state_dict(state)
    return model.eval(), cfg
