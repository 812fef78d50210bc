"""Checkpoints (port of ``mammo_clip_tpu/train/checkpoint.py``).

The layout is the JAX package's: ``<dir>/<step>/`` holds ``meta.json`` (the
step plus the trainer's extra fields) and ``config.json`` (the run's config,
the reference's cross-stack contract: downstream consumers rebuild the model
from it). Where the JAX package writes an Orbax tree, the payload here is one
``torch.save`` file, ``state.pt``: the model's state dict (parameters and the
BatchNorm buffers), the optimizer's state, the step, the EMA when there is one,
and the states of the ``torch.Generator``s passed in. It holds tensors, numbers
and containers only, and is read back with ``weights_only=True``.

``extra_arrays`` adds an ``arrays.npz`` sidecar (``np.savez_compressed``) to
the step directory: the downstream trainers persist the validation
predictions there for offline re-scoring (reference:
Classifiers/experiments.py:193-222), and ``load_checkpoint_arrays`` reads it
back.

A step directory, sidecar included, is written under a temporary name and
renamed into place, so a run stopped while writing leaves no partial step
behind.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..core.config import Config

PAYLOAD = "state.pt"


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.exists(os.path.join(directory, n, PAYLOAD)))


def all_steps(directory: str) -> List[int]:
    """The steps with a checkpoint under ``directory``, ascending."""
    return _steps(os.path.abspath(directory))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(os.path.abspath(directory))
    return steps[-1] if steps else None


def save_checkpoint(
    directory: str,
    state,
    config: Optional[Mapping] = None,
    step: Optional[int] = None,
    extra_meta: Optional[Dict[str, Any]] = None,
    max_to_keep: Optional[int] = None,
    generators: Optional[Mapping[str, torch.Generator]] = None,
    extra_arrays: Optional[Mapping[str, Any]] = None,
) -> None:
    """Write ``state`` at ``directory/<step>``, with ``extra_arrays`` (name ->
    array) in its ``arrays.npz``; keep the newest ``max_to_keep`` steps (all
    when None)."""
    directory = os.path.abspath(directory)
    step = int(state.step) if step is None else int(step)
    final = os.path.join(directory, str(step))
    tmp = f"{final}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    payload = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
               "step": int(state.step)}
    if state.ema is not None:
        payload["ema"] = state.ema
    if generators:
        payload["generators"] = {k: g.get_state() for k, g in generators.items()}
    torch.save(payload, os.path.join(tmp, PAYLOAD))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, **(extra_meta or {})}, f)
    if config is not None:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            f.write(Config(config).to_json())
    if extra_arrays:
        np.savez_compressed(os.path.join(tmp, "arrays.npz"),
                            **{k: np.asarray(v) for k, v in extra_arrays.items()})
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    if max_to_keep:
        for old in _steps(directory)[:-max_to_keep]:
            shutil.rmtree(os.path.join(directory, str(old)))


def load_checkpoint_arrays(directory: str, step: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The ``extra_arrays`` sidecar of ``directory/<step>`` (the latest when
    None); {} when none was saved."""
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
    path = os.path.join(directory, str(step), "arrays.npz")
    if not os.path.exists(path):
        return {}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def restore_checkpoint(directory: str, state, step: Optional[int] = None,
                       generators: Optional[Mapping[str, torch.Generator]] = None):
    """Restore ``state`` in place from ``directory/<step>`` (the latest when None).

    A state that tracks an EMA takes the stored EMA, or a copy of the restored
    parameters when the checkpoint was written without one; a state without
    an EMA ignores a stored one. Returns (state, config or None, meta); raises
    FileNotFoundError when there is no checkpoint."""
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    path = os.path.join(directory, str(step))
    payload = torch.load(os.path.join(path, PAYLOAD), map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    if state.ema is not None:
        stored = payload.get("ema")
        with torch.no_grad():
            for name, p in state.model.named_parameters():
                state.ema[name].copy_(stored[name] if stored is not None else p)
    for name, g in (generators or {}).items():
        if name in payload.get("generators", {}):
            g.set_state(payload["generators"][name])
    config = None
    if os.path.exists(os.path.join(path, "config.json")):
        with open(os.path.join(path, "config.json")) as f:
            config = Config.from_json(f.read())
    meta = {}
    if os.path.exists(os.path.join(path, "meta.json")):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    return state, config, meta
