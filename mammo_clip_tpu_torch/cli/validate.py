"""Offline checkpoint re-validation (port of ``mammo_clip_tpu/cli/validate.py``;
reference: breastclip/validator.py:20-195).

Re-runs the validation loss over a range of saved checkpoint steps and re-selects the
best one: used when the training-time selection must be audited or recomputed with a
different validation set.

    python -m mammo_clip_tpu_torch.cli.validate --workdir outputs/pretrain \
        [--config cfg.json|cfg.yaml] [--steps 3 6] [--device cuda]

The run's config is ``<workdir>/config.json``, which ``cli/pretrain`` writes; a
``config.yaml`` (the JAX CLI's) is read only when there is no JSON and PyYAML is
installed. The model has fp32 activations, as the JAX CLI builds it, and each
step is judged on its raw weights with the BatchNorm running statistics. One
process validates on one device (``--device``, default ``cuda``), so the JAX
CLI's mesh and its host round trip of the restored arrays have no counterpart.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..core.config import Config, load_config
from ..data.datamodule import DataModule
from ..data.pipeline import prefetch_to_device
from ..losses import build_loss
from ..models import build_model
from ..train.checkpoint import all_steps, restore_checkpoint
from ..train.optim import build_optimizer
from ..train.schedule import warmup_cosine_sq_schedule
from ..train.state import create_train_state
from ..train.step import make_eval_step
from ..train.trainer import make_clip_preprocess
from ..utils.device import resolve_device


def load_run_config(workdir: str, path=None) -> Config:
    """``path`` (.json, or YAML through PyYAML), else ``<workdir>/config.json``,
    else ``<workdir>/config.yaml`` when PyYAML can be imported."""
    if path is None:
        path = os.path.join(workdir, "config.json")
        if not os.path.exists(path):
            yaml_path = os.path.join(workdir, "config.yaml")
            if not os.path.exists(yaml_path):
                raise FileNotFoundError(f"{workdir} holds neither config.json nor config.yaml")
            try:
                import yaml  # noqa: F401
            except ImportError as e:
                raise RuntimeError(f"{workdir} has only config.yaml, and reading it needs "
                                   "PyYAML, which is not installed") from e
            path = yaml_path
    if path.endswith(".json"):
        with open(path) as f:
            return Config.from_json(f.read())
    return load_config(path)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--config", default=None,
                    help="defaults to <workdir>/config.json (config.yaml with PyYAML)")
    ap.add_argument("--steps", type=int, nargs="*", default=None,
                    help="checkpoint steps to validate (default: all)")
    ap.add_argument("--loss-key", default="contrastive")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_run_config(args.workdir, args.config)
    ckpt_dir = os.path.join(args.workdir, "checkpoints")
    steps = args.steps or all_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")

    model = build_model(cfg.model.to_dict(), device=device)
    loss_fn = build_loss(cfg.loss.to_dict())
    preprocess = make_clip_preprocess(cfg)
    valid_b = DataModule(cfg).batcher("valid", batch_size=cfg.data.batch_size_per_device)
    opt = build_optimizer(cfg.optimizer.to_dict(), warmup_cosine_sq_schedule(cfg.optimizer.lr, 100, 10),
                          model.named_parameters())
    template = create_train_state(model, opt)
    eval_step = make_eval_step(model, loss_fn, preprocess=preprocess)

    results = {}
    for step in sorted(steps):
        state, _, meta = restore_checkpoint(ckpt_dir, template, step=step)
        losses = []
        for batch in prefetch_to_device(iter(valid_b), device):
            ld = eval_step(state, batch)
            losses.append(float(ld.get(args.loss_key, ld["total"])))
        results[step] = float(np.mean(losses))
        print(f"step {step} (epoch {meta.get('epoch')}): {args.loss_key}={results[step]:.5f}")

    best = min(results, key=results.get)
    summary = {"best_step": best, "losses": results}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
