"""The measured bench recipes (port of ``mammo_clip_tpu/train/recipes.py``).

Two recipes over ``default_pretrain_config("b5")``:

* ``compat=True``, the reference-exact one: remat on the image tower, fp32
  augmentation output and fp32 attention scores. In the port ``fused_mbconv``
  (on in this recipe) routes the k=3 stride-1 blocks with an expanded width
  <= 256 (B5 blocks 0-2 and 4-7) through the hand-written CUDA MBConv kernel.
* ``compat=False``, the flagship: the ``tpu_optimized`` encoder
  (space-to-depth front, 128-multiple widths) without remat, bf16
  augmentation output, bf16 attention-score storage in BERT
  (``amp_attn``), and optionally the capacity trims (``trimmed`` or explicit
  ``slim`` overrides). No hand kernel lies on its path: the fused route is
  refused under ``tpu_optimized``, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

# the four capacity trims of the JAX package's recipe ({stage: expanded width}), opt-in
TRIMMED_SLIM = {3: 256, 5: 768, 6: 1536, 4: 512}

# bench.py's batch (samples a step); the reference ships 4 per GPU
BENCH_BATCH = 8
BENCH_TOTAL_STEPS = 10_000
BENCH_WARMUP_STEPS = 500


def default_steps_per_call(compat: bool) -> int:
    """Optimizer steps per train call: 5 for the flagship (the JAX recipe's K,
    which amortises a call's fixed cost), 1 for the compat recipe."""
    return 1 if compat else 5


def bench_recipe_config(compat: bool = True, trimmed: bool = False, amp_attn: bool = True,
                        slim: Optional[Dict[int, int]] = None):
    """The recipe's config.

    compat: the reference-exact recipe (above); else the flagship.
    trimmed: the flagship with the four capacity trims (``TRIMMED_SLIM``).
    amp_attn: bf16 attention-score storage in BERT (flagship only).
    slim: explicit {stage: expanded_width} overrides (flagship only; not with
        ``trimmed``).
    """
    from ..core.config import default_pretrain_config

    if compat and (trimmed or slim):
        raise ValueError("capacity trims only apply to the flagship path")
    if trimmed and slim:
        raise ValueError("pass either trimmed=True or explicit slim overrides")
    cfg = default_pretrain_config("b5")
    cfg.model.image_encoder.remat = True
    if compat:
        cfg.model.image_encoder.fused_mbconv = True
        return cfg
    # the flagship: its activations are small enough that remat is a net loss
    cfg.model.image_encoder.tpu_optimized = True
    cfg.model.image_encoder.remat = False
    for stage, width in (TRIMMED_SLIM if trimmed else (slim or {})).items():
        setattr(cfg.model.image_encoder, f"tpu_slim_stage{stage}", width)
    if amp_attn:
        cfg.model.text_encoder.amp_attn_scores = True
    return cfg


def build_bench_train(cfg, *, k_steps: int = 1, device="cuda",
                      seed: int = 0) -> Tuple[object, Callable, object, Callable, Callable]:
    """Build the train step of a ``bench_recipe_config`` cfg.

    Returns ``(model, loss_fn, state, preprocess, train_step)``: the model has bf16
    activations and fp32 parameters drawn from ``seed`` on ``device``; ``state``
    holds it with its AdamW optimizer; ``train_step(state, batch, generator)``, or
    with ``k_steps > 1`` the K-step call that takes (K, B, ...) stacked batches.
    The compat recipe keeps the augmentation's output fp32; the flagship
    (``model.image_encoder.tpu_optimized``) emits bf16.
    """
    from ..losses import build_loss
    from ..models import build_model
    from ..ops.augment import AugmentConfig, augment_two_views
    from . import (build_optimizer, create_train_state, make_train_multistep, make_train_step,
                   warmup_cosine_sq_schedule)

    gen = torch.Generator(device=device).manual_seed(seed)
    model = build_model(cfg.model.to_dict(), dtype=torch.bfloat16, device=device, generator=gen)
    loss_fn = build_loss(cfg.loss.to_dict())
    schedule = warmup_cosine_sq_schedule(cfg.optimizer.lr, total_steps=BENCH_TOTAL_STEPS,
                                         warmup_steps=BENCH_WARMUP_STEPS)
    state = create_train_state(model, build_optimizer(cfg.optimizer.to_dict(), schedule,
                                                      model.named_parameters()))
    aug = AugmentConfig.from_dict(cfg.augment.to_dict())
    mean, std = cfg.data.mean, cfg.data.std
    out_dtype = torch.bfloat16 if cfg.model.image_encoder.get("tpu_optimized", False) else None

    def preprocess(batch, generator):
        batch = dict(batch)
        batch["images"], batch["image_views"] = augment_two_views(
            batch["images"], batch["image_views"], generator, aug, mean, std, train=True,
            out_dtype=out_dtype)
        return batch

    make = make_train_multistep if k_steps > 1 else make_train_step
    return model, loss_fn, state, preprocess, make(model, loss_fn, preprocess)
