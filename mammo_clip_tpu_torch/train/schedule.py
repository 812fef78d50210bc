"""LR schedules (port of ``mammo_clip_tpu/train/schedule.py``).

``warmup_cosine_sq_schedule`` is the reference's per-step
LinearWarmupCosineAnnealingLR:

    step <  W:  lr * step / max(1, W)
    step >= W:  lr * cos((step - W) / (T - W) * pi/2)^2    (clamped at >= 0)

Total/warmup are in optimizer STEPS.
"""

from __future__ import annotations

import math
from typing import Callable


def schedule_horizon(epochs: int, warmup_epochs: int, steps_per_epoch: int,
                     grad_accum_steps: int = 1) -> tuple:
    """(total, warmup) in OPTIMIZER updates. With gradient accumulation the
    schedule advances once per k micro-steps, so the horizon is divided by k."""
    total = epochs * steps_per_epoch
    warmup = warmup_epochs * steps_per_epoch
    k = max(1, int(grad_accum_steps or 1))
    if k > 1:
        total = max(1, total // k)
        warmup = min(warmup // k, total - 1)
    return total, warmup


def warmup_cosine_sq_schedule(base_lr: float, total_steps: int,
                              warmup_steps: int) -> Callable[[int], float]:
    if warmup_steps >= total_steps:
        raise ValueError("warmup must be < total steps")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            mult = step / max(1, warmup_steps)
        else:
            frac = (step - warmup_steps) / (total_steps - warmup_steps)
            mult = math.cos(frac * (math.pi / 2.0)) ** 2
        return base_lr * max(mult, 0.0)

    return schedule
