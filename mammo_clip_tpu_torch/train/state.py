"""Training state (port of ``mammo_clip_tpu/train/state.py``).

The JAX TrainState is an immutable pytree of (step, params, batch_stats,
opt_state, ema_params). Here the model module owns its parameters and its
BatchNorm running statistics (buffers), and the optimizer owns its moments; the
state ties them together with the step count (micro-steps, under gradient
accumulation) and an optional exponential moving average of the parameters,
and is updated in place.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch

from .optim import Optimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None  # parameter name -> EMA, fp32
    ema_decay: float = 0.0
    _swapped: bool = dataclasses.field(default=False, repr=False)

    @torch.no_grad()
    def apply_gradients(self) -> "TrainState":
        """One optimizer micro-step from the gradients on the parameters, then the
        EMA blend ``ema = d * ema + (1 - d) * param``. Under gradient accumulation
        the parameters change only on the micro-step that completes a group;
        the blend is frozen on the others (state.py:34-45 of the JAX package),
        so the EMA horizon does not shrink to decay**k."""
        self.optimizer.step()
        self.step += 1
        if self.ema is not None and self.optimizer.mini_step == 0:
            for name, p in self.model.named_parameters():
                e = self.ema[name]
                d = torch.tensor(self.ema_decay, dtype=torch.float32, device=e.device)
                e.copy_(d * e + (1.0 - d) * p)
        return self

    @contextlib.contextmanager
    def eval_weights(self):
        """Evaluate with the EMA weights when they are tracked (the JAX state's
        ``eval_variables``): swap them into the model, and back on exit. Nested
        uses swap once."""
        if self.ema is None or self._swapped:
            yield
            return
        params = dict(self.model.named_parameters())
        saved = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(self.ema[n])
        self._swapped = True
        try:
            yield
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(saved[n])
            self._swapped = False


def create_train_state(model: torch.nn.Module, optimizer: Optimizer,
                       ema_decay: float = 0.0) -> TrainState:
    """``ema_decay > 0`` also tracks an EMA of the parameters, seeded with them."""
    ema = None
    if ema_decay > 0:
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(model=model, optimizer=optimizer, ema=ema, ema_decay=ema_decay)
