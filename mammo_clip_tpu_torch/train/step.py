"""The train and eval steps (port of ``mammo_clip_tpu/train/step.py``).

One step: (optional) on-device augmentation -> dual-encoder forward in train
mode (updating the BatchNorm running statistics) -> loss -> backward -> AdamW
update. Randomness (augmentation, dropout, drop-connect) is drawn in that
order from the ``torch.Generator`` the caller passes. Given a ``seed``, the
step first reseeds that generator from (seed, state.step), as the JAX step
folds the step count into its key: a step's draws then depend only on the seed
and the step, which makes K fused steps equal to K single ones and a resumed
run equal to an uninterrupted one.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .state import TrainState


def step_seed(seed: int, step: int) -> int:
    """The generator seed of step ``step`` of a run seeded ``seed``."""
    return (seed * 1_000_003 + step) % (2**63)


def make_train_step(model, loss_fn: Callable, preprocess: Optional[Callable] = None):
    """Returns ``step(state, batch, generator, seed=None) -> (state, loss_dict)``;
    the loss dict holds detached scalars."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator,
             seed: Optional[int] = None):
        if seed is not None:
            generator.manual_seed(step_seed(seed, state.step))
        if preprocess is not None:
            batch = preprocess(batch, generator)
        outputs = model(batch, train=True, generator=generator)
        loss_dict = loss_fn(outputs, batch, True)
        loss_dict["total"].backward()
        state.apply_gradients()
        return state, {k: v.detach() for k, v in loss_dict.items()}

    return step


def make_train_multistep(model, loss_fn: Callable, preprocess: Optional[Callable] = None):
    """K steps in one call: ``step(state, batches, generator, seed=None)`` where
    every leaf of ``batches`` carries a leading steps axis K
    (``data.pipeline.stack_batches``). A loop over the single-step body, so it
    equals K single steps; returns the last step's loss dict."""
    single = make_train_step(model, loss_fn, preprocess)

    def step(state: TrainState, batches: Dict[str, torch.Tensor], generator: torch.Generator,
             seed: Optional[int] = None):
        k_steps = next(iter(batches.values())).shape[0]
        loss_dict = None
        for k in range(k_steps):
            state, loss_dict = single(state, {n: v[k] for n, v in batches.items()}, generator,
                                      seed)
        return state, loss_dict

    return step


def make_eval_step(model, loss_fn: Callable, preprocess: Optional[Callable] = None):
    """Validation-loss step (reference: trainer.py:322-381), deterministic. It
    judges the EMA weights when the state tracks them (the weights that would
    be served), with the BatchNorm running statistics."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        b = preprocess(batch, None) if preprocess is not None else batch
        with torch.no_grad(), state.eval_weights():
            outputs = model(b, train=False)
            return {k: v.detach() for k, v in loss_fn(outputs, b, False).items()}

    return step
