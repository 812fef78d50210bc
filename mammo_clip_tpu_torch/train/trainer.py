"""The pretraining loop: epochs, validation, best-checkpoint selection, resume
(port of ``mammo_clip_tpu/train/trainer.py``).

Per-step scalars (loss sub-terms, LR, images/sec) go to MetricsLogger every
``train.log_every`` steps; per-epoch validation losses select the best
checkpoint by ``train.loss_best`` (reference trainer.py:215-237). Resume
restores the optimizer state, the EMA and the best validation loss so far;
a checkpoint flushed on SIGTERM resumes inside its epoch, skipping the batches
already trained. One process drives one device.

Under data parallelism (``core/mesh.py``: one process per card, each with its
rank's batches) the ranks start from rank 0's parameters and buffers, take the
same updates (``train/step.py``), validate on their own strided shards with
the losses averaged over the ranks, and agree after every step whether any of
them was sent SIGTERM, so that all flush the same checkpoint and return
together (a rank that stopped alone would leave the others waiting in a
collective). Rank 0 writes the checkpoints, ``best/``, the metrics and the
profiler trace (the JAX trainer's ``is_master()`` gates); every rank restores.

``warm_start_from`` seeds a flagship (``tpu_optimized``) run from a
reference-exact checkpoint, anything ``eval/loading.py`` loads (a port
``best/`` or run directory, or a reference ``.tar``), through
``convert/flagship_init.py``, after the state is built and before
``resume``; ``optimizer.warm_start_lr_scale`` scales the schedule's peak. The
seeded values are copied into the model's own tensors (the optimizer holds
them), and an EMA of the parameters starts from the seeded values. The JAX
trainer leaves its EMA at the fresh init (fault R9 of the reference, ROADMAP),
so there validation and ``best/`` judge unseeded weights.
"""

from __future__ import annotations

import math
import os
import signal
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..core import mesh
from ..core.config import Config
from ..losses import build_loss
from ..models import build_model
from ..ops.augment import AugmentConfig, augment_batch, augment_two_views
from ..utils.logging import MetricsLogger
from .checkpoint import restore_checkpoint, save_checkpoint
from .optim import build_optimizer
from .schedule import schedule_horizon, warmup_cosine_sq_schedule
from .state import create_train_state
from .step import make_eval_step, make_train_multistep, make_train_step

def make_clip_preprocess(cfg: Config) -> Callable:
    """On-device augmentation + normalization hook for the CLIP train step;
    ``generator=None`` normalizes only (eval)."""
    aug = AugmentConfig.from_dict(cfg.augment.to_dict())
    mean, std = cfg.data.mean, cfg.data.std
    out_bf16 = cfg.augment.get("out_bf16",
                               bool(cfg.model.image_encoder.get("tpu_optimized", False)))
    out_dtype = torch.bfloat16 if out_bf16 else None

    def preprocess(batch, generator):
        batch = dict(batch)
        if generator is None:
            for k in ("images", "image_views"):
                if k in batch:
                    batch[k] = augment_batch(batch[k], None, aug, mean, std, train=False)
            return batch
        if "image_views" in batch:
            batch["images"], batch["image_views"] = augment_two_views(
                batch["images"], batch["image_views"], generator, aug, mean, std, train=True,
                out_dtype=out_dtype)
        else:
            batch["images"] = augment_batch(batch["images"], generator, aug, mean, std,
                                            train=True, out_dtype=out_dtype)
        return batch

    return preprocess


def _say(text: str) -> None:
    """Print on rank 0 only (the one process without a process group)."""
    if mesh.is_master():
        print(text)


def _finite_or_none(x):
    """JSON-safe best-val: meta.json must stay standard JSON (no Infinity)."""
    x = float(x)
    return x if math.isfinite(x) else None


def _close(batches) -> None:
    """End a batch iterator early (stops a prefetch thread)."""
    close = getattr(batches, "close", None)
    if close is not None:
        close()


class Trainer:
    """Config-driven pretraining on one device.

    train_batches / valid_batches: callables (epoch) -> iterable of device
    batches (e.g. data.pipeline.Batcher with set_epoch + prefetch_to_device).
    The model's parameters are drawn from a generator seeded ``cfg.seed``.
    """

    def __init__(self, cfg: Config, workdir: str = "./outputs", device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.workdir = workdir
        # train.rng_impl picks the TPU's hardware RNG in the JAX package: no counterpart here
        dtype = torch.bfloat16 if cfg.train.get("dtype") == "bfloat16" else torch.float32
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.model = build_model(cfg.model.to_dict(), dtype=dtype, device=self.device,
                                 generator=gen)
        if mesh.world_size() > 1:  # every rank starts from rank 0's tensors
            with torch.no_grad():
                for t in [*self.model.parameters(), *self.model.buffers()]:
                    torch.distributed.broadcast(t.data, 0)
        self.loss_fn = build_loss(cfg.loss.to_dict())
        self.preprocess = make_clip_preprocess(cfg)
        self.logger = MetricsLogger(workdir, enabled=mesh.is_master())
        self._schedule = None

    def _build_state(self, steps_per_epoch: int, lr_scale: float = 1.0):
        cfg = self.cfg
        total, warmup = schedule_horizon(cfg.scheduler.epochs, cfg.scheduler.warmup_epochs,
                                         steps_per_epoch, cfg.optimizer.get("grad_accum_steps", 1))
        self._schedule = warmup_cosine_sq_schedule(cfg.optimizer.lr * lr_scale, total, warmup)
        opt = build_optimizer(cfg.optimizer.to_dict(), self._schedule,
                              self.model.named_parameters())
        return create_train_state(self.model, opt,
                                  ema_decay=cfg.optimizer.get("ema_decay", 0.0))

    def warm_start(self, state, source: str):
        """Seed the model from the reference-exact checkpoint at ``source`` in
        place (``convert/flagship_init.warm_start_state_dict``), and the EMA
        from the seeded parameters. Returns the state and the names of the
        tensors seeded (those the source also has; the rest keep their fresh init)."""
        from ..convert.flagship_init import warm_start_state_dict
        from ..eval.loading import load_clip_for_eval

        src, _ = load_clip_for_eval(source, device="cpu")
        source_state = src.state_dict()
        del src
        current = self.model.state_dict()
        seeded = warm_start_state_dict(source_state, current)
        self.model.load_state_dict(seeded)  # copy_ into the tensors the optimizer holds
        if state.ema is not None:
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    state.ema[name].copy_(p)
        return state, [k for k in current if k in source_state]

    def fit(self, train_batches: Callable[[int], Iterable],
            valid_batches: Optional[Callable[[int], Iterable]] = None,
            steps_per_epoch: Optional[int] = None, resume: bool = False,
            warm_start_from: Optional[str] = None):
        cfg = self.cfg
        epochs = cfg.scheduler.epochs
        # train.steps_per_call=K: K optimizer steps per call (make_train_multistep);
        # train_batches then yields stacked (K, B, ...) super-batches. The final
        # partial group of an epoch is dropped, and the schedule and the resume
        # arithmetic count the steps actually taken.
        K = int(cfg.train.get("steps_per_call", 1))
        if not steps_per_epoch:
            raise ValueError("steps_per_epoch required (len(batcher))")
        steps_per_epoch = steps_per_epoch - steps_per_epoch % K
        if steps_per_epoch == 0:
            raise ValueError(
                f"epoch has fewer batches than train.steps_per_call={K} — the "
                "fused call drops the final partial group, leaving zero steps; "
                "lower steps_per_call or raise the per-epoch batch count")
        # a seeded run takes a gentler peak LR (optimizer.warm_start_lr_scale)
        lr_scale = (float(cfg.optimizer.get("warm_start_lr_scale", 1.0))
                    if warm_start_from else 1.0)
        state = self._build_state(steps_per_epoch, lr_scale=lr_scale)
        if warm_start_from:
            state, names = self.warm_start(state, warm_start_from)
            n_all = len(self.model.state_dict())
            _say(f"warm-started from {warm_start_from}: {len(names)} of {n_all} tensors "
                 f"seeded, {n_all - len(names)} kept fresh")
        gen = torch.Generator(device=self.device)
        ckpt_dir, best_dir = f"{self.workdir}/checkpoints", f"{self.workdir}/best"
        start_epoch, skip_batches, best_val = 0, 0, np.inf
        if resume:
            try:
                state, _, meta = restore_checkpoint(ckpt_dir, state, generators={"step": gen})
            except FileNotFoundError:
                meta = None
            if meta is not None:
                start_epoch = int(meta.get("epoch", state.step // steps_per_epoch))
                if meta.get("preempted"):
                    # exact mid-epoch resume: the batch order is a pure function of
                    # the epoch and each step reseeds from the step count, so
                    # skipping the trained batches continues the epoch exactly
                    skip_batches = max(0, state.step - start_epoch * steps_per_epoch)
                    if skip_batches % K:
                        raise ValueError(
                            f"mid-epoch resume at step {state.step} is not aligned to "
                            f"train.steps_per_call={K}: the checkpoint was written under a "
                            "different steps_per_call, so the group skip would drop or "
                            "re-train batches — resume with the original value (or restart "
                            "the epoch by clearing the preempted flag)")
                # restore the best-so-far metric so the first post-resume epoch
                # cannot overwrite best/ with a worse checkpoint
                if meta.get("best_val") is not None:
                    best_val = float(meta["best_val"])
                _say(f"resumed from epoch {start_epoch} (step {state.step})"
                     + (f", skipping {skip_batches} trained batches" if skip_batches else ""))

        make = make_train_multistep if K > 1 else make_train_step
        train_step = make(self.model, self.loss_fn, preprocess=self.preprocess)
        eval_step = make_eval_step(self.model, self.loss_fn, preprocess=self.preprocess)
        loss_best_key = cfg.train.get("loss_best", "total")
        seed = cfg.seed + 1
        log_every = cfg.train.get("log_every", 30)
        accum = cfg.optimizer.get("grad_accum_steps", 1) or 1

        # train.profile_at_step=N records a torch.profiler trace of
        # train.profile_num_steps steps from global step N into workdir/profile
        prof_at = int(cfg.train.get("profile_at_step", -1))
        prof_len = int(cfg.train.get("profile_num_steps", 5))
        prof, prof_left = None, 0

        def stop_profile():
            nonlocal prof, prof_left
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            prof.stop()
            prof.export_chrome_trace(f"{self.workdir}/profile/trace_step{prof_at}.json")
            prof, prof_left = None, 0

        # preemption-safe checkpointing: SIGTERM sets a flag; the loop flushes a
        # checkpoint after the step in flight and returns
        preempted = {"flag": False}

        def _on_term(signum, frame):
            preempted["flag"] = True

        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:  # not the main thread
            prev_handler = None

        try:
            for epoch in range(start_epoch, epochs):
                t_epoch = time.time()
                n_imgs, last_t = 0, time.time()
                batches = train_batches(epoch)
                try:
                    for i, batch in enumerate(batches):
                        if epoch == start_epoch and i * K < skip_batches:
                            continue  # trained before the preemption
                        step_now = state.step
                        if (prof is None and prof_at >= 0 and step_now <= prof_at < step_now + K
                                and mesh.is_master()):
                            os.makedirs(f"{self.workdir}/profile", exist_ok=True)
                            acts = [torch.profiler.ProfilerActivity.CPU]
                            if self.device.type == "cuda":
                                acts.append(torch.profiler.ProfilerActivity.CUDA)
                            prof = torch.profiler.profile(activities=acts)
                            prof.start()
                            prof_left = -(-prof_len // K)  # whole calls
                        state, loss_dict = train_step(state, batch, gen, seed)
                        if prof is not None:
                            prof_left -= 1
                            if prof_left == 0:
                                stop_profile()
                        shape = batch["images"].shape  # this rank's; every rank's alike
                        # once a data group: a model group's ranks hold the same rows
                        n_imgs += (shape[0] * shape[1] if K > 1 else shape[0]) * mesh.data_size()
                        if mesh.any_rank(preempted["flag"], self.device):
                            if prof is not None:
                                stop_profile()
                            save_checkpoint(ckpt_dir, state, config=cfg.to_dict(),
                                            extra_meta={"epoch": epoch, "preempted": True,
                                                        "best_val": _finite_or_none(best_val)},
                                            generators={"step": gen})
                            _say(f"SIGTERM: checkpoint flushed at step {state.step}")
                            return state
                        if ((i + 1) * K) // log_every > (i * K) // log_every:
                            now = time.time()
                            scalars = {f"loss/{k}": float(v) for k, v in loss_dict.items()}
                            scalars["perf/images_per_sec"] = n_imgs / (now - last_t)
                            scalars["perf/lr"] = float(self._schedule(state.step // accum))
                            self.logger.log(state.step, scalars, prefix="train")
                            n_imgs, last_t = 0, now
                finally:
                    _close(batches)

                val_metrics: Dict[str, float] = {}
                if valid_batches is not None:
                    sums: Dict[str, list] = {}
                    vb = valid_batches(epoch)
                    try:
                        with state.eval_weights():
                            for batch in vb:
                                for k, v in eval_step(state, batch).items():
                                    sums.setdefault(k, []).append(float(v))
                    finally:
                        _close(vb)
                    val_metrics = mesh.mean_over_ranks(
                        {k: float(np.mean(v)) for k, v in sums.items()}, self.device)
                    self.logger.log(state.step, {f"loss/{k}": v for k, v in val_metrics.items()},
                                    prefix="valid")

                key = loss_best_key if loss_best_key in val_metrics else "total"
                # no validation data -> every epoch "improves" so a best/ always exists
                cur = val_metrics.get(key, -float(epoch + 1))
                if cur < best_val:
                    best_val = cur
                    save_checkpoint(best_dir, state, config=cfg.to_dict(),
                                    extra_meta={"epoch": epoch + 1, "val": val_metrics},
                                    max_to_keep=1, generators={"step": gen})
                # best_val first, so the resume checkpoint records it including this epoch
                save_checkpoint(ckpt_dir, state, config=cfg.to_dict(),
                                extra_meta={"epoch": epoch + 1, "val": val_metrics,
                                            "best_val": _finite_or_none(best_val)},
                                generators={"step": gen})
                _say(f"epoch {epoch + 1}/{epochs} done in {time.time() - t_epoch:.1f}s "
                     f"val={val_metrics.get(key, float('nan')):.4f} best={best_val:.4f}")
            if prof is not None:  # the window crossed the end of training
                stop_profile()
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            self.logger.close()
        return state
