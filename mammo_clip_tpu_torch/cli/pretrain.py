"""Pretraining CLI (port of ``mammo_clip_tpu/cli/pretrain.py``).

    python -m mammo_clip_tpu_torch.cli.pretrain [--config cfg.yaml] \
        [--workdir outputs/pretrain] [--resume] [--warm-start-from CKPT] \
        [--device cuda] [key.path=value ...]

The flags and dotted overrides are the JAX CLI's, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain versions of the kernels). One process trains
on one device. On N cards, one process per card:

    python -m torch.distributed.run --nproc-per-node N \
        -m mammo_clip_tpu_torch.cli.pretrain [same arguments]

Each process reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
and ``MASTER_PORT`` (``core/mesh.py``), joins the process group (NCCL on
``cuda:LOCAL_RANK``; gloo with ``--device cpu``) and trains its strided
shard: the global batch is ``data.batch_size_per_device`` times the data
ranks (the JAX CLI passes ``global_batch_size`` as each process's Batcher
size, so with P processes its global batch would be P times that: fault R11
of the reference, not inherited). The config's ``mesh`` key is read as in JAX
(``mesh.data=-1`` takes what ``mesh.model`` and ``mesh.replica`` leave). As
JAX's trainer never calls ``shard_train_state``, ``mesh.model`` > 1 keeps the
parameters whole here too: the ranks of a model group take the same rows and
the same steps; tensor parallelism and ZeRO-3 are reached through
``parallel/partitioning.py::shard_train_state``. Without
``--config`` the run starts from the default config of ``--variant``; reading
a YAML config needs PyYAML, the defaults and the overrides do not (an
override's value is parsed as YAML when PyYAML is present, else as JSON, so
JSON values read the same everywhere). The run's config is written to
``<workdir>/config.json``. ``--warm-start-from`` seeds a flagship run
(``model.image_encoder.tpu_optimized=true``) from a reference-exact
checkpoint: a port ``best/`` or run directory, or a reference ``.tar``
(``train/trainer.py``).
"""

from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from ..core.config import default_pretrain_config, load_config
from ..core.mesh import MeshContext, is_master
from ..data.datamodule import DataModule
from ..data.pipeline import group_batches, prefetch_to_device, stack_batches
from ..train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description="Mammo-CLIP pretraining, one process per device")
    ap.add_argument("--config", default=None, help="YAML config; defaults to the b5 recipe")
    ap.add_argument("--variant", default="b5", choices=["b2", "b5"])
    ap.add_argument("--workdir", default="outputs/pretrain")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--warm-start-from", default=None,
                    help="a reference-exact checkpoint (a port best/ or run dir, or a "
                    "reference .tar) to seed a tpu_optimized run from "
                    "(convert/flagship_init; deep stages and text tower copied, "
                    "space-to-depth front fresh)")
    ap.add_argument("--fold", type=int, default=0)
    ap.add_argument("--data-frac", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("overrides", nargs="*", help="dotted-path config overrides (a.b=c)")
    args = ap.parse_args(argv)

    cfg = load_config(args.config) if args.config else default_pretrain_config(args.variant)
    if args.overrides:
        cfg = cfg.apply_overrides(args.overrides)

    joined = not dist.is_initialized()
    ctx = MeshContext.create(**dict(cfg.get("mesh", {})), device=args.device)
    try:
        return _train(cfg, args, ctx)
    finally:
        if joined:
            ctx.close()


def _train(cfg, args, ctx: MeshContext):
    dm = DataModule(cfg, cur_fold=args.fold, data_frac=args.data_frac,
                    process_index=ctx.data_index, process_count=ctx.process_count)
    batch_size = cfg.data.batch_size_per_device  # this rank's rows a step
    train_b = dm.batcher("train", batch_size=batch_size)
    valid_b = dm.batcher("valid", batch_size=batch_size) if cfg.data.get("valid") else None
    if is_master():
        os.makedirs(args.workdir, exist_ok=True)
        with open(os.path.join(args.workdir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    k_steps = int(cfg.train.get("steps_per_call", 1))

    def train_batches(epoch):
        train_b.set_epoch(epoch)
        it = iter(train_b)
        if k_steps > 1:
            it = (stack_batches(g) for g in group_batches(it, k_steps))
        return prefetch_to_device(it, ctx.device, stacked=k_steps > 1)

    valid_batches = None
    if valid_b is not None:
        def valid_batches(epoch):  # noqa: F811
            return prefetch_to_device(iter(valid_b), ctx.device)

    trainer = Trainer(cfg, workdir=args.workdir, device=ctx.device)
    return trainer.fit(train_batches, valid_batches, steps_per_epoch=len(train_b),
                       resume=args.resume, warm_start_from=args.warm_start_from)


if __name__ == "__main__":
    main()
