"""What each gloo rank of the data-parallel tests runs (``tests/test_torch_parallel*.py``).

Every function takes ``(ctx, payload)``, where ``ctx`` is the rank's
``MeshContext``, and is run on N ranks by
``mammo_clip_tpu_torch.parallel.dryrun.run_ranks``; it returns numpy data that
the test, in the parent process, holds to the one-process and JAX results.
This module imports no JAX (a rank process has no JAX configured).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from mammo_clip_tpu_torch.core import mesh


def _np(t):
    return t.detach().float().cpu().numpy()


def gathered_loss(ctx, payload) -> dict:
    """``gathered_clip_loss`` and ``gathered_contrastive_clip_loss`` on this
    rank's rows of the global embeddings: the loss terms and the gradients of
    the total with respect to the rank's own rows."""
    from mammo_clip_tpu_torch.parallel.shard_loss import (gathered_clip_loss,
                                                          gathered_contrastive_clip_loss)

    b = payload["i1"].shape[0] // ctx.process_count
    rows = slice(ctx.rank * b, (ctx.rank + 1) * b)
    scale, smoothing = torch.tensor(payload["scale"]), payload["smoothing"]
    out = {}
    for name, keys in (("multi", ("i1", "t1", "i2", "t2")), ("single", ("i1", "t1"))):
        emb = {k: torch.tensor(payload[k][rows], requires_grad=True) for k in keys}
        if name == "multi":
            loss = gathered_clip_loss(emb["i1"], emb["t1"], scale, text_embeddings2=emb["t2"],
                                      image_view_embeddings=emb["i2"], label_smoothing=smoothing)
        else:
            loss = gathered_contrastive_clip_loss(emb["i1"], emb["t1"], scale,
                                                  label_smoothing=smoothing)
        loss["contrastive"].backward()
        out[name] = {"losses": {k: float(v) for k, v in loss.items()},
                     "grads": {k: _np(v.grad) for k, v in emb.items()}}
    return out


def fused_hook(ctx, payload) -> dict:
    """``plain_fused_mbconv_e6`` in both forms on this rank's rows with the
    cross-rank sum over a group of ``payload["ranks"]`` ranks (ranks past it
    return nothing): out, stats, dx and every parameter gradient of
    sum(out * w) over the rank's rows."""
    from mammo_clip_tpu_torch.core.mesh import RankSum
    from mammo_clip_tpu_torch.ops.mbconv import MBConvParams
    from mammo_clip_tpu_torch.ops.mbconv6 import MBConv6Params, plain_fused_mbconv_e6

    n = payload["ranks"]
    group = dist.new_group(list(range(n)))  # every rank joins the call
    if ctx.rank >= n:
        return {}
    out = {}
    for form, case in payload["cases"].items():
        cls = MBConv6Params if form == "e6" else MBConvParams
        b = case["x"].shape[0] // n
        rows = slice(ctx.rank * b, (ctx.rank + 1) * b)
        x = torch.tensor(case["x"][rows], requires_grad=True)
        p = cls(*[torch.tensor(case["params"][f], requires_grad=True) for f in cls._fields])
        y, stats = plain_fused_mbconv_e6(x, p, torch.tensor(case["delta"][rows]), case["vh"],
                                         case["vw"], rank_sum=RankSum(group))
        (y * torch.tensor(case["w"][rows])).sum().backward()
        out[form] = {"out": _np(y), "stats": [_np(s) for s in stats], "dx": _np(x.grad),
                     "grads": {f: _np(t.grad) for f, t in zip(cls._fields, p)}}
    return out


def draws(ctx, payload) -> dict:
    """What this rank's step draws from its generator at step 0: the
    augmentation of a fixed batch and a drop-connect scale, after the train
    step's reseed from (seed, step, data index)."""
    from mammo_clip_tpu_torch.core.config import Config
    from mammo_clip_tpu_torch.ops.stochastic import drop_delta
    from mammo_clip_tpu_torch.train.step import step_seed
    from mammo_clip_tpu_torch.train.trainer import make_clip_preprocess

    cfg = Config(payload["cfg"])
    gen = torch.Generator().manual_seed(step_seed(payload["seed"], 0, mesh.data_index()))
    batch = make_clip_preprocess(cfg)({k: torch.tensor(v) for k, v in payload["batch"].items()},
                                      gen)
    return {"images": _np(batch["images"]), "views": _np(batch["image_views"]),
            "delta": _np(drop_delta(16, 0.5, gen, "cpu"))}


def tp_checkpoint(ctx, payload) -> dict:
    """A TP + FSDP state (``payload["steps"]``'s layout) after one step, saved
    with ``save_checkpoint`` into ``payload["dir"]`` and restored into a fresh
    placement of the initial state: the digests of the whole parameters,
    buffers, EMA and moments before the save and after the restore, the step,
    and the shapes this rank holds."""
    from mammo_clip_tpu_torch.core.config import Config
    from mammo_clip_tpu_torch.parallel import dryrun
    from mammo_clip_tpu_torch.parallel.partitioning import full_like, full_tensors
    from mammo_clip_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from mammo_clip_tpu_torch.train.step import make_train_step

    steps = payload["steps"]
    cfg = Config(steps["cfg"])
    ctx = mesh.MeshContext.create(**steps["mesh"], device=ctx.device)

    def digests(state):
        params = state.model.named_parameters()
        moments = {f"{n}.{k}": full_like(p, v) for n, p in params
                   for k, v in state.optimizer.inner.state.get(p, {}).items() if v.dim()}
        return {"model": dryrun._digest(full_tensors(dict(state.model.named_parameters()))),
                "buffers": dryrun._digest(full_tensors(dict(state.model.named_buffers()))),
                "ema": dryrun._digest(full_tensors(state.ema)),
                "moments": dryrun._digest(moments)}

    model, state, loss_fn, pre = dryrun._build(cfg, ctx.device, steps["init"], steps["shard"])
    step = make_train_step(model, loss_fn, pre)
    state, _ = step(state, dryrun._rows(ctx, steps["batches"][0], ctx.device),
                    torch.Generator(), cfg.seed)
    saved = digests(state)
    save_checkpoint(payload["dir"], state, config=cfg.to_dict())
    held = {n: tuple(p.shape) for n, p in model.named_parameters()}
    _, fresh, _, _ = dryrun._build(cfg, ctx.device, steps["init"], steps["shard"])
    fresh, _, _ = restore_checkpoint(payload["dir"], fresh)
    return {"saved": saved, "restored": digests(fresh), "step": fresh.step, "held": held}


def sp_steps(ctx, payload) -> dict:
    """``dryrun.steps_case`` of the sequence-parallel layout, with the
    row splits' reduce-scatters over the sequence counted (``seq_scatters``:
    0 would mean the text tower never ran on sequence shards)."""
    from mammo_clip_tpu_torch.models import bert
    from mammo_clip_tpu_torch.parallel.dryrun import steps_case

    real, calls = bert.reduce_scatter_to_seq, []

    def counted(y, axis, dim=1):
        calls.append(axis is not None)
        return real(y, axis, dim)

    bert.reduce_scatter_to_seq = counted
    try:
        out = steps_case(ctx, payload)
    finally:
        bert.reduce_scatter_to_seq = real
    out["seq_scatters"] = sum(calls)
    return out


def parity(ctx, payload) -> dict:
    """The parity file's ranks, spawned once: the data-parallel train steps
    (``dryrun.steps_case``), the gathered loss, the fused block's hook on a
    2-rank group and the ranks' draws; then on (data 2, model 2) the TP + FSDP
    steps, the data-parallel steps of 2 data ranks with whole parameters
    (the model ranks replicas), the draws again, the TP + FSDP checkpoint
    round trip and the sequence-parallel steps; then the text tower
    pipelined over 4 stages (``dryrun.pp_case``, point-to-point over gloo)."""
    from mammo_clip_tpu_torch.parallel.dryrun import pp_case, steps_case

    out = {"steps": steps_case(ctx, payload["steps"]),
           "loss": gathered_loss(ctx, payload["loss"]),
           "fused": fused_hook(ctx, payload["fused"]),
           "draws": draws(ctx, payload["draws"])}
    out["tp"] = steps_case(ctx, payload["tp"])
    out["dp2"] = steps_case(ctx, payload["dp2"])
    out["draws_2x2"] = draws(ctx, payload["draws"])  # under dp2's (data 2, model 2) layout
    out["checkpoint"] = tp_checkpoint(ctx, payload["checkpoint"])
    out["sp"] = sp_steps(ctx, payload["sp"])
    out["pp"] = pp_case(ctx, payload["pp"])
    return out


def cli(ctx, payload) -> dict:
    """``cli/pretrain`` on every rank: run A is sent SIGTERM on rank 1 alone
    during its first step, then resumed with ``--resume``; run B runs straight
    through. The steps each call ended at, the state digests and the EMA's."""
    import signal

    from mammo_clip_tpu_torch.cli import pretrain
    from mammo_clip_tpu_torch.parallel.dryrun import _digest

    real = pretrain.prefetch_to_device

    def term_on_rank_1(batches, *a, **k):
        for i, b in enumerate(real(batches, *a, **k)):
            if i == 0 and k.get("stacked") is not None and ctx.rank == 1:
                signal.raise_signal(signal.SIGTERM)
            yield b

    out = {"rank": ctx.rank}
    for name, calls in (("a", (term_on_rank_1, real)), ("b", (real,))):
        flags = ["--workdir", os.path.join(payload["tmp"], name), "--device", "cpu"]
        steps = []
        for i, prefetch in enumerate(calls):
            pretrain.prefetch_to_device = prefetch
            try:
                state = pretrain.main(flags + (["--resume"] if i else []) + payload["overrides"])
            finally:
                pretrain.prefetch_to_device = real
            steps.append(state.step)
        out[name] = {"steps": steps, "digest": _digest(state.model.state_dict()),
                     "ema": _digest(state.ema), "opt_count": state.optimizer.count}
    return out
