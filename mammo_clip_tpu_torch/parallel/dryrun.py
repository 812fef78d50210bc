"""N ranks equal one process (port of ``__graft_entry__.py::dryrun_multichip``,
:82-260: its data-parallel, TP + FSDP, sequence-parallel and pipeline parts).

    python -m mammo_clip_tpu_torch.parallel.dryrun [--ranks N] [--device cuda|cpu]
        [--timeout 600] [--layout dp tp sp pp] (dp tp by default)

runs ``steps_case`` on N ranks, each a process of its own under ``python -m
torch.distributed.run --standalone`` (``run_ranks``: NCCL with one card a
rank, every visible card by default; gloo with ``--device cpu``, 4 ranks by
default), and again in this process on the same global batch, then compares
(``compare``): the losses, the step's gradients after the ranks' average,
and after one step and after one K=2 call (``make_train_multistep``, which
the one process also checks against two single steps) every parameter, the
BatchNorm running statistics and the EMA, every shard gathered whole; and
that every rank ends with the same bits. Four layouts (``layout_cases``):
``dp``, N data ranks on N x B rows; ``tp``, the JAX dry run's data N/2 x
model 2 with the state placed by ``parallel/partitioning.py::
shard_train_state(fsdp=True)`` (Megatron splits of BERT and the eligible
MBConv blocks over ``model``, ZeRO-3 over ``data``) on N/2 x B rows, for an
even N; ``sp``, the same with ``text_encoder.seq_parallel`` (JAX's r5 step:
BERT's LayerNorm and residual regions on sequence shards over ``model``),
also held to the ``tp`` case's loss when both run; ``pp`` (``pp_case``), the
text tower pipelined over 4 stages (N / 4 data ranks when 4 divides N, else
one pipe of N stages) against the sequential tower on the same rows, the
hidden states and the gradients of every layer and of the embeddings. It
prints one JSON line of the largest differences and exits 1 when one is
over its tolerance. Any N >= 1 runs (the JAX dry run reshapes its devices
to (2, 4) and crashes below 8: fault R1 of the reference, not inherited);
with one rank no process group is made, no collective runs and no ``tp`` or
``sp`` case is made.

The stochastic parts are off on both sides (augmentation, drop-connect,
dropout), since rank r folds r into its step seed (``train/step.py``), and
every fp32 product runs in full fp32 (``utils/device.py::full_fp32``: cuDNN
takes TF32 by default, and a rank process would not inherit a caller's
switch). On the CPU the model is the tiny CLIP (b0 at 64x64, 2-layer BERT) in
fp32 at 2 rows a rank. On the card it is the compat recipe (B5 at 1520x912,
BERT-base, 256 tokens, the fused route and remat) at 2 rows a card, run twice:
in fp32 activations, where the gradients are held too, and in the recipe's
bf16, where they are not (``TOLERANCES``); tensors are compared on a fixed
sample of up to 1024 elements each, and ``self_noise`` reports beside each
what one process differs from itself by.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import importlib
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import mesh
from ..core.config import Config
from ..utils.device import full_fp32

ROOT = Path(__file__).resolve().parent.parent.parent
SAMPLE = 1024  # elements a tensor keeps in a sampled snapshot


# ----------------------------------------------------------------------------
# ranks as processes
# ----------------------------------------------------------------------------


def run_ranks(n: int, target: str, payload, device: str = "cuda",
              timeout_s: float = 600.0) -> List:
    """Run ``fn(ctx, payload)`` on ``n`` ranks, one process each, and return the
    ranks' results in rank order. ``target`` is ``"package.module:fn"`` or
    ``"path/to/file.py:fn"``; ``ctx`` is the rank's ``MeshContext`` on
    ``device`` (NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU). The ranks are
    started by ``python -m torch.distributed.run --standalone``, whose
    rendezvous binds its own free port; when one fails the launcher stops the
    others, and when ``timeout_s`` passes it is sent SIGTERM, which it passes
    on to the ranks. The error carries the tail of the ranks' output."""
    tmp = Path(tempfile.mkdtemp(prefix="dryrun_ranks_"))
    try:
        torch.save(payload, tmp / "payload.pt")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={n}", "-m", "mammo_clip_tpu_torch.parallel.dryrun",
               "--rank-worker", target, str(tmp), device]
        proc = subprocess.Popen(cmd, cwd=str(ROOT), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            log = proc.communicate(timeout=timeout_s)[0]
        except subprocess.TimeoutExpired:
            proc.terminate()
            try:
                proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
            raise RuntimeError(f"{n} ranks of {target} did not finish in {timeout_s:.0f} s")
        if proc.returncode != 0:
            raise RuntimeError(f"{n} ranks of {target} failed ({proc.returncode}):\n"
                               f"{log[-6000:]}")
        return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _resolve(target: str):
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(where).stem, where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _rank_worker(target: str, tmp: str, device: str) -> None:
    payload = torch.load(Path(tmp) / "payload.pt", weights_only=False)
    ctx = mesh.MeshContext.create(**payload.get("mesh", {}), device=device,
                                  timeout_s=payload.get("timeout_s", 300.0))
    if ctx.device.type == "cpu":
        torch.set_num_threads(1)
    try:
        out = _resolve(target)(ctx, payload)
        torch.save(out, Path(tmp) / f"rank{ctx.rank}.pt")
    finally:
        ctx.close()


# ----------------------------------------------------------------------------
# the steps, on a rank or in one process
# ----------------------------------------------------------------------------


def _digest(tensors: Dict[str, torch.Tensor]) -> str:
    h = hashlib.sha1()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _snap(tensors: Dict[str, torch.Tensor], sample: bool) -> Dict[str, np.ndarray]:
    """fp32 numpy copies, or a fixed sample of up to ``SAMPLE`` elements each."""
    out = {}
    for k, t in tensors.items():
        flat = t.detach().float().reshape(-1)
        if sample and flat.numel() > SAMPLE:
            idx = np.random.default_rng(zlib.crc32(k.encode())).choice(
                flat.numel(), SAMPLE, replace=False)
            flat = flat[torch.as_tensor(np.sort(idx), device=flat.device)]
        out[k] = flat.cpu().numpy().copy()  # never a view of a tensor updated later
    return out


def _state_snap(state, sample: bool) -> dict:
    """The parameters, buffers and EMA, each shard gathered whole
    (``parallel/partitioning.py``; every rank takes part), as snapshots and
    one digest."""
    from .partitioning import full_tensors

    params = full_tensors(dict(state.model.named_parameters()))
    buffers = full_tensors(dict(state.model.named_buffers()))
    ema = full_tensors(state.ema or {})
    return {"step": state.step, "params": _snap(params, sample),
            "buffers": _snap(buffers, sample), "ema": _snap(ema, sample),
            "digest": _digest({**params, **{f"buffer.{k}": v for k, v in buffers.items()},
                               **{f"ema.{k}": v for k, v in ema.items()}}),
            "digests": {"params": _digest(params), "buffers": _digest(buffers),
                        "ema": _digest(ema)}}


def _build(cfg: Config, device, init: Optional[dict], shard: Optional[dict] = None):
    """The model, its train state and the preprocess (normalisation only), the
    state placed on the mesh by ``shard_train_state(state, **shard)`` when
    ``shard`` is given. The last build's state is freed first: the gradient
    recorder of ``_one_step`` makes a reference cycle, which only the
    collector breaks."""
    from ..losses import build_loss
    from ..models import build_model
    from ..train.optim import build_optimizer
    from ..train.schedule import warmup_cosine_sq_schedule
    from ..train.state import create_train_state
    from ..train.trainer import make_clip_preprocess

    gc.collect()
    dtype = torch.bfloat16 if cfg.train.get("dtype") == "bfloat16" else torch.float32
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    model = build_model(cfg.model.to_dict(), dtype=dtype, device=device, generator=gen)
    if init is not None:
        model.load_state_dict(init)
    if mesh.world_size() > 1:  # as the trainer does: every rank starts from rank 0's
        with torch.no_grad():
            for t in [*model.parameters(), *model.buffers()]:
                torch.distributed.broadcast(t.data, 0)
    schedule = warmup_cosine_sq_schedule(cfg.optimizer.lr, 100, 0)
    opt = build_optimizer(cfg.optimizer.to_dict(), schedule, model.named_parameters())
    state = create_train_state(model, opt, ema_decay=cfg.optimizer.get("ema_decay", 0.0))
    if shard is not None:
        from .partitioning import shard_train_state

        shard_train_state(state, **shard)
    norm = make_clip_preprocess(cfg)
    return model, state, build_loss(cfg.loss.to_dict()), (lambda b, g: norm(b, None))


def _rows(ctx, batch, device, stacked=False):
    """This rank's rows of a global host batch on ``device`` (all rows in one process)."""
    if ctx is not None and ctx.process_count > 1:
        return ctx.shard_host_batch(batch, stacked=stacked)
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).long() if v.dtype == np.int32
                else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


def steps_case(ctx, payload) -> dict:
    """One train step, then one K=2 call from the same initial state, on this
    rank's rows of ``payload["batches"]`` (two global host batches), or on all
    of them with ``ctx`` None or one rank (the one process, which also takes
    the two batches as two single steps unless ``payload["two_steps"]`` is
    false). On ranks, ``payload["mesh"]`` lays them out (``MeshContext``:
    the data-parallel world by default) and ``payload["shard"]`` places the
    state with ``shard_train_state`` (tensor parallelism over ``model``,
    ``fsdp``). Returns the losses, the step's averaged gradients (and the
    fused kernel's launches in it) and snapshots of the state after each,
    every shard gathered whole."""
    from ..train.step import make_train_multistep, make_train_step

    cfg = Config(payload["cfg"])
    if ctx is not None:  # this case's layout of the ranks (the DP world by default)
        ctx = mesh.MeshContext.create(**payload.get("mesh", {}), device=ctx.device)
    device = ctx.device if ctx is not None else torch.device(payload.get("device", "cpu"))
    sample = bool(payload.get("sample", False))
    init = payload.get("init")
    shard = payload.get("shard") if ctx is not None else None
    batches = payload["batches"]
    out = {"rank": mesh.rank(), "ranks": mesh.world_size()}
    with full_fp32():
        out["one"] = _one_step(cfg, device, init, _rows(ctx, batches[0], device), sample, shard)
        model, state, loss_fn, pre = _build(cfg, device, init, shard)
        stacked = {k: np.stack([batches[0][k], batches[1][k]]) for k in batches[0]}
        multi = make_train_multistep(model, loss_fn, pre)
        state, losses = multi(state, _rows(ctx, stacked, device, stacked=True),
                              torch.Generator(device=device), cfg.seed)
        out["k2"] = {"losses": {k: float(v) for k, v in losses.items()},
                     **_state_snap(state, sample)}
        del model, state, multi
        if mesh.world_size() == 1 and payload.get("two_steps", True):
            model, state, loss_fn, pre = _build(cfg, device, init)
            step = make_train_step(model, loss_fn, pre)
            for b in batches:
                state, losses = step(state, _rows(None, b, device),
                                     torch.Generator(device=device), cfg.seed)
            out["two"] = {"losses": {k: float(v) for k, v in losses.items()},
                          **_state_snap(state, sample)}
    return out


def _one_step(cfg: Config, device, init, rows, sample: bool, shard=None) -> dict:
    """One train step on ``rows`` (this rank's, on the device): the losses, the
    gradients the optimizer takes (after the ranks' average, each shard
    gathered whole), the fused kernel's launches, the state after it, the
    step's seconds and its peak device memory (bytes; None on the CPU)."""
    from ..ops.mbconv import launches
    from ..train.step import make_train_step
    from .partitioning import full_tensors

    model, state, loss_fn, pre = _build(cfg, device, init, shard)
    grads = {}
    apply = state.apply_gradients

    def recording():  # the gradients the optimizer is about to take, after the average
        if not grads:
            params = dict(model.named_parameters())
            grads.update(_snap(full_tensors({n: p.grad for n, p in params.items()
                                             if p.grad is not None}, like=params), sample))
        return apply()

    state.apply_gradients = recording
    step = make_train_step(model, loss_fn, pre)
    launches.reset()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    state, losses = step(state, rows, torch.Generator(device=device), cfg.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    out = {"losses": {k: float(v) for k, v in losses.items()}, "grads": grads,
           "fused": dict(launches.counts), "seconds": seconds, "peak_bytes": peak,
           **_state_snap(state, sample)}
    return out


def self_noise(payload, one: dict) -> dict:
    """One process against itself: its first step and its K=2 call (``one``,
    from ``steps_case``) taken again with the global batches' rows reversed,
    and its first step again on the unfused blocks (cuDNN's convolutions and
    autograd's BatchNorm). Either is as right as the first, so what they
    differ by is the floor below which no check of the ranks can go: per run,
    ``compare``'s terms (``k2`` too for the reversed rows) and the five
    tensors whose gradients moved most (relative, as ``grad_diffs``)."""
    device = torch.device(payload.get("device", "cpu"))
    sample = bool(payload.get("sample", False))
    batch = payload["batches"][0]
    unfused = Config(payload["cfg"])
    unfused.model.image_encoder.fused_mbconv = False
    reversed_rows = [{k: np.ascontiguousarray(v[::-1]) for k, v in b.items()}
                     for b in payload["batches"]]
    rev = steps_case(None, {**payload, "batches": reversed_rows, "two_steps": False})
    runs = {"reversed": rev["one"]}
    with full_fp32():
        runs["unfused"] = _one_step(unfused, device, payload.get("init"),
                                    _rows(None, batch, device), sample)
    out = {}
    for name, run in runs.items():
        rel = grad_rel(run["grads"], one["one"]["grads"])
        _, scale = grad_diffs(run["grads"], one["one"]["grads"])
        out[name] = {**_state_diffs(run, one["one"]), "grad_rel": max(rel.values()),
                     "grad_scale": scale,
                     "worst": sorted(rel.items(), key=lambda kv: -kv[1])[:5]}
    out["reversed"]["k2"] = _state_diffs(rev["k2"], one["k2"])
    return out


# ----------------------------------------------------------------------------
# the comparison
# ----------------------------------------------------------------------------

# loss: relative; state: absolute on parameters and EMA; buffers: absolute on
# the BatchNorm running statistics; grad: per tensor, relative to its norm plus
# a floor (``grad_diffs``); scale: the gradients' least-squares scale off 1;
# None: not checked. The full-width limits stand beside one process's own
# noise (``self_noise``) on an H100 at one card's batch of 2. fp32, TF32 off
# (rows reversed / unfused): loss 2.0e-6 / 5.0e-6, parameters 8.1e-7 / 1.2e-6,
# statistics 1.2e-6 / 2.3e-6, gradients 5.8e-4 / 6.7e-4 per tensor, scale
# 0.999991 / 0.999977. bf16: loss 1.2e-3 / 7.1e-3, parameters 9.6e-5 / 9.8e-5,
# statistics 1.8e-3 / 4.4e-3, gradients 0.26 / 1.45 per tensor (the bn2
# biases, whose true gradient is ~0, and the SE biases), scale 1.011 / 0.938:
# there the gradients are not held (the fp32 run holds them); loss and
# statistics are held at 10x the reversed rows' noise, parameters and EMA at
# 2x theirs, which is also about the 2 lr by which one AdamW step (eps 1e-3)
# can move an element at most, so in bf16 the parameters only bound the update.
#
# noise: the ranks' step and K=2 call are held, term by term (loss,
# parameters, EMA, statistics), at the larger of these tolerances and this
# many times one process's own noise in that term on the same rows
# (``self_noise``'s reversed rows), when ``compare`` is given that reading
# (None: at the tolerances). No check of the ranks can go below what one
# process differs from itself by; on few rows (BatchNorm over them, one AdamW
# step with eps 1e-3 after it) that can exceed the tolerances. On the CPU,
# tiny CLIP: at two data ranks (4 rows of the dry run's own batches) one
# process's K=2 loss moves 7.4e-6 with its rows reversed, and the ranks read
# 1.19e-5 (data 2) and 1.23e-5 (data 2 x model 2), their first step's state
# and gradients inside that process's own noise: the K=2 loss's limit there
# is 1.48e-5. On 2 rows (data 1 x model 2) one process's own step loss moves
# 3.6e-5 and its K=2 parameters 1.1e-6; the ranks read 2.6e-5 and 1.0e-6. At
# four data ranks (8 rows) every limit stays at its tolerance. bf16's are
# already set from its noise.
TOLERANCES = {"tiny": {"loss": 1e-5, "state": 1e-6, "buffers": 1e-4, "grad": 1e-4,
                       "scale": 1e-4, "noise": 2.0},
              "full_width": {"loss": 1e-5, "state": 1e-5, "buffers": 2e-5, "grad": 1e-2,
                             "scale": 1e-3, "noise": 2.0},
              "full_width_bf16": {"loss": 1e-2, "state": 2e-4, "buffers": 2e-2, "grad": None,
                                  "scale": None, "noise": None}}


def _max_diff(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> float:
    if set(a) != set(b):
        raise ValueError(f"different tensors: {sorted(set(a) ^ set(b))[:5]}")
    return max((float(np.max(np.abs(a[k] - b[k]))) for k in a if a[k].size), default=0.0)


def grad_rel(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Per tensor, ||a - b|| / (||b|| + floor). The floor, 1e-2 of the
    gradients' root-mean-square tensor norm, keeps tensors whose true gradient
    is 0 (a bias feeding a BatchNorm) from dividing rounding noise by rounding
    noise."""
    if set(a) != set(b):
        raise ValueError(f"different gradients: {sorted(set(a) ^ set(b))[:5]}")
    norms = {k: float(np.linalg.norm(b[k])) for k in b}
    floor = 1e-2 * float(np.sqrt(np.mean([n * n for n in norms.values()])))
    return {k: float(np.linalg.norm(a[k] - b[k])) / (norms[k] + floor) for k in b}


def grad_diffs(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> tuple:
    """(the largest ``grad_rel``, the least-squares scale of a on b over every
    tensor). The scale is 1 when the ranks' gradients are neither W times too
    large nor too small."""
    rel = grad_rel(a, b)
    dot = sum(float(np.dot(a[k].astype(np.float64), b[k])) for k in b)
    return max(rel.values()), dot / sum(float(np.dot(b[k], b[k])) for k in b)


def _state_diffs(x: dict, y: dict) -> dict:
    return {"loss": max(abs(x["losses"][k] - y["losses"][k]) / max(1.0, abs(y["losses"][k]))
                        for k in y["losses"]),
            "params": _max_diff(x["params"], y["params"]),
            "buffers": _max_diff(x["buffers"], y["buffers"]),
            "ema": _max_diff(x["ema"], y["ema"])}


def compare(ranks: List[dict], one: dict, size: str = "tiny",
            noise: Optional[dict] = None) -> dict:
    """The largest differences between the ranks' runs and the one process's,
    each beside its limit (``limits``), and ``ok``. The limits are
    ``TOLERANCES[size]``, each term of the step and of the K=2 call raised to
    ``TOLERANCES[size]["noise"]`` times one process's own noise in it where
    ``noise`` (``self_noise``'s reading on the same payload) is given."""
    tol = TOLERANCES[size]
    r0 = ranks[0]
    same = all(r[k]["digest"] == r0[k]["digest"] for r in ranks for k in ("one", "k2"))
    # which parts differ from rank 0's, by rank, when a digest does
    differ = {r["rank"]: [f"{k}.{part}" for k in ("one", "k2") for part, d in
                          r[k].get("digests", {}).items() if d != r0[k]["digests"][part]]
              for r in ranks[1:]} if not same else {}
    d1 = _state_diffs(r0["one"], one["one"])
    dk = _state_diffs(r0["k2"], one["k2"])
    dseq = _state_diffs(one["k2"], one["two"]) if "two" in one else None
    grad, scale = grad_diffs(r0["one"]["grads"], one["one"]["grads"])
    rel = grad_rel(r0["one"]["grads"], one["one"]["grads"])

    def limits(own):  # each term's limit, beside one process's own noise ``own``
        base = {"loss": tol["loss"], "params": tol["state"], "ema": tol["state"],
                "buffers": tol["buffers"]}
        if own is None or tol["noise"] is None:
            return base
        return {k: max(v, tol["noise"] * own[k]) for k, v in base.items()}

    rev = noise["reversed"] if noise is not None else None
    lims = {"step": limits(rev), "k2": limits(rev and rev["k2"]), "k2_vs_two_steps": limits(None)}
    out = {"ranks": len(ranks), "same_bits_across_ranks": same, "differ": differ,
           "step": d1, "k2": dk,
           "k2_vs_two_steps": dseq, "grad_rel": grad, "grad_scale": scale,
           "grad_worst": sorted(rel.items(), key=lambda kv: -kv[1])[:5], "tolerance": tol,
           "limits": lims,
           "loss": r0["one"]["losses"]["total"], "loss_one_process": one["one"]["losses"]["total"]}
    checks = []
    if tol["grad"] is not None:
        checks += [grad <= tol["grad"], abs(scale - 1.0) <= tol["scale"]]
    for name, d in (("step", d1), ("k2", dk), ("k2_vs_two_steps", dseq)):
        if d is not None:
            checks += [d[k] <= lim for k, lim in lims[name].items()]
    out["ok"] = bool(same and all(checks))
    return out


def tiny_dp_config(seed: int = 0) -> Config:
    """The tiny CLIP for the CPU dry run: fused route on, stochastic parts off,
    fp32, an EMA, the global-norm clip and AdamW's eps at 1e-3 (as the JAX step
    parity test sets it: with 1e-8 the elements whose gradient sits at the
    rounding floor take coin-flip steps of +-lr)."""
    from ..core.config import tiny_test_config

    cfg = tiny_test_config()
    cfg.seed = seed
    cfg.model.image_encoder.fused_mbconv = True
    cfg.model.image_encoder.drop_connect_rate = 0.0
    cfg.model.text_encoder.dropout_rate = 0.0
    cfg.train.dtype = "float32"
    cfg.optimizer.update(lr=1e-3, eps=1e-3, grad_clip_norm=1.0, ema_decay=0.9)
    return cfg


def full_width_config(seed: int = 0, dtype: str = "float32") -> Config:
    """The compat recipe (B5 at 1520x912, BERT-base, fused route, remat) with the
    stochastic parts off and 2 rows a card, in fp32 activations or the
    recipe's bf16."""
    from ..train.recipes import bench_recipe_config

    cfg = bench_recipe_config(compat=True)
    cfg.seed = seed
    cfg.model.image_encoder.drop_connect_rate = 0.0
    cfg.model.text_encoder.dropout_rate = 0.0
    cfg.optimizer.update(eps=1e-3, ema_decay=0.9)
    cfg.data.batch_size_per_device = 2
    cfg.train.dtype = dtype
    return cfg


def dp_configs(device: str, seed: int = 0) -> Dict[str, Config]:
    """What ``dryrun`` runs, by the name of its tolerances: on the CPU the tiny
    CLIP; on the card the compat recipe at full width in fp32 (the gradients
    held) and in bf16."""
    if device == "cpu":
        return {"tiny": tiny_dp_config(seed)}
    return {"full_width": full_width_config(seed, "float32"),
            "full_width_bf16": full_width_config(seed, "bfloat16")}


def host_batches(cfg: Config, rows: int, seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """Two global host batches of ``rows`` rows: uint8-valued images (two views)
    and two token sequences with ragged masks."""
    rng = np.random.default_rng(seed)
    h, w, s = cfg.data.image_size_h, cfg.data.image_size_w, cfg.data.text_max_length
    vocab = cfg.model.text_encoder.vocab_size
    out = []
    for _ in range(2):
        lengths = rng.integers(2, s + 1, size=rows)
        mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
        ids = rng.integers(1, vocab, size=(rows, s)).astype(np.int32) * mask
        out.append({"images": rng.integers(0, 256, size=(rows, h, w, 1)).astype(np.float32),
                    "image_views": rng.integers(0, 256, size=(rows, h, w, 1)).astype(np.float32),
                    "input_ids": ids, "attention_mask": mask,
                    "input_ids2": rng.integers(1, vocab, size=(rows, s)).astype(np.int32) * mask,
                    "attention_mask2": mask})
    return out


def _rank_cases(ctx, payload) -> dict:
    return {name: (pp_case if p.get("kind") == "pp" else steps_case)(ctx, p)
            for name, p in payload["cases"].items()}


# ----------------------------------------------------------------------------
# the pipelined text tower
# ----------------------------------------------------------------------------

# The pipelined tower against the sequential one: the hidden states (max
# absolute difference; JAX's 1e-4, ``__graft_entry__.py:258-259``) and each
# tensor's gradient (``grad_rel``), each at the larger of its tolerance and
# ``noise`` times what one process differs from itself by in that term
# (``pp_one``: the tower with the rows reversed, and on the pipeline's calls
# of ``mb / data`` rows one after another, whose sums round as the
# pipeline's do).
PP_TOLERANCES = {"hidden": 1e-4, "grad": 1e-4, "noise": 2.0}
PP_STAGES, PP_MICROBATCHES = 4, 4


def pp_bert(payload, device):
    """The text tower of a ``pp`` payload on ``device``: its ``init`` state
    dict, or seeded weights (the same on every rank), in the payload's dtype."""
    from ..models.bert import BertConfig, BertEncoder

    dtype = getattr(torch, payload["dtype"])
    enc = BertEncoder(BertConfig(**payload["bert"]), dtype=dtype)
    if payload.get("init") is not None:
        enc.load_state_dict(payload["init"])
    else:
        gen = torch.Generator().manual_seed(payload["seed"])
        std = 0.5 / payload["bert"]["hidden_size"] ** 0.5
        with torch.no_grad():
            for name, t in enc.named_parameters():
                t.copy_(torch.randn(t.shape, generator=gen) * std + name.endswith(".scale"))
    return enc.to(device)


def _pp_inputs(payload, device):
    return (torch.from_numpy(payload["input_ids"]).long().to(device),
            torch.from_numpy(payload["attention_mask"]).long().to(device),
            torch.from_numpy(payload["w"]).to(device))


def _pp_grads(enc, sample):
    return _snap({n: p.grad for n, p in enc.named_parameters() if p.grad is not None}, sample)


def pp_case(ctx, payload, axes=None) -> dict:
    """A rank of the pipelined tower: ``payload["pipe"]`` stages a pipe group
    (``pipeline.pipe_axes``, or ``axes`` = (pipe, data or None), e.g.
    ``ThreadGroup`` ranks; one rank alone runs the schedule with no group),
    this data rank's rows of every microbatch. The loss is sum(h * w) over
    its rows, run twice (the first run makes the point-to-point channels).
    Returns its rows, their hidden states, the gradients this rank holds
    (its stage's layers, the embeddings), a digest of the embeddings'
    gradients (every stage of a data rank the same bits), the seconds of
    each run's forward and backward and the peak device memory."""
    from . import pipeline
    from .tensor import ThreadGroup

    device = ctx.device if ctx is not None else torch.device(payload.get("device", "cpu"))
    if axes is not None:
        pipe, data = axes
    elif mesh.world_size() > 1:
        pipe, data = pipeline.pipe_axes(payload["pipe"])
    else:
        pipe, data = ThreadGroup(1).rank(0), None
    enc = pp_bert(payload, device)
    ids, mask, w = _pp_inputs(payload, device)
    m = payload["microbatches"]
    rows = pipeline.pipeline_rows(ids.shape[0], m, getattr(data, "ranks", 1),
                                  getattr(data, "index", 0)).to(device)
    seconds = []
    with full_fp32():
        for _ in range(2):
            enc.zero_grad(set_to_none=True)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            t = time.perf_counter()
            h = pipeline.pipelined_bert_hidden(enc, ids, mask, pipe, data, num_microbatches=m)
            (h.float() * w[rows]).sum().backward()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds.append(time.perf_counter() - t)
    grads = {n: p.grad for n, p in enc.named_parameters() if p.grad is not None}
    shared = {n: g for n, g in grads.items() if not n.startswith("layer_")}
    return {"rank": pipe.index + pipe.ranks * getattr(data, "index", 0),
            "pipe_index": pipe.index, "pipe": pipe.ranks,
            "data_index": getattr(data, "index", 0), "rows": rows.cpu().numpy(),
            "hidden": h.detach().float().cpu().numpy(),
            "grads": _snap(grads, payload.get("sample", False)),
            "shared_digest": _digest(shared), "seconds": seconds[-1],
            "first_seconds": seconds[0],
            "peak_bytes": torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None}


def _sequential(enc, ids, mask, w, chunk=None, order=None):
    """The sequential tower's hidden states of every row (in the batch's
    order) and its gradients of sum(h * w): on all rows in one call, in
    calls of ``chunk`` rows, or on the rows in ``order``."""
    enc.zero_grad(set_to_none=True)
    idx = torch.arange(ids.shape[0], device=ids.device) if order is None else order
    chunks = [idx] if chunk is None else list(idx.split(chunk))
    out = torch.empty(ids.shape[0], ids.shape[1], enc.cfg.hidden_size, device=ids.device)
    with full_fp32():
        for c in chunks:
            h = enc(ids[c], mask[c])
            (h.float() * w[c]).sum().backward()
            out[c] = h.detach().float()
    return out


def pp_one(payload) -> dict:
    """The sequential tower in one process on the whole batch: the hidden
    states and gradients, the seconds of its forward and backward, and its
    own noise beside them (the rows reversed; the pipeline's calls of ``mb /
    data`` rows one after another): the largest hidden difference and
    ``grad_rel`` of each."""
    device = torch.device(payload.get("device", "cpu"))
    sample = payload.get("sample", False)
    enc = pp_bert(payload, device)
    ids, mask, w = _pp_inputs(payload, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    hidden = _sequential(enc, ids, mask, w)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t
    grads = _pp_grads(enc, sample)
    b = ids.shape[0]
    chunk = b // payload["microbatches"] // payload["data"]
    noise = {}
    for name, kw in (("reversed", {"order": torch.arange(b - 1, -1, -1, device=device)}),
                     ("chunks", {"chunk": chunk})):
        h = _sequential(enc, ids, mask, w, **kw)
        noise[name] = {"hidden": float((h - hidden).abs().max()),
                       "grad_rel": max(grad_rel(_pp_grads(enc, sample), grads).values())}
    return {"hidden": hidden.cpu().numpy(), "grads": grads, "seconds": seconds, "noise": noise}


def compare_pp(ranks: List[dict], one: dict, tol: Optional[dict] = None) -> dict:
    """The ranks' pipelined tower against the one process's sequential one:
    the hidden states of every row (put together from each data rank's
    first stage; every stage of a data rank must hold the same bits), each
    layer's gradient from the stage that holds it and the embeddings' from
    each data rank's first stage, summed over the data ranks, each held to
    its limit (``PP_TOLERANCES`` beside the one process's own noise)."""
    tol = PP_TOLERANCES if tol is None else tol
    pipe = ranks[0]["pipe"]
    hidden = np.zeros_like(one["hidden"])
    same = True
    grads: Dict[str, np.ndarray] = {}
    for r in ranks:
        first = ranks[r["rank"] - r["pipe_index"]]
        same = same and r["shared_digest"] == first["shared_digest"] and np.array_equal(
            r["hidden"], first["hidden"])
        if r["pipe_index"] == 0:
            hidden[r["rows"]] = r["hidden"]
        for k, g in r["grads"].items():
            if k.startswith("layer_") or r["pipe_index"] == 0:
                grads[k] = grads[k] + g if k in grads else g.copy()
    rel = grad_rel(grads, one["grads"])
    noise = one["noise"]
    limits = {"hidden": max(tol["hidden"], tol["noise"] * max(n["hidden"] for n in noise.values())),
              "grad": max(tol["grad"], tol["noise"] * max(n["grad_rel"] for n in noise.values()))}
    d = {"hidden": float(np.max(np.abs(hidden - one["hidden"]))), "grad": max(rel.values())}
    return {"ranks": len(ranks), "pipe": pipe, "data": len(ranks) // pipe,
            "same_bits_across_stages": bool(same), "hidden": d["hidden"], "grad_rel": d["grad"],
            "grad_worst": sorted(rel.items(), key=lambda kv: -kv[1])[:5], "limits": limits,
            "noise": noise, "ok": bool(same and all(d[k] <= limits[k] for k in d))}


def pp_payload(bert: dict, dtype: str, rows: int, seq: int, pipe: int, data: int,
               microbatches: int = PP_MICROBATCHES, seed: int = 0, device: str = "cpu",
               init: Optional[dict] = None) -> dict:
    """A ``pp`` case: the tower's config (``BertConfig``'s fields, dropout
    off), ``rows`` x ``seq`` seeded tokens with ragged masks and the loss's
    weights, ``pipe`` stages and ``data`` data ranks."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, seq + 1, size=rows)
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(1, bert["vocab_size"], size=(rows, seq)).astype(np.int32) * mask
    w = rng.standard_normal((rows, seq, bert["hidden_size"])).astype(np.float32)
    return {"kind": "pp", "bert": {**bert, "dropout_rate": 0.0}, "dtype": dtype, "seed": seed,
            "input_ids": ids, "attention_mask": mask, "w": w, "pipe": pipe, "data": data,
            "microbatches": microbatches, "device": device, "sample": device == "cuda",
            "init": init}


# the CPU's tower: JAX's pipeline test's (``tests/test_pipeline.py::_bert``)
TINY_PP_BERT = dict(vocab_size=64, hidden_size=16, num_layers=4, num_heads=2,
                    intermediate_size=32, max_position_embeddings=32)


def pp_layout(n_ranks: int, num_layers: int, rows: int):
    """(pipe, data) of the ``pp`` layout on ``n_ranks``: 4 stages and N / 4
    data ranks when 4 divides N, else one pipe of N stages; None when the
    stages do not divide the layers or the data ranks a microbatch."""
    pipe = PP_STAGES if n_ranks % PP_STAGES == 0 else n_ranks
    data = n_ranks // pipe
    if num_layers % pipe or rows % PP_MICROBATCHES or (rows // PP_MICROBATCHES) % data:
        return None
    return pipe, data


LAYOUTS = ("dp", "tp", "sp", "pp")
DEFAULT_LAYOUTS = ("dp", "tp")  # what a call that names none runs


def layout_cases(n_ranks: int, device: str, seed: int = 0,
                 layouts=DEFAULT_LAYOUTS) -> Dict[str, dict]:
    """The payloads of ``steps_case`` and ``pp_case``, by case name, for each
    of ``dp_configs(device)``: ``dp``, the data-parallel step on every rank
    (``n_ranks`` x B rows); ``tp`` (``<name>_tp``, with an even ``n_ranks``),
    the JAX dry run's layout, ``data = n_ranks / 2`` and ``model = 2`` with
    the state placed by ``shard_train_state(fsdp=True)`` (Megatron splits and
    ZeRO-3), on (n_ranks / 2) x B rows; ``sp`` (``<name>_sp``), the same
    with ``text_encoder.seq_parallel`` on the same rows; ``pp``
    (``<name>_pp``, ``pp_layout``), the config's text tower (the CPU's:
    ``TINY_PP_BERT``, 16 tokens) pipelined, 8 rows in 4 microbatches. A
    case's tolerances are its config's."""
    from ..models.clip import bert_config_from_model_config

    cases = {}
    for name, cfg in dp_configs(device, seed).items():
        b = cfg.data.batch_size_per_device
        # the K=2 call against two steps once: the dtype does not change the loop
        common = {"cfg": cfg.to_dict(), "sample": device == "cuda", "device": device,
                  "two_steps": cfg.train.dtype == "float32"}
        if "dp" in layouts:
            cases[name] = {**common, "batches": host_batches(cfg, n_ranks * b, seed)}
        if "tp" in layouts and n_ranks % 2 == 0:
            cases[f"{name}_tp"] = {**common, "batches": host_batches(cfg, n_ranks // 2 * b, seed),
                                   "mesh": {"data": n_ranks // 2, "model": 2},
                                   "shard": {"fsdp": True}}
        if "sp" in layouts and n_ranks % 2 == 0:
            sp = Config(cfg.to_dict())
            sp.model.text_encoder.seq_parallel = True
            cases[f"{name}_sp"] = {**common, "cfg": sp.to_dict(),
                                   "batches": host_batches(cfg, n_ranks // 2 * b, seed),
                                   "mesh": {"data": n_ranks // 2, "model": 2},
                                   "shard": {"fsdp": True}}
        if "pp" in layouts:
            if device == "cpu":
                bert, seq = dict(TINY_PP_BERT), 16
            else:
                bert = dataclasses.asdict(bert_config_from_model_config(cfg.model.to_dict()))
                bert = {k: bert[k] for k in TINY_PP_BERT}
                seq = cfg.data.text_max_length
            layout = pp_layout(n_ranks, bert["num_layers"], 8)
            if layout is not None:
                cases[f"{name}_pp"] = pp_payload(bert, cfg.train.dtype, 8, seq, *layout,
                                                 seed=seed, device=device)
    return cases


def dryrun(n_ranks: int, device: str = "cuda", seed: int = 0,
           timeout_s: float = 600.0, layouts=DEFAULT_LAYOUTS) -> dict:
    """``steps_case`` (``pp_case`` for a ``pp`` case) for each of
    ``layout_cases`` on ``n_ranks`` ranks and in this process (while the
    ranks run), each held to its config's tolerances by ``compare``, with
    ``self_noise`` beside it (an ``sp`` case shares its ``tp`` case's one
    process, which takes no sequence split, and its loss is held to the
    ``tp`` ranks' too), a ``pp`` case by ``compare_pp`` against ``pp_one``.
    Returns ``{name: compare's dict with the ranks' and the one process's
    seconds a step and peak device memory, the fused launches a rank and
    the self-noise}`` and ``ok``. With one rank no process group is made and
    no collective runs (and no ``tp`` or ``sp`` case): the ranks' sums are
    then exercised only by the tests' gloo ranks and ``chip_smoke.py``'s
    phases 17 (a), 18 (a) and 19 (a)."""
    from concurrent.futures import ThreadPoolExecutor

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun --device cuda: no CUDA device (--device cpu runs "
                               "gloo ranks on the CPU)")
        from ..ops import cuda_lib

        cuda_lib.build()  # once, before the ranks would each build it
    cases = layout_cases(n_ranks, device, seed, layouts)
    pp = {name: p for name, p in cases.items() if p.get("kind") == "pp"}
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(run_ranks, n_ranks, f"{__name__}:_rank_cases",
                              {"cases": cases, "timeout_s": timeout_s}, device, timeout_s)
        ones, noise = {}, {}
        for name, p in cases.items():
            if name in pp:
                continue
            # the one process takes no sequence split: an sp case's is its tp case's
            twin = name.replace("_sp", "_tp") if name.endswith("_sp") else None
            if twin in ones:
                ones[name], noise[name] = ones[twin], noise[twin]
                continue
            ones[name] = steps_case(None, p)
            noise[name] = self_noise(p, ones[name])
        pp_ones = {name: pp_one(p) for name, p in pp.items()}
        ranks = spawned.result()
    out = {"ranks": n_ranks, "device": device}
    for name, one in pp_ones.items():
        cmp = compare_pp([r[name] for r in ranks], one)
        cmp.update(rank_s=[r[name]["seconds"] for r in ranks],
                   rank_first_s=[r[name]["first_seconds"] for r in ranks],
                   one_process_s=one["seconds"],
                   rank_peak_bytes=[r[name]["peak_bytes"] for r in ranks],
                   dtype=pp[name]["dtype"], rows=len(pp[name]["input_ids"]),
                   microbatches=pp[name]["microbatches"], layers=pp[name]["bert"]["num_layers"])
        out[name] = cmp
    for name, one in ones.items():
        size = name.removesuffix("_tp").removesuffix("_sp")
        cmp = compare([r[name] for r in ranks], one, size, noise[name])
        twin = name.replace("_sp", "_tp")
        if name.endswith("_sp") and twin in ones:  # the sp step against the tp step
            loss_tp = ranks[0][twin]["one"]["losses"]["total"]
            cmp["loss_tp"] = loss_tp
            cmp["vs_tp"] = abs(cmp["loss"] - loss_tp) / max(1.0, abs(loss_tp))
            cmp["ok"] = cmp["ok"] and cmp["vs_tp"] <= cmp["limits"]["step"]["loss"]
        cmp.update(mesh=cases[name].get("mesh", {"data": n_ranks, "model": 1}),
                   rank_step_s=[r[name]["one"]["seconds"] for r in ranks],
                   one_process_step_s=one["one"]["seconds"],
                   rank_peak_bytes=[r[name]["one"]["peak_bytes"] for r in ranks],
                   one_process_peak_bytes=one["one"]["peak_bytes"],
                   fused_per_rank=ranks[0][name]["one"]["fused"], self_noise=noise[name])
        out[name] = cmp
    out["ok"] = all(out[name]["ok"] for name in [*ones, *pp_ones])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="N ranks equal one process")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks (default: every visible card, or 4 with --device cpu)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--layout", nargs="+", default=list(DEFAULT_LAYOUTS), choices=LAYOUTS,
                    help="dp: data parallelism on every rank; tp: data N/2 x model 2, "
                    "Megatron splits and ZeRO-3 (an even N); sp: tp with BERT's sequence "
                    "parallelism; pp: the text tower over 4 pipeline stages")
    ap.add_argument("--rank-worker", nargs=3, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_worker:
        _rank_worker(*args.rank_worker)
        return 0
    ranks = args.ranks or (4 if args.device == "cpu" else torch.cuda.device_count())
    out = dryrun(ranks, args.device, args.seed, args.timeout, tuple(args.layout))
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
