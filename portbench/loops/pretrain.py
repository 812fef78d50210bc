"""The pretraining loop: the program's bench step fed by its prefetch
pipeline, one optimizer step a call.

Set-up builds the program's train step (``train/recipes.py::
build_bench_train`` on the configuration's recipe), loads the benchmark's
weights into it, makes the mix's pool of host batches from the seed and
starts ``data/pipeline.py::prefetch_to_device`` over the pool, cycled. The
first ``checked_steps`` steps go through that same feed and call and are
the ones the reference follows; they also warm every shape up. The window
then steps on until ``--seconds`` have passed, with no synchronisation but
at its two ends: ``train_images_per_s`` is every image view stepped over
the window's length. With ``--trace 1`` the window also records a host span
around each ``next()`` of the feed and each call of the step, a CUDA event
at each step's end, the kernels' launch counters, and then profiles
``profile_steps`` more steps.

After the window the program's state is freed and the reference runs the
checked steps again in fp32 from the same weights, batches and step seeds.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List

import torch

from portbench.harness import compare, inputs
from portbench.harness.result import Outcome, Run, device_info
from portbench.harness.runtime import GIB, free, note, synchronize
from portbench.harness.trace import profile
from portbench.reference import clip as ref
from portbench.reference.precision import Precision


def port_config(cell):
    from mammo_clip_tpu_torch.train.recipes import bench_recipe_config

    return bench_recipe_config(**cell.config["recipe"]).merged(cell.config["config"])


def build(cell, seed: int, device):
    """The program's model, train state and step with the benchmark's weights
    loaded, and those weights."""
    from mammo_clip_tpu_torch.train import recipes

    sched = cell.config["schedule"]
    if (recipes.BENCH_TOTAL_STEPS, recipes.BENCH_WARMUP_STEPS) != (
            sched["total_steps"], sched["warmup_steps"]):
        raise ValueError("the recipe's schedule is not the configuration's")
    model, _, state, _, step = recipes.build_bench_train(port_config(cell), device=device)
    model_cfg = cell.config["config"]["model"]
    params, buffers = ref.param_shapes(model_cfg)
    weights = inputs.make_weights(params, buffers, seed, device, model_cfg["temperature"])
    model.load_state_dict(weights, strict=True)
    return model, state, step, weights


def launch_counts() -> Dict[str, int]:
    from mammo_clip_tpu_torch.ops import flash_attention, mbconv

    return {"mbconv_calls": sum(mbconv.launches.counts.values()),
            "flash_calls": sum(flash_attention.launches.counts.values())}


def checked_steps(model, state, feed, call: Callable, steps: int, beta1: float) -> Dict:
    """Run the first ``steps`` steps; each step's loss, each leaf's first
    gradient's norm as the optimizer got it (from AdamW's first moment after
    one step: (1 - beta1) g), each leaf's change over the steps, and the
    first step's embeddings as the model's forward returned them."""
    named = list(model.named_parameters())
    start = [p.detach().clone() for _, p in named]
    losses, grads, emb = [], [], {}
    keep = lambda module, args, out: emb.update(
        {k: out[k].detach().clone() for k in compare.IMAGES + compare.TEXTS})
    hook = model.register_forward_hook(keep)
    for k in range(steps):
        _, loss = call(next(feed))
        losses.append(loss["total"].detach().float().reshape(()))
        if k == 0:
            hook.remove()
            moments = state.optimizer.inner.state
            zero = torch.zeros((), device=start[0].device)
            grads = [torch.linalg.vector_norm(moments[p]["exp_avg"]) / (1.0 - beta1)
                     if "exp_avg" in moments.get(p, {}) else zero for _, p in named]
    change = [torch.linalg.vector_norm(p.detach() - s) for (_, p), s in zip(named, start)]
    names = [n for n, _ in named]
    return {"loss": torch.stack(losses).tolist(),
            "grad": dict(zip(names, torch.stack(grads).tolist())),
            "change": dict(zip(names, torch.stack(change).tolist())),
            "embeddings": {k: e.float().cpu().numpy() for k, e in emb.items()}}


def window(call: Callable, feed, seconds: float, trace: bool, profile_steps: int, device,
           run: Run):
    """Steps until ``seconds`` have passed; returns (steps, seconds)."""
    cuda = torch.device(device).type == "cuda"
    before = launch_counts()
    events: List = []
    synchronize(device)
    if trace and cuda:
        events.append(torch.cuda.Event(enable_timing=True))
        events[0].record()
    t_start = time.perf_counter()
    steps = 0
    while True:
        t0 = time.perf_counter()
        batch = next(feed)
        t1 = time.perf_counter()
        call(batch)
        t2 = time.perf_counter()
        steps += 1
        if trace:
            run.spans.setdefault("data_wait", []).append(t1 - t0)
            run.spans.setdefault("dispatch", []).append(t2 - t1)
            if cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        if t2 - t_start >= seconds:
            break
    if trace:
        after = launch_counts()
        run.counters = {k: (after[k] - before[k]) / steps for k in after}
        run.steps = steps
        if cuda:
            run.profile = profile(lambda: call(next(feed)), profile_steps)
    synchronize(device)
    elapsed = time.perf_counter() - t_start
    if trace and cuda:
        run.step_s = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
    return steps, elapsed


def reference(cell, weights, pool, seed: int, device, prec: str = "fp32", rows=None) -> Dict:
    """The reference's checked steps (``rows`` keeps that many samples of each
    batch: the half-batch fault)."""
    params, _ = ref.param_shapes(cell.config["config"]["model"])
    batches = [inputs.to_device(pool[k], device) for k in range(cell.traffic["checked_steps"])]
    return ref.train_steps({n: weights[n] for n in params}, cell.config["config"], batches,
                           seed, cell.config["schedule"], Precision(prec), rows=rows)


def start(cell, seed: int, device):
    """Set-up: the program, the pool, the feed and the checked steps."""
    t = time.perf_counter()
    model, state, step, weights = build(cell, seed, device)
    from mammo_clip_tpu_torch.data.pipeline import prefetch_to_device

    t = note("build", t)
    pool = inputs.host_batches(cell.traffic, cell.config["config"], seed)
    t = note("inputs", t)
    feed = prefetch_to_device(itertools.cycle(pool), device,
                              depth=cell.traffic["prefetch_depth"])
    gen = torch.Generator(device=device)
    call = lambda batch: step(state, batch, gen, seed=seed)
    beta1 = cell.config["config"]["optimizer"].get("beta1", 0.9)
    prog = checked_steps(model, state, feed, call, cell.traffic["checked_steps"], beta1)
    note("checked steps", t)
    return model, state, call, feed, weights, pool, prog


def run(cell, seed: int, seconds: float, trace: bool, started: float,
        device="cuda") -> Outcome:
    model, state, call, feed, weights, pool, prog = start(cell, seed, device)
    synchronize(device)
    setup_s = time.perf_counter() - started
    record = Run(config=cell.config, traffic=cell.traffic, peak="bf16")
    steps, elapsed = window(call, feed, seconds, trace, cell.traffic["profile_steps"], device,
                            record)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    feed.close()
    del model, state, call, feed
    free(device)
    t = time.perf_counter()
    gaps = compare.training_gaps(prog, reference(cell, weights, pool, seed, device))
    note("reference", t)
    views = len(cell.traffic["images"]["keys"]) * cell.traffic["images"]["rows"]
    return Outcome(
        metrics={"setup_s": setup_s, "train_images_per_s": steps * views / elapsed,
                 "peak_mem_gib": peak / GIB},
        run=record, device=device_info(cell.chips, peak) if cuda else {},
        checks=compare.judge(gaps, cell.limits), attempted=steps)


def readings(cell, seed: int, device="cuda", controls=()) -> Dict[str, Dict[str, float]]:
    """The compared numbers of a sound run without a window, and of each
    control against the fp32 reference: a lower precision of the reference
    (``fp8``, ``bf16``) or ``rows`` (the reference on half of every batch)."""
    model, state, call, feed, weights, pool, prog = start(cell, seed, device)
    feed.close()
    del model, state, call, feed
    free(device)
    fp32 = reference(cell, weights, pool, seed, device)
    out = {"program": compare.training_gaps(prog, fp32),
           "program_worst": compare.worst_leaves(prog, fp32)}
    half = cell.traffic["images"]["rows"] // 2
    for c in controls:
        other = (reference(cell, weights, pool, seed, device, prec=c) if c != "rows"
                 else reference(cell, weights, pool, seed, device, rows=half))
        out[c] = compare.training_gaps(other, fp32)
        out[c + "_worst"] = compare.worst_leaves(other, fp32)
    return out
