"""The embedding loop: the program's serving extractor over a stream of
studies.

Set-up builds the program's CLIP model in fp32 (``models.build_model``, as
``eval/loading.py`` gives it to the CLIs), loads the benchmark's weights
(BatchNorm running statistics set to the reference's batch statistics of a
few seeded images, so that eval mode sees normalised activations), wraps it
in ``eval/embeddings.py::EmbeddingExtractor`` and makes the mix's pool of
host batches: each batch the views of a few studies and their reports. The
first ``warmup_batches`` batches warm every shape up. The window then calls
``encode_images`` on each batch's views and ``encode_texts`` on its reports
until ``--seconds`` have passed; the extractor returns host arrays, so every
batch ends in a synchronisation. ``embed_images_per_s`` is every view
embedded over the window's length. With ``--trace 1`` each batch's host
time is kept and ``profile_batches`` more batches are profiled.

After the window the program is freed and every answer of the window is
held to the fp32 reference's embedding of its input.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from portbench.harness import compare, inputs
from portbench.harness.result import Outcome, Run, device_info
from portbench.harness.runtime import GIB, free, note, synchronize
from portbench.harness.trace import profile
from portbench.reference import clip as ref
from portbench.reference.precision import Precision


def build(cell, seed: int, device):
    """The program's extractor with the benchmark's weights, and those weights."""
    from mammo_clip_tpu_torch.core.config import Config
    from mammo_clip_tpu_torch.eval.embeddings import EmbeddingExtractor
    from mammo_clip_tpu_torch.models import build_model

    cfg = cell.config["config"]
    params, buffers = ref.param_shapes(cfg["model"])
    weights = inputs.make_weights(params, buffers, seed, device, cfg["model"]["temperature"])
    calibration = inputs.host_batches(cell.traffic["calibration"], cfg, seed + 1)[0]
    images = inputs.to_device(calibration, device)["images"]
    for (mean, var), name in zip(ref.batch_statistics(weights, cfg, images),
                                 [b for b in buffers if b.endswith(".mean")]):
        weights[name] = mean
        weights[name[:-len(".mean")] + ".var"] = var
    model = build_model(Config(cfg["model"]).to_dict(), dtype=torch.float32, device=device)
    model.load_state_dict(weights, strict=True)
    return EmbeddingExtractor(model, cfg["data"]["mean"], cfg["data"]["std"],
                              batch_size=cell.traffic["extractor_batch"]), weights


def embed_batch(extractor, batch) -> tuple:
    return (extractor.encode_images(batch["images"]),
            extractor.encode_texts(batch["input_ids"], batch["attention_mask"]))


def start(cell, seed: int, device):
    t = time.perf_counter()
    extractor, weights = build(cell, seed, device)
    t = note("build", t)
    pool = inputs.host_batches(cell.traffic, cell.config["config"], seed)
    t = note("inputs", t)
    for k in range(cell.traffic["warmup_batches"]):
        embed_batch(extractor, pool[k % len(pool)])
    note("warm-up batches", t)
    return extractor, weights, pool


def reference(cell, weights, pool, device, prec: str = "fp32"):
    """The reference's image and text embeddings of every pool batch."""
    out = []
    for batch in pool:
        b = inputs.to_device(batch, device)
        img, txt = ref.embed(weights, cell.config["config"], b["images"], b["input_ids"],
                             b["attention_mask"], Precision(prec))
        out.append((img.cpu().numpy(), txt.cpu().numpy()))
    return out


def gaps(answers: List, pool_ref: List) -> Dict[str, float]:
    """Each answer (pool index, images, texts) against the reference's."""
    img = max(compare.embedding_gap(a[1], pool_ref[a[0]][0]) for a in answers)
    txt = max(compare.embedding_gap(a[2], pool_ref[a[0]][1]) for a in answers)
    return {"image_gap": img, "text_gap": txt}


def run(cell, seed: int, seconds: float, trace: bool, started: float,
        device="cuda") -> Outcome:
    extractor, weights, pool = start(cell, seed, device)
    synchronize(device)
    setup_s = time.perf_counter() - started
    record = Run(config=cell.config, traffic=cell.traffic, peak="tf32")
    answers = []
    t_start = time.perf_counter()
    k = 0
    while True:
        t0 = time.perf_counter()
        img, txt = embed_batch(extractor, pool[k % len(pool)])
        t1 = time.perf_counter()
        answers.append((k % len(pool), img, txt))
        k += 1
        if trace:
            record.spans.setdefault("batch", []).append(t1 - t0)
        if t1 - t_start >= seconds:
            break
    elapsed = time.perf_counter() - t_start
    cuda = torch.device(device).type == "cuda"
    if trace and cuda:
        batches = iter(range(k, k + cell.traffic["profile_batches"]))
        record.profile = profile(lambda: embed_batch(extractor, pool[next(batches) % len(pool)]),
                                 cell.traffic["profile_batches"])
    record.steps = k
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del extractor
    free(device)
    t = time.perf_counter()
    checks = compare.judge(gaps(answers, reference(cell, weights, pool, device)), cell.limits)
    note("reference", t)
    return Outcome(
        metrics={"setup_s": setup_s,
                 "embed_images_per_s": k * cell.traffic["images"]["rows"] / elapsed,
                 "peak_mem_gib": peak / GIB},
        run=record, device=device_info(cell.chips, peak) if cuda else {},
        checks=checks, attempted=k)


def readings(cell, seed: int, device="cuda", controls=()) -> Dict[str, Dict[str, float]]:
    """The compared numbers of a sound run over the pool, and of each control
    (the reference in a lower precision) against the fp32 reference."""
    extractor, weights, pool = start(cell, seed, device)
    answers = [(i, *embed_batch(extractor, b)) for i, b in enumerate(pool)]
    del extractor
    free(device)
    fp32 = reference(cell, weights, pool, device)
    out = {"program": gaps(answers, fp32)}
    for c in controls:
        other = reference(cell, weights, pool, device, prec=c)
        out[c] = gaps([(i, img, txt) for i, (img, txt) in enumerate(other)], fp32)
    return out
