"""Time ``fused_mbconv_e6`` (or ``fused_mbconv_e1``) at one of B5's main-path
shapes, and the compat slice's peak memory, through the public API only, so that
an older checkout of the port is measured the same way.

    python mammo_clip_tpu_torch/benchmarks/e6_timing.py [--root DIR] [--case C] [--slice]
    python mammo_clip_tpu_torch/benchmarks/e6_timing.py --turns OLD_ROOT [--case C] [--slice]

One run prints one JSON line for the package under ``--root`` (default: this
checkout) at ``--case`` (bf16, N=2, seeded inputs): ``block4_e6`` (the default:
the expanding form, C=C2=40, E=240, 380x228 valid in 384x232), ``block0_e1``
(the e=1 form, 48 -> 24, 760x456) or ``block1_e1`` (24 -> 24 with the
residual, 760x456), or ``block0_e1_entry`` / ``block1_e1_entry`` (block0_e1's
or block1_e1's inputs through ``fused_mbconv_e1``, the e=1 block's own entry
point); ``fwd_ms`` and ``bwd_ms`` (CUDA events, median of 5 trials of 10 calls
after a second of forward calls and 2 warm-ups; the backward is
``torch.autograd.grad`` through the wrapper with the graph kept),
``kernels_fwd`` and ``kernels_bwd`` (each kernel one forward and one backward
launch, by name: launches and device us, from torch.profiler's trace),
``fwd_device_ms`` and ``bwd_device_ms`` (the same calls' device time, the host's
enqueue hidden behind a sleep kernel: ``layout_timing.device_ms``), ``held_bytes`` (what one forward keeps allocated
for its backward beyond out and the stats, as the caching allocator counts it,
which rounds a large block such as out's up to whole 2 MiB;
``held_requested_bytes``, the same in the bytes the tensors asked for;
``saved_bytes``, the part in the tensors its autograd node saves), and the kernels one forward and one
backward launch by torch.profiler: ``hand_*`` those of the package's own CUDA
library, ``all_*`` every kernel (the torch ops between them too); ``digest``,
a SHA-1 of the bits of one forward's out and stats and its backward's dx and
parameter gradients, so that two packages' results compare bit for bit. With
``--slice`` it also runs 3 steps of the full-width compat B5 CLIP at batch 2
and prints each step's peak device memory. ``--turns OLD_ROOT`` runs old, new,
new, old, one process each (``--slice`` in the first two), and prints their
lines. It needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


# case -> (form, C, C2, valid_h, valid_w); a *_entry case is its e1 case through
# fused_mbconv_e1 (ops/mbconv.py), whose image has no pad region
CASES = {"block4_e6": ("e6", 40, 40, 380, 228), "block0_e1": ("e1", 48, 24, 760, 456),
         "block1_e1": ("e1", 24, 24, 760, 456), "block0_e1_entry": ("e1", 48, 24, 760, 456),
         "block1_e1_entry": ("e1", 24, 24, 760, 456)}


def make_case(name="block4_e6", seed=0):
    import torch

    from mammo_clip_tpu_torch.ops.mbconv import MBConvParams
    from mammo_clip_tpu_torch.ops.mbconv6 import MBConv6Params, pick_h_pad, pick_w_pad

    form, C, C2, vh, vw = CASES[name]
    N, E = 2, 6 * C if form == "e6" else C
    H, W = pick_h_pad(vh), pick_w_pad(vw)
    g = torch.Generator(device="cuda").manual_seed(seed)
    f = lambda *s: 0.5 * torch.randn(*s, generator=g, device="cuda")
    sq = C // 4
    lead = (dict(we=f(C, E) / math.sqrt(C), gamma0=1 + 0.1 * f(E), beta0=0.1 * f(E))
            if form == "e6" else {})
    p = dict(lead, dw_kernel=f(E, 3, 3), gamma1=1 + 0.1 * f(E), beta1=0.1 * f(E),
             se_w1=f(E, sq) / math.sqrt(E), se_b1=0.1 * f(sq),
             se_w2=f(sq, E) / math.sqrt(sq), se_b2=0.1 * f(E),
             wp=f(E, C2) / math.sqrt(E), gamma2=1 + 0.1 * f(C2), beta2=0.1 * f(C2))
    p = (MBConv6Params if form == "e6" else MBConvParams)(**p)
    x = torch.zeros(N, C, H, W, device="cuda")
    x[:, :, :vh, :vw] = torch.randn(N, C, vh, vw, generator=g, device="cuda")
    gout = torch.zeros(N, C2, H, W, device="cuda")
    gout[:, :, :vh, :vw] = torch.randn(N, C2, vh, vw, generator=g, device="cuda")
    delta = torch.tensor([1.25, 1.0], device="cuda")
    return x.bfloat16(), p, delta, gout.bfloat16(), (vh, vw)


def median_ms(fn, trials=5, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    return statistics.median(times)


def kernels_of(fn):
    """{kernel name: [launches, device us]} of one call of ``fn``, from
    torch.profiler's trace."""
    import tempfile

    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        events = json.loads(Path(f"{d}/trace.json").read_text())["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            n, t = out.get(e["name"], (0, 0.0))
            out[e["name"]] = [n + 1, t + e["dur"]]
    return out


def launch_counts(kernels):
    """(hand, all) launches of kernels_of's result; the package's own kernels live
    in anonymous namespaces of its CUDA sources."""
    return (sum(n for name, (n, _) in kernels.items() if "anonymous namespace" in name),
            sum(n for n, _ in kernels.values()))


def bits_digest(tensors) -> str:
    """SHA-1 of the tensors' bytes, in order."""
    import hashlib

    import torch

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def measure(case):
    import torch

    from mammo_clip_tpu_torch.benchmarks.layout_timing import device_ms
    from mammo_clip_tpu_torch.ops.mbconv import fused_mbconv_e1
    from mammo_clip_tpu_torch.ops.mbconv6 import fused_mbconv_e6

    x, p, delta, gout, (vh, vw) = make_case(case)
    if case.endswith("_entry"):
        block = lambda x, p, delta, vh, vw: fused_mbconv_e1(x, p, delta)
    else:
        block = fused_mbconv_e6
    xr = x.clone().requires_grad_(True)
    pr = type(p)(*[t.clone().requires_grad_(True) for t in p])
    with torch.no_grad():
        fwd = lambda: block(x, p, delta, vh, vw)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 1.0:  # the card's clocks up from idle first
            fwd()
            torch.cuda.synchronize()
        fwd_ms, fwd_device_ms = median_ms(fwd), device_ms(fwd)
        kernels_f = kernels_of(fwd)
    torch.cuda.synchronize()
    requested = lambda: torch.cuda.memory_stats().get("requested_bytes.all.current", 0)
    base, base_req = torch.cuda.memory_allocated(), requested()
    out, stats = block(xr, pr, delta, vh, vw)
    torch.cuda.synchronize()
    outputs = sum(t.numel() * t.element_size() for t in (out, *stats))
    held = torch.cuda.memory_allocated() - base - outputs
    held_requested = requested() - base_req - outputs
    digest = bits_digest([out, *stats, *torch.autograd.grad(out, [xr, *pr], gout,
                                                            retain_graph=True)])
    before = {t.untyped_storage().data_ptr() for t in (xr, delta, *pr, out, *stats)}
    saved = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
             for t in out.grad_fn.saved_tensors}
    saved_bytes = sum(v for k, v in saved.items() if k not in before)
    bwd = lambda: torch.autograd.grad(out, [xr, *pr], gout, retain_graph=True)
    bwd_ms, bwd_device_ms = median_ms(bwd), device_ms(bwd)
    kernels_b = kernels_of(bwd)
    (hand_f, all_f), (hand_b, all_b) = launch_counts(kernels_f), launch_counts(kernels_b)
    return dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, fwd_device_ms=fwd_device_ms,
                bwd_device_ms=bwd_device_ms, held_bytes=held, held_requested_bytes=held_requested,
                saved_bytes=saved_bytes, digest=digest,
                hand_fwd=hand_f, all_fwd=all_f,
                hand_bwd=hand_b, all_bwd=all_b, kernels_fwd=kernels_f, kernels_bwd=kernels_b)


def slice_peaks(steps=3, seed=0):
    """Peak device memory (bytes) of each of ``steps`` compat-slice train steps."""
    import torch

    from mammo_clip_tpu_torch.train.recipes import bench_recipe_config, build_bench_train

    cfg = bench_recipe_config(compat=True)
    _, _, state, _, train_step = build_bench_train(cfg, device="cuda", seed=seed)
    h, w, s = cfg.data.image_size_h, cfg.data.image_size_w, cfg.data.text_max_length
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(1, cfg.model.text_encoder.vocab_size, (2, s), generator=g, device="cuda")
    mask = torch.ones(2, s, dtype=torch.long, device="cuda")
    batch = {"images": 255 * torch.rand(2, h, w, 1, generator=g, device="cuda"),
             "image_views": 255 * torch.rand(2, h, w, 1, generator=g, device="cuda"),
             "input_ids": ids, "attention_mask": mask, "input_ids2": ids, "attention_mask2": mask}
    peaks = []
    for _ in range(steps):
        torch.cuda.reset_peak_memory_stats()
        state, loss = train_step(state, batch, g)
        float(loss["total"])
        peaks.append(torch.cuda.max_memory_allocated())
    return peaks


def run(root: Path, with_slice: bool, case: str = "block4_e6") -> dict:
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("e6_timing needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = dict(root=str(root), device=torch.cuda.get_device_name(0), case=case,
               **measure(case))
    if with_slice:
        res["slice_peak_bytes"] = slice_peaks()
    return res


def run_process(root: Path, case: str, with_slice: bool = False) -> dict:
    """``run`` in a process of its own (this file against ``root``): its record."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--root", str(root), "--case", case]
    res = subprocess.run(cmd + (["--slice"] if with_slice else []), capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(root)), timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"e6_timing on {root} failed:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def turns(old: Path, with_slice: bool, case: str = "block4_e6"):
    """old, new, new, old: one process each, this file run against each root;
    with ``with_slice`` the first old and new processes also run the slice."""
    lines = []
    for i, root in enumerate((old, HERE, HERE, old)):
        line = run_process(root, case, with_slice and i < 2)
        line["side"] = "old" if root == old else "new"
        print(json.dumps({k: v for k, v in line.items() if not k.startswith("kernels_")}),
              flush=True)
        lines.append(line)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--turns", type=Path, default=None, metavar="OLD_ROOT")
    ap.add_argument("--case", choices=sorted(CASES), default="block4_e6")
    ap.add_argument("--slice", action="store_true")
    args = ap.parse_args(argv)
    if args.turns is not None:
        return turns(args.turns.resolve(), args.slice, args.case)
    res = run(args.root.resolve(), args.slice, args.case)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
