"""Per-call cost of the layout probe kernels (``csrc/probes.cu`` through
``ops/probes.py``) beside one PyTorch call of the same function, on the card.

For gram, copy_scale and channel_mix at the JAX probe script's shapes, and for
their library calls (``torch.mm``, ``torch.mul``, ``torch.einsum``):

  ms         CUDA-event time per call: the median of 5 trials of 200 calls
             after 20 warm-up calls (what a caller issuing them back to back
             waits; at these sizes mostly the host's cost of a call)
  device_ms  the device's time per call, the host's enqueue of the calls hidden
             behind a sleep kernel
  host_us    the host's cost per call: ``time.perf_counter`` over 1,000 calls
             (5 turns of 200) with no synchronise between the calls of a turn

The kernel's and the library call's trials are taken in turns, so that a drift
of the host's speed falls on both. The same three numbers are taken for the
flash attention wrapper at the probe's (16, 12, 256, 64) bf16
(``flash_attention``; ``flash.forward`` a call on tensors that need no
gradient, ``flash.backward`` ``torch.autograd.grad`` through a kept graph),
its forward and backward trials in turns.

The device time of one launch of a kernel that does nothing
(``probes.empty_kernel``, where the checkout has it) is taken the same way:
the least device time any launch can take, beside the layout kernels' bounds.

With ``--grid`` it times the grid probe's kernels instead: ``probes.grid_compute``,
``probes.grid_const`` and ``probes.grid_base`` (a control, when two checkouts share its
kernel) at the probe's shape (x (16, 40, 232, 384), E = 240,
bf16), ``ms`` the median CUDA-event time per call of 5 trials of 10 calls after 3
warm-up calls each.

Usage, on the card:

  python mammo_clip_tpu_torch/benchmarks/layout_timing.py [--root DIR] [--turns OLD_DIR] [--grid]

``--root`` imports ``ops/probes.py`` and ``ops/flash_attention.py`` from another
checkout (for example a parent commit unpacked with ``git archive``), so that two
versions of the wrappers and their launch paths are timed by the same code. ``--turns OLD_DIR`` runs OLD_DIR, this checkout, this
checkout and OLD_DIR, one process each, and prints each one's JSON line and
then, per function, the two versions' medians side by side.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE_ROOT = Path(__file__).resolve().parents[2]


def event_ms(fn, calls=200):
    """CUDA-event ms per call over ``calls`` back-to-back calls."""
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(calls):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


def device_ms(fn, reps=10):
    """ms per call of ``fn`` on the device alone: a sleep kernel holds the stream
    while the host enqueues all the calls, so the events around them time the
    device's back-to-back work, not the host's enqueue (which bounds an
    autograd call at small sizes). Fails if the enqueue outlasts the sleep."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(4):
        s0, s1, t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(4))
        s0.record()
        torch.cuda._sleep(cycles)
        s1.record()
        t0.record()
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - start) * 1e3
        t1.record()
        torch.cuda.synchronize()
        if host_ms < 0.8 * s0.elapsed_time(s1):
            return t0.elapsed_time(t1) / reps
        cycles *= 4
    raise RuntimeError(f"device_ms: the host's enqueue ({host_ms:.1f} ms) outlasted the sleep")


def host_s(fn, calls):
    """Host seconds for ``calls`` calls with no synchronise between them (the
    device, faster than the host here, never makes the host wait)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed


def compare(*fns, trials=5, calls=200, warmup=20):
    """``ms``, ``device_ms`` and ``host_us`` of each of ``fns`` (a kernel's wrapper
    and its library call, say). Their trials are taken in turns (first, second,
    first, ...), so that a drift of the host's speed during the run falls on
    all: ``ms`` is the median of ``trials`` CUDA-event trials of ``calls`` calls
    after ``warmup`` calls, ``host_us`` the host's time over ``trials`` x
    ``calls`` calls (1,000 by default) divided by their number."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    events, host = tuple([] for _ in fns), [0.0] * len(fns)
    for _ in range(trials):
        for i, fn in enumerate(fns):
            events[i].append(event_ms(fn, calls))
        for i, fn in enumerate(fns):
            host[i] += host_s(fn, calls)
    return [{"ms": statistics.median(events[i]), "device_ms": device_ms(fn, reps=100),
             "host_us": host[i] * 1e6 / (trials * calls)} for i, fn in enumerate(fns)]


def layout_inputs(device):
    """The JAX probe script's seeded layout inputs: x (16, 8, 384), w (16, 16) and
    the rows10 probe's flat (16, 3840), fp32."""
    f = lambda seed, shape: torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(device)
    return f(0, (16, 8, 384)), f(1, (16, 16)), f(0, (16, 3840))


def layout_calls(probes, x, w, flat):
    """name -> (the kernel's wrapper, one PyTorch call of the same function)."""
    flat8 = x.reshape(16, -1)
    return {
        "gram": (lambda: probes.gram_rows(x), lambda: torch.mm(flat8, flat8.t())),
        "copy_scale": (lambda: probes.copy_scale(flat, (16, 10, 384), 2.0),
                       lambda: torch.mul(flat, 2.0).view(16, 10, 384)),
        "channel_mix": (lambda: probes.channel_mix(x, w),
                        lambda: torch.einsum("chw,cd->hdw", x, w)),
    }


def flash_calls(fa):
    """(forward, backward) of ``fa.flash_attention`` (the module
    ``ops/flash_attention.py`` of some checkout) at the probe's seeded (16, 12,
    256, 64) bf16 q, k, v: the forward on tensors that need no gradient, the
    backward ``torch.autograd.grad`` through one kept graph."""
    f = lambda seed: torch.from_numpy(0.3 * np.random.default_rng(seed).standard_normal(
        (16, 12, 256, 64)).astype(np.float32)).to(torch.bfloat16).cuda()
    q, k, v, g = (f(seed) for seed in range(4))
    scale = 64 ** -0.5
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = fa.flash_attention(qr, kr, vr, scale)
    return (lambda: fa.flash_attention(q, k, v, scale),
            lambda: torch.autograd.grad(out, (qr, kr, vr), g, retain_graph=True))


def grid_ms(probes, trials=5, calls=10, warmup=3):
    """Median CUDA-event ms per call of the grid probe's compute chain, const and
    base kernels through their public wrappers at the probe's seeded inputs (the
    same as ``probe_mosaic.grid_inputs``)."""
    f = lambda seed, shape: torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(torch.bfloat16).cuda()
    x, k, vec, we = (f(0, (16, 40, 232, 384)), f(1, (240, 9, 384)), f(2, (240, 1, 384)),
                     f(3, (40, 240)))
    fns = {"grid_compute": lambda: probes.grid_compute(x, we, k),
           "grid_const": lambda: probes.grid_const(x, k, vec),
           "grid_base": lambda: probes.grid_base(x)}
    out = {}
    for name, fn in fns.items():
        for _ in range(warmup):
            fn()
        out[name] = {"ms": statistics.median(event_ms(fn, calls) for _ in range(trials))}
    return out


def run(root: Path, grid: bool = False):
    """One JSON-able record: each wrapper's and library call's three numbers and
    the flash wrapper's, or with ``grid`` the grid compute chain's ms."""
    sys.path.insert(0, str(root))
    from mammo_clip_tpu_torch.ops import flash_attention, probes

    for mod in (probes, flash_attention):
        if not Path(mod.__file__).resolve().is_relative_to(root.resolve()):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    if grid:
        return {"root": str(root), "device": torch.cuda.get_device_name(0), **grid_ms(probes)}
    calls = layout_calls(probes, *layout_inputs("cuda"))
    for wrap, _ in calls.values():
        wrap()  # builds the library on the first call
    torch.cuda.synchronize()
    out = {"root": str(root), "device": torch.cuda.get_device_name(0)}
    for name, (wrap, library) in calls.items():
        out[name], out[f"{name}.library"] = compare(wrap, library)
    out["flash.forward"], out["flash.backward"] = compare(*flash_calls(flash_attention))
    if hasattr(probes, "empty_kernel"):
        out["empty"] = {"device_ms": device_ms(probes.empty_kernel, reps=100)}
    return out


def turns(old: Path, grid: bool = False):
    """old, this checkout, this checkout, old: one process each."""
    script = str(Path(__file__).resolve())
    records = []
    for root in (old, HERE_ROOT, HERE_ROOT, old):
        res = subprocess.run([sys.executable, script, "--root", str(root)]
                             + (["--grid"] if grid else []), capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"timing {root} failed ({res.returncode}):\n{res.stderr[-4000:]}")
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        records.append(json.loads(line))
    olds, news = (records[0], records[3]), (records[1], records[2])
    for key in (k for k in records[1] if isinstance(records[1][k], dict)):
        for field in records[1][key]:
            b = statistics.median(r[key][field] for r in news)
            if key not in records[0]:
                print(f"TURNS {key} {field}: new {b:.6g} (not in the old checkout)")
                continue
            a = statistics.median(r[key][field] for r in olds)
            print(f"TURNS {key} {field}: old {a:.6g}, new {b:.6g}, new/old {b / a:.3f}")
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE_ROOT,
                    help="checkout whose wrappers are timed (default: this one)")
    ap.add_argument("--turns", type=Path, metavar="OLD_DIR",
                    help="time OLD_DIR and this checkout in turns: old, new, new, old")
    ap.add_argument("--grid", action="store_true",
                    help="time the grid probe's compute chain instead of the layout kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: layout_timing measures the card")
    if args.turns is not None:
        return turns(args.turns, args.grid)
    res = run(args.root, args.grid)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
