"""Card probes of the functions behind ``benchmarks/probe_mosaic.py``'s Mosaic
probes (port of that script; it keeps its name so a reader finds the
counterpart).

The TPU script asks whether Mosaic lowers one layout-sensitive primitive per
probe, a question without a CUDA meaning; each probe still computes a function,
and that function is what runs here, through the hand kernels of
``csrc/probes.cu`` (``ops/probes.py``), on the same seeded inputs. Layout
probes print the JAX script's line, ``PROBE <name>: OK <shape> sum=<sum>``:

  concat_aligned, reshape_collapse, reshape_collapse_rows10   gram_rows
  reshape_split, sublane_stack, reshape_split_rows10          copy_scale
  dot_3d (dot_3d_rank3rhs)                                    channel_mix

(the JAX ``dot_3d`` probe contracts w's channels with x's rows and fails on
every backend, fault R6; the port computes what its docstring means, an
output of (H, C, WP)). ``grid_overhead`` times the four grid kernels over x
(16, 40, 232, 384) bf16 in 8-row tiles, one block per (image, tile), the best
of 4 groups of 10 calls (CUDA events), and prints ms and us per block.

Usage: python -m mammo_clip_tpu_torch.benchmarks.probe_mosaic [probe ...] [--device cuda]
(default: all)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import probes

C, H, W = 16, 8, 380
WP = 384  # W padded to the lane tile
R10 = 10  # the rows10 probes' row count (halo tiles are 8 + 2 rows)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _run(name, fn, device, *arrays):
    """One layout probe: ``fn`` on the arrays moved to ``device``; prints its line."""
    r = fn(*[torch.from_numpy(a).to(device) for a in arrays])
    print(f"PROBE {name}: OK {tuple(r.shape)} sum={float(r.sum()):.3f}")
    return r


def probe_concat_aligned(device):
    """Gram of the rows padded W -> WP (the padded buffer read in place)."""
    return _run("concat_aligned", lambda x: probes.gram_rows(F.pad(x, (0, WP - W)), W), device,
                _normal(0, (C, H, W)))


def probe_reshape_collapse(device):
    return _run("reshape_collapse", probes.gram_rows, device, _normal(0, (C, H, WP)))


def probe_reshape_split(device):
    return _run("reshape_split", lambda x: probes.copy_scale(x, (C, H, WP)), device,
                _normal(0, (C, H, WP)))


def probe_sublane_stack(device):
    return _run("sublane_stack", lambda x: probes.copy_scale(x, (C, H, WP)), device,
                _normal(0, (C, H * WP)))


def probe_dot_3d_batch(device):
    """o[h, c', w] = sum_c w[c, c'] x[c, h, w]: (H, C, WP)."""
    return _run("dot_3d_rank3rhs", probes.channel_mix, device, _normal(0, (C, H, WP)),
                _normal(1, (C, C)))


def probe_reshape_collapse_rows10(device):
    return _run("reshape_collapse_rows10", probes.gram_rows, device, _normal(0, (C, R10, WP)))


def probe_reshape_split_rows10(device):
    return _run("reshape_split_rows10", lambda x: probes.copy_scale(x, (C, R10, WP), 2.0), device,
                _normal(0, (C, R10 * WP)))


def grid_inputs(device, N=16, C=40, E=240, H=232, W=384):
    """x, k, vec, we of the grid probe, bf16, each from its own ``default_rng``."""
    f = lambda seed, shape: torch.from_numpy(_normal(seed, shape)).to(torch.bfloat16).to(device)
    return f(0, (N, C, H, W)), f(1, (E, 9, W)), f(2, (E, 1, W)), f(3, (C, E))


def _timed(name, fn, device, blocks, iters=4, group=10):
    """Best ms per call over ``iters`` groups of ``group`` calls."""
    on_card = torch.device(device).type == "cuda"
    fn()
    best = float("inf")
    for _ in range(iters):
        if on_card:
            torch.cuda.synchronize()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
        start = time.perf_counter()
        for _ in range(group):
            fn()
        if on_card:
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1) / group
        else:
            ms = (time.perf_counter() - start) * 1e3 / group
        best = min(best, ms)
    print(f"PROBE {name}: {best:.4f} ms ({best * 1e3 / blocks:.3f} us per block)")
    return best


def probe_grid_overhead(device):
    """The per-block cost of the tiling: halo rows, a resident bank, the compute
    chain. Grid (16, 29) blocks, C=40/E=240, W=384, 8-row tiles."""
    x, k, vec, we = grid_inputs(device)
    blocks = x.shape[0] * x.shape[2] // probes.ROWS
    return {
        "base": _timed("grid_base(main only)", lambda: probes.grid_base(x), device, blocks),
        "halo": _timed("grid_halo(min/max maps)", lambda: probes.grid_halo(x), device, blocks),
        "const": _timed("grid_const(resident bank)", lambda: probes.grid_const(x, k, vec), device,
                        blocks),
        "compute": _timed("grid_compute(z+silu+dw, no halo)", lambda: probes.grid_compute(x, we, k),
                          device, blocks),
    }


PROBES = {
    "concat_aligned": probe_concat_aligned,
    "reshape_collapse": probe_reshape_collapse,
    "reshape_split": probe_reshape_split,
    "sublane_stack": probe_sublane_stack,
    "dot_3d": probe_dot_3d_batch,
    "reshape_collapse_rows10": probe_reshape_collapse_rows10,
    "reshape_split_rows10": probe_reshape_split_rows10,
    "grid_overhead": probe_grid_overhead,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probes", nargs="*", choices=[[], *PROBES], metavar="probe",
                    help=f"any of {', '.join(PROBES)} (default: all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --device cpu to probe the plain versions")
    return {name: PROBES[name](args.device) for name in args.probes or list(PROBES)}


if __name__ == "__main__":
    main()
