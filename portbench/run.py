"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernels' build on a checkout's first run, the program's
state, weights and inputs from the seed, the checked first steps or
batches) runs first and is timed from the process's start; then the window
runs for ``--seconds``; then, with the window closed and the program's state
freed, the plain reference checks what the window's path produced. With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, a profile of the window's last steps
and the device's busy seconds. The last lines of standard error and the
line's last key give each compared number beside its limit.

The run needs as many CUDA cards as the cell asks for, and exits non-zero
without a result otherwise, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys
import time

_START = time.perf_counter()  # the fallback start when /proc gives none

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mammo_clip_tpu")


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _START


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (whole names: the port's begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_environment(root) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(root, ".portbench_cache")
    os.environ.setdefault("USE_FLAX", "0")
    for key, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[key] = os.path.join(cache, sub)
        os.makedirs(os.environ[key], exist_ok=True)


def parse(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    started = process_start()
    args = parse(argv)
    from .harness import manifest, result

    cache_environment(str(manifest.ROOT))
    cell = manifest.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    outcome = cell.loop().run(cell, args.seed, args.seconds, bool(args.trace), started)
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}: the benchmark may not load JAX or the "
              "JAX package", file=sys.stderr)
        return 3
    result.emit(cell, outcome, bool(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
