"""The readings that a cell's correctness limits are set from.

    python3 -m portbench.readings --workload <name> --seeds 1 2 3 ... [--controls fp8 rows]

For each seed, in one process: the program's set-up and checked steps (or
batches) at the cell's own sizes, without a window, against the fp32
reference (the lower reading), and each control against the same reference:
the reference in a lower precision (``fp8``, ``bf16``) or on half of every
batch (``rows``, training only). One JSON line a seed; the benchmark's own
runs never run this.
"""

from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", nargs="*", default=())
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from .harness import manifest
    from .run import cache_environment, forbidden_loaded

    cache_environment(str(manifest.ROOT))
    cell = manifest.resolve(args.workload)
    loop = cell.loop()
    for seed in args.seeds:
        out = loop.readings(cell, seed, args.device, tuple(args.controls))
        print(json.dumps({"workload": cell.name, "seed": seed, **out}), flush=True)
    if forbidden_loaded():
        print(f"loaded {forbidden_loaded()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
