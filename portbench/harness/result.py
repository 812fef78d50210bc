"""What a loop hands back, and the result line made of it.

A loop returns an ``Outcome``: its end-to-end readings, the ``Run`` record
that the per-layer readers read (``--trace 1``), the device reading, the
compared numbers with their limits, and how many operations it attempted
and how many failed. ``emit`` prints the compared numbers as the last lines
of standard error, then one JSON line on standard output.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import Dict, List, Optional, Tuple

from .compare import passed
from .trace import Profile


@dataclasses.dataclass
class Run:
    """What the per-layer readers read. ``spans``: host seconds by span name,
    one entry a step or batch; ``counters``: counts over the instrumented
    steps; ``step_s``: device-timeline seconds a step from CUDA events;
    ``profile``: the bounded profile of the window's last steps; ``shape``:
    the cell's sizes (config, traffic) for the readers' counts."""

    steps: int = 0
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    step_s: List[float] = dataclasses.field(default_factory=list)
    profile: Optional[Profile] = None
    config: Dict = dataclasses.field(default_factory=dict)
    traffic: Dict = dataclasses.field(default_factory=dict)
    peak: str = "bf16"  # the card's peak that the step's products run at (reference/flops.py)


@dataclasses.dataclass
class Outcome:
    metrics: Dict[str, float]  # end-to-end readings by name
    run: Run
    device: Dict
    checks: Dict[str, Dict[str, float]]
    attempted: int
    failed: int = 0


def _number(x: float):
    return x if math.isfinite(x) else None


def device_info(count: int, memory_peak_bytes: int) -> Dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(memory_peak_bytes)}


def per_layer(cell, run: Run) -> Dict[str, Dict]:
    out = {}
    for m in cell.per_layer:
        value = cell.metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(profile: Profile) -> Dict[str, List[Tuple[str, float]]]:
    return {"device_ops": [[n, s] for n, s in profile.top_ops(10)],
            "idle_gaps": [[n, s] for n, s in profile.idle_gaps(10)]}


def emit(cell, outcome: Outcome, trace: bool) -> None:
    correct = passed(outcome.checks)
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if trace:
        metrics = per_layer(cell, outcome.run)
    else:
        metrics = {n: {"value": outcome.metrics[n], "unit": units[n]} for n in units}
    device = dict(outcome.device)
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    profile = outcome.run.profile
    if trace and profile is not None:
        device["busy_s"] = profile.busy_s()
        device["window_s"] = profile.span_s()
        line["breakdown"] = breakdown(profile)
    line["checks"] = {n: {"value": _number(c["value"]), "limit": c["limit"]}
                      for n, c in outcome.checks.items()}
    sys.stdout.flush()
    for n, c in outcome.checks.items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
