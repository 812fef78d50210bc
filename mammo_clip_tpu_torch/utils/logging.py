"""Metrics logging (port of ``mammo_clip_tpu/utils/logging.py``).

Losses return their sub-terms and the trainer logs them here. The JAX logger
also writes TensorBoard events when a writer is importable, and is gated to
the master process; the port (one process) writes only the JSONL mirror, ``<workdir>/metrics.jsonl``, one object per call:
``{"step", "prefix", "time", <scalar name>: value, ...}``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, workdir: str):
        os.makedirs(workdir, exist_ok=True)
        self._jsonl = open(os.path.join(workdir, "metrics.jsonl"), "a")

    def log(self, step: int, scalars: Dict[str, float], prefix: str = "train") -> None:
        self._jsonl.write(
            json.dumps({"step": step, "prefix": prefix, "time": time.time(), **scalars}) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


class AverageMeter:
    """Running average (reference: src/codebase/utils.py:16-29)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
