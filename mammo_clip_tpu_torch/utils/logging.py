"""Metrics logging (port of ``mammo_clip_tpu/utils/logging.py``).

Losses return their sub-terms and the trainer logs them here. The logger is
plain and constructed with ``enabled``: the callers pass ``is_master()``
(``core/mesh.py``: rank 0 under data parallelism, else the one process), the
classifier loop also whether it has a workdir; a disabled logger writes nothing.

Backends, as in JAX: TensorBoard events under ``<workdir>/tensorboard/<prefix>``
when ``torch.utils.tensorboard`` imports (a lazy import in ``__init__``: the
``tensorboard`` package is optional, and the card machine has none), and always
the JSONL mirror ``<workdir>/metrics.jsonl``, one object per call:
``{"step", "prefix", "time", <scalar name>: value, ...}``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, workdir: str, enabled: bool = True):
        self.enabled = enabled
        self.workdir = workdir
        self._tb = {}
        self._tb_cls = None
        self._jsonl = None
        if not enabled:
            return
        os.makedirs(workdir, exist_ok=True)
        self._jsonl = open(os.path.join(workdir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb_cls = SummaryWriter

    def _writer(self, prefix: str):
        if self._tb_cls is None:
            return None
        if prefix not in self._tb:
            self._tb[prefix] = self._tb_cls(os.path.join(self.workdir, "tensorboard", prefix))
        return self._tb[prefix]

    def log(self, step: int, scalars: Dict[str, float], prefix: str = "train") -> None:
        if not self.enabled:
            return
        w = self._writer(prefix)
        if w is not None:
            for k, v in scalars.items():
                w.add_scalar(k, v, step)
        self._jsonl.write(
            json.dumps({"step": step, "prefix": prefix, "time": time.time(), **scalars}) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if not self.enabled:
            return
        for w in self._tb.values():
            w.close()
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
