"""Profiling hooks (port of ``mammo_clip_tpu/utils/profiling.py``).

``profile_trace`` wraps a code region with ``torch.profiler`` (CPU activity, and
CUDA activity when a card is in use) and writes a Chrome trace into ``logdir``
(``trace.json``; open it in Perfetto or ``chrome://tracing``); ``step_timer``
measures step latency honestly by fetching a scalar from each call's output,
so the host waits for the device's work, as the JAX function does.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, List

import torch


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the region; on exit write ``<logdir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else out
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


def step_timer(fn: Callable, *args, iters: int = 10, sync_value=None) -> List[float]:
    """Time ``fn(*args)`` per call; each call is synced by fetching a scalar from
    its output (``sync_value(out)``, else the sum of its first tensor). Returns
    per-call seconds."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        if sync_value is not None:
            _ = float(sync_value(out))
        else:
            _ = float(_first_tensor(out).float().sum())
        times.append(time.perf_counter() - t0)
    return times
