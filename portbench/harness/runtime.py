"""What every loop does around the program: wait for the card, free memory,
and log how long a stage of set-up took."""

from __future__ import annotations

import gc
import sys
import time

import torch

GIB = 1024 ** 3


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def note(what: str, since: float) -> float:
    """Print how long ``what`` took to standard error; returns the clock."""
    now = time.perf_counter()
    print(f"portbench: {what} {now - since:.3f} s", file=sys.stderr, flush=True)
    return now
