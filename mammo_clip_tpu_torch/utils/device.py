"""The device an entry point runs on."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``, refused before any work when it names a
    card that is not there: no CUDA device at all, or an index past the last
    one. There is no fallback to the CPU; ask for ``cpu`` to run there."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested, but no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")
        count = torch.cuda.device_count()
        if device.index is not None and device.index >= count:
            raise RuntimeError(f"device {device} requested, but there are only {count} "
                               "CUDA devices")
    return device


@contextlib.contextmanager
def full_fp32():
    """fp32 matrix products and cuDNN convolutions in full fp32 for the span:
    TF32 off (torch lets cuDNN take TF32 by default), the flags restored after."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
