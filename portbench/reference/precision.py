"""The arithmetic a reference computes in.

``fp32`` is the reference itself: every operand and result in float32, with
TF32 off (``fp32_only``). The lower precisions serve as the controls that a
correctness limit has to reject: each rounds the operands of every
convolution and matrix product on the way in, and their results on the way
out, and the gradients that flow back through them likewise.

* ``bf16``: operands and results rounded to bfloat16 (fp32 accumulation, as
  a tensor core does).
* ``fp8``: operands scaled per tensor into float8 e4m3 (gradients e5m2) and
  results rounded to bfloat16, the usual fp8 training recipe: the control of
  a bf16 configuration.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _scaled(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


def _round(t: torch.Tensor, kind: str, backward: bool) -> torch.Tensor:
    if kind == "bf16":
        return t.to(torch.bfloat16).to(t.dtype)
    if kind == "fp8":
        return (_scaled(t, torch.float8_e5m2, E5M2_MAX) if backward
                else _scaled(t, torch.float8_e4m3fn, E4M3_MAX))
    raise ValueError(kind)


class _Rounded(torch.autograd.Function):
    """Identity that rounds the value going forward and the gradient coming back."""

    @staticmethod
    def forward(ctx, t, kind):
        ctx.kind = kind
        return _round(t, kind, backward=False)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.kind, backward=True), None


class Precision:
    """``operand(t)`` before a product, ``result(t)`` after it."""

    NAMES = ("fp32", "bf16", "fp8")

    def __init__(self, name: str = "fp32"):
        if name not in self.NAMES:
            raise ValueError(f"unknown precision {name!r}; one of {self.NAMES}")
        self.name = name

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return t
        return _Rounded.apply(t, self.name)

    def result(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return t
        return _Rounded.apply(t, "bf16")


@contextlib.contextmanager
def fp32_only():
    """TF32 off for matrix products and cuDNN convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
