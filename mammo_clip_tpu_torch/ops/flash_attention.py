"""Flash attention: the port of the stock Pallas TPU kernel that
``benchmarks/probe_flash_attention.py::flash_attention_bnsd`` calls
(``jax.experimental.pallas.ops.tpu.flash_attention``).

``flash_attention(q, k, v, sm_scale)`` computes non-causal softmax attention of
(B, N, S, D) tensors with no mask and no bias, ``softmax(q k^T * sm_scale) v``,
with the softmax statistics and the accumulation in fp32 and the output in q's
dtype (fp32 or bf16); its gradient gives dq, dk, dv in that dtype. On a CUDA
tensor it runs the hand-written kernels of ``csrc/flash_attention.cu`` (a
forward that keeps the (S, S) scores on chip and writes the log-sum-exp, and a
three-launch backward that recomputes them): bf16 on the tensor cores, with P
and dS rounded to bf16 before their products as the TPU kernel rounds them,
fp32 in fp32 FMA. D may be at most 128 and S is free. A CPU tensor takes the
plain PyTorch version (``plain_flash_attention``), which materializes the
scores in fp32 and rounds once at the output. ``launches`` counts the kernel
path's calls. The kernels launch through ``cuda_lib.launcher`` (the device index
and PyTorch's current raw stream passed to the C launcher, no device context
and no ``Stream`` object per call).

The forward launch is the operator ``torch.ops.mammo_clip_tpu_torch.flash_forward``
(``torch.library.custom_op``, CUDA only), with a fake implementation that gives
``o`` and ``lse`` their shapes and types: ``torch.export`` traces the model
with tensors that have no data, and keeps the operator as a node of the graph,
so an artifact exported on a card launches the kernel when it runs. A serving
process imports this module before it loads such an artifact, which registers
the operator (``utils/export.py``'s ``requires``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .cuda_lib import launcher
from .mbconv import LaunchCounter

launches = LaunchCounter(("flash_attention.forward", "flash_attention.backward"))
_fa_forward, _fa_backward = launcher("fa_forward"), launcher("fa_backward")


def plain_flash_attention(q, k, v, sm_scale: float):
    """The kernel's function in plain PyTorch: fp32 scores, softmax and products,
    the output cast to q's dtype (autograd casts the gradients back the same way)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


@torch.library.custom_op("mammo_clip_tpu_torch::flash_forward", mutates_args=(),
                         device_types="cuda")
def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel: (o, lse) with lse (B, N, S) fp32."""
    B, N, S, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, N, S, device=q.device, dtype=torch.float32)
    _fa_forward(q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                int(q.dtype == torch.bfloat16), o.data_ptr(), lse.data_ptr(), B * N, S, D,
                float(sm_scale))
    launches.add("flash_attention.forward")
    return o, lse


@flash_forward.register_fake
def _flash_forward_fake(q, k, v, sm_scale):
    B, N, S, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, N, S), dtype=torch.float32)


def flash_backward(q, k, v, o, lse, g, sm_scale: float):
    """The backward's three launches: (dq, dk, dv) in q's dtype."""
    B, N, S, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dvec = torch.empty(B, N, S, device=q.device, dtype=torch.float32)
    _fa_backward(q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 g.data_ptr(), lse.data_ptr(), int(q.dtype == torch.bfloat16), dvec.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B * N, S, D, float(sm_scale))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, lse = flash_forward(q, k, v, sm_scale)
        ctx.sm_scale = sm_scale
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        dq, dk, dv = flash_backward(q, k, v, o, lse, g, ctx.sm_scale)
        launches.add("flash_attention.backward")
        return dq, dk, dv, None


def _validate(q, k, v):
    """Raise on what the kernel does not take (the CPU plain version too, for shapes)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, N, S, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[2] < 1 or not 1 <= q.shape[3] <= 128:
        raise ValueError(f"flash_attention takes S >= 1 and D <= 128, got {tuple(q.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must be float32 or bfloat16, got {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous (B, N, S, D)")


def flash_attention(q, k, v, sm_scale: float):
    """softmax(q k^T * sm_scale) v of contiguous (B, N, S, D) fp32 or bf16 tensors,
    D <= 128, non-causal and unmasked; differentiable in q, k and v."""
    _validate(q, k, v)
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, sm_scale)
    return _FlashAttention.apply(q, k, v, sm_scale)
