"""int8 1x1 convolutions with straight-through gradients (port of
``mammo_clip_tpu/ops/quant.py``).

Scheme, as in JAX: dynamic symmetric quantisation, the activations per TENSOR
(``max|x| / 127``), the weights per OUTPUT channel (the columns of the (K, N)
matrix), both rounded half to even and clipped to +-127; the product
accumulates in int32 and is dequantised as ``acc * (sx * sw)`` in fp32, then
cast to ``out_dtype``. The backward is straight-through: it uses the
UNQUANTISED operands rounded to bf16, whatever the model's type, with the
products accumulated in fp32 (``_int8_dot_bwd``).

The int32 product is ``torch._int_mm``: JAX leaves it to XLA's ``dot_general``
(no Pallas kernel), so a library product stands in. On CUDA ``_int_mm`` takes
M > 16 rows and K and N multiples of 8; the operands are zero-padded to meet
that, which is exact. A float product is no substitute: K * 127^2 passes
fp32's exact integers (2^24) from K = 1041, and B5's k5 widths reach 1824.

``int8_conv1x1`` takes the port's layouts: an NCHW activation and an OIHW
(Cout, Cin, 1, 1) kernel, whose JAX (K, N) matrix is ``kernel[:, :, 0, 0].t()``.
The activation is quantised in NCHW and its int8 values permuted to (N*H*W, C)
rows, a quarter of the bytes of permuting fp32 values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MIN_ROWS = 17  # _int_mm on CUDA: more than 16 rows
_MULTIPLE = 8  # _int_mm on CUDA: K and N multiples of 8


def _over_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 rounded once, on every device: PyTorch multiplies a CUDA tensor
    by the reciprocal of a Python-number divisor, which can move the quotient by
    a bit from the CPU's and XLA's, and with it the scale and the int8 values."""
    return t / torch.full((), 127.0, device=t.device)


def quantize_per_tensor(x: torch.Tensor):
    """x -> (int8 values, fp32 scalar scale). Symmetric, dynamic."""
    xf = x.float()
    scale = _over_127(torch.clamp(xf.abs().amax(), min=1e-12))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_per_column(w: torch.Tensor):
    """(K, N) -> (int8, (N,) fp32 scales)."""
    wf = w.float()
    scale = _over_127(torch.clamp(wf.abs().amax(dim=0), min=1e-12))
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact, through ``torch._int_mm``
    with the operands zero-padded to its CUDA shape rules, ``a`` row-major and
    ``b`` column-major (cuBLASLt's int8 product refuses a row-major ``b`` at
    some shapes: CUBLAS_STATUS_NOT_SUPPORTED at (336, 24) x (24, 40) on an H100)."""
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = max(_MIN_ROWS - m, 0), -k % _MULTIPLE, -n % _MULTIPLE
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    if b.stride(0) != 1:
        b = b.t().contiguous().t()
    out = torch._int_mm(a.contiguous(), b)
    return out[:m, :n] if (pm or pn) else out


def _rows(t: torch.Tensor, channels_first: bool) -> torch.Tensor:
    """(..., C) -> (M, C) rows; with ``channels_first`` (N, C, H, W) -> (N*H*W, C)."""
    if channels_first:
        t = t.permute(0, 2, 3, 1)
    return t.reshape(-1, t.shape[-1])


def _bf16_in_fp32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16, held in fp32: a product of two such values is exact in
    fp32 (and in TF32), so an fp32 matmul of them is the bf16 product with fp32
    accumulation that JAX asks of ``dot_general``."""
    return t.to(torch.bfloat16).float()


class _Int8Dot(torch.autograd.Function):
    """x (..., K) or, with ``channels_first``, (N, K, H, W); w (K, N)."""

    @staticmethod
    def forward(ctx, x, w, out_dtype, channels_first):
        qx, sx = quantize_per_tensor(x)
        qw, sw = quantize_per_column(w)
        rows = _rows(qx, channels_first)
        acc = int_matmul(rows, qw)
        y = (acc.float() * (sx * sw)).to(out_dtype)
        if channels_first:
            n, _, h, wd = x.shape
            y = y.reshape(n, h, wd, -1).permute(0, 3, 1, 2).contiguous()
        else:
            y = y.reshape(*x.shape[:-1], w.shape[1])
        ctx.channels_first = channels_first
        ctx.save_for_backward(x, w)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        cf = ctx.channels_first
        gb = _bf16_in_fp32(_rows(g.to(torch.bfloat16), cf))
        dx = gb @ _bf16_in_fp32(w).t()
        dw = _bf16_in_fp32(_rows(x.to(torch.bfloat16), cf)).t() @ gb
        if cf:
            n, _, h, wd = x.shape
            dx = dx.reshape(n, h, wd, -1).permute(0, 3, 1, 2).contiguous()
        else:
            dx = dx.reshape(x.shape)
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def int8_dot(x: torch.Tensor, w: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Quantised ``x @ w``: an int8 forward, a straight-through bf16 backward.
    x: (..., K); w: (K, N). Returns (..., N) in ``out_dtype``."""
    return _Int8Dot.apply(x, w, out_dtype, False)


def int8_conv1x1(x: torch.Tensor, kernel: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """1x1 conv as an int8 matmul. x: (N, Cin, H, W); kernel: (Cout, Cin, 1, 1).
    Returns (N, Cout, H, W) in ``out_dtype``, contiguous."""
    return _Int8Dot.apply(x, kernel[:, :, 0, 0].t(), out_dtype, True)
