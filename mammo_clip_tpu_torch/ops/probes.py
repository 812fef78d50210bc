"""The functions of the TPU probes in ``benchmarks/probe_mosaic.py``, as kernels of
``csrc/probes.cu`` beside their plain PyTorch versions.

Grid probes (``probe_grid_overhead``), over x (N, C, H, W) in 8-row tiles, each
returning a (C, 1, 1) fp32 sum as the Pallas kernels do:

  grid_base(x)             sum over n, h, w of x
  grid_halo(x)             base plus each tile's clamped halo rows (row
                           8*max(i-1,0)+7 above, 8*min(i+1,H/8-1) below),
                           broadcast over the tile's 8 rows
  grid_const(x, k, vec)    base plus N*(H/8)*8*W*(sum k[:,0,:] + sum vec)
  grid_compute(x, we, k)   per tile z = We^T x (stored bf16), SiLU in bf16, the
                           9-tap horizontal depthwise sum with bf16 products and
                           fp32 sums, then the sum of its first C channels
  grid_compute_channel_sums(x, we, k)
                           the same chain's sums for all E channels (E,): what
                           the kernel computes; grid_compute is its first C

Layout probes (``_run`` over the Mosaic probes), fp32:

  gram_rows(x, width)            X X^T of each channel's rows flattened (only the
                                 first ``width`` values of each row count: the
                                 zero padding of ``concat_aligned``)
  copy_scale(x, shape, scale)    x * scale in another shape (the reshape probes)
  channel_mix(x, w)              o[h, c', w] = sum_c w[c, c'] x[c, h, w] (what
                                 ``dot_3d_rank3rhs`` means; the JAX probe
                                 contracts the wrong axis and fails, fault R6)

``empty_kernel(device)`` launches a kernel that does nothing: the least device
time a launch takes, timed beside the layout kernels (uncounted, on no probe's
path).

On a CUDA tensor each wrapper launches its kernel (grid kernels take bf16 x,
the layout kernels fp32) or raises; a CPU tensor takes the plain version.
``launches`` counts the kernel paths' calls. The wrappers launch through
``cuda_lib.launcher``, bound once, and check their tensors by plain attribute
reads (device index, dtype, contiguity), so that a call of a layout kernel,
whose device work is a few microseconds, costs the host little more than the
ctypes call and the launch itself.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .cuda_lib import launcher
from .mbconv import LaunchCounter

ROWS = 8  # the probe's tile height
launches = LaunchCounter([f"probe_grid.{k}" for k in ("base", "halo", "const", "compute")]
                         + [f"probe_layout.{k}" for k in ("gram", "copy_scale", "channel_mix")])
_grid_sum, _grid_const = launcher("pr_grid_sum"), launcher("pr_grid_const")
_grid_compute = launcher("pr_grid_compute")
CONST_PARTS = 2048  # partial rows the const kernel may use: its grid is at most this
COMPUTE_COLS, COMPUTE_MAX_C = 64, 48  # the compute kernel's column range, and its limit on C
_gram, _copy_scale = launcher("pr_gram"), launcher("pr_copy_scale")
_channel_mix, _empty = launcher("pr_channel_mix"), launcher("pr_empty")
_F32 = torch.float32


def _halo_rows(H: int):
    """Row indices of each tile's clamped top and bottom halo rows."""
    i = torch.arange(H // ROWS)
    return ROWS * (i - 1).clamp(min=0) + ROWS - 1, ROWS * (i + 1).clamp(max=H // ROWS - 1)


# ----------------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------------


def plain_grid_base(x):
    return x.float().sum((0, 2, 3)).view(-1, 1, 1)


def plain_grid_halo(x):
    xf = x.float()
    top, bot = _halo_rows(x.shape[2])
    halo = xf[:, :, top.to(x.device)].sum((0, 2, 3)) + xf[:, :, bot.to(x.device)].sum((0, 2, 3))
    return (xf.sum((0, 2, 3)) + ROWS * halo).view(-1, 1, 1)


def plain_grid_const(x, k, vec):
    N, _, H, W = x.shape
    bank = k[:, 0, :].float().sum() + vec.float().sum()
    return (x.float().sum((0, 2, 3)) + N * (H // ROWS) * ROWS * W * bank).view(-1, 1, 1)


def plain_grid_compute_channel_sums(x, we, k):
    """The compute chain over the whole image at once (no tile touches another:
    the depthwise sum has no vertical halo), at the probe's rounding points: the
    sum of d over (n, h, w) for each of the E expanded channels."""
    W = x.shape[3]
    z = torch.einsum("ce,nchw->nehw", we.float(), x.float()).to(torch.bfloat16)
    wpad = F.pad(F.silu(z.float()).to(torch.bfloat16), (1, 1))
    d = torch.zeros(z.shape, device=x.device, dtype=torch.float32)
    for a in range(3):
        for b in range(3):
            d = d + (wpad[..., b:b + W] * k[None, :, 3 * a + b, None, :]).float()
    return d.sum((0, 2, 3))


def plain_grid_compute(x, we, k):
    """The probe's output: the channel sums of its first C channels, (C, 1, 1)."""
    return plain_grid_compute_channel_sums(x, we, k)[:x.shape[1]].view(-1, 1, 1)


def plain_gram_rows(x, width=None):
    flat = x[..., :width].reshape(x.shape[0], -1).float()
    return flat @ flat.t()


def plain_copy_scale(x, shape, scale: float = 1.0):
    return (x * scale).reshape(shape)


def plain_channel_mix(x, w):
    return torch.einsum("chw,cd->hdw", x, w)


# ----------------------------------------------------------------------------
# kernel paths
# ----------------------------------------------------------------------------


def _check_grid_x(x):
    """The CUDA device index of x when it is on the card (and fits the kernels), -1
    on the CPU."""
    if x.dim() != 4 or x.shape[2] % ROWS:
        raise ValueError(f"x must be (N, C, H, W) with H % {ROWS} == 0, got {tuple(x.shape)}")
    if not x.is_cuda:
        if x.is_cpu:
            return -1
        raise ValueError(f"the grid probes run on CUDA or CPU tensors, got {x.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.shape[3] % 2:
        raise TypeError(f"x must be contiguous bfloat16 with an even W, got {x.dtype}, "
                        f"{tuple(x.shape)}")
    if x.data_ptr() % 4:
        raise ValueError("x must start on a 4-byte boundary (the kernels read bf16 pairs)")
    return x.get_device()


def _check_on(t, device, shape, name):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if t.get_device() != device or t.dtype != torch.bfloat16 or not t.is_contiguous():
        raise TypeError(f"{name} must be contiguous bfloat16 on cuda:{device}")


def grid_sum_kernel(kind: int, x):
    """One call of the base (0) or halo (1) kernel and its reduction (uncounted:
    the wrappers count)."""
    N, C, H, W = x.shape
    part = x.new_empty((N * H // ROWS, C), dtype=_F32)
    out = x.new_empty((C, 1, 1), dtype=_F32)
    _grid_sum(x.get_device(), kind, x.data_ptr(), part.data_ptr(), out.data_ptr(), N, C, H, W)
    return out


def grid_const_kernel(x, k, vec):
    """One call of the const kernel and its reduction (uncounted: the wrappers
    count). x streams through the bulk-copy ring when it is 16-byte aligned, else
    by 4-byte loads into registers."""
    N, C, H, W = x.shape
    parts = min(N * C * H // ROWS, CONST_PARTS)
    part = x.new_empty((parts, C + 1), dtype=_F32)
    out = x.new_empty((C, 1, 1), dtype=_F32)
    _grid_const(x.get_device(), x.data_ptr(), k.data_ptr(), vec.data_ptr(), part.data_ptr(), parts,
                out.data_ptr(), N, C, k.shape[0], H, W)
    return out


def grid_compute_kernel(x, we, k):
    """One call of the compute kernel and its reduction: the (E,) channel sums
    (uncounted: the wrappers count). ``part`` has room for the most partial rows
    the launcher can ask for: one per tile and 64-column range."""
    N, C, H, W = x.shape
    E = we.shape[1]
    parts = N * H // ROWS * -(-W // COMPUTE_COLS)
    part = x.new_empty((parts, E), dtype=_F32)
    out = x.new_empty((E,), dtype=_F32)
    _grid_compute(x.get_device(), x.data_ptr(), we.data_ptr(), k.data_ptr(), part.data_ptr(),
                  parts, out.data_ptr(), N, C, E, H, W)
    return out


def grid_base(x):
    if _check_grid_x(x) < 0:
        return plain_grid_base(x)
    out = grid_sum_kernel(0, x)
    launches.add("probe_grid.base")
    return out


def grid_halo(x):
    if _check_grid_x(x) < 0:
        return plain_grid_halo(x)
    out = grid_sum_kernel(1, x)
    launches.add("probe_grid.halo")
    return out


def grid_const(x, k, vec):
    """k (E, 9, W) and vec (E, 1, W), bf16 on the card."""
    device = _check_grid_x(x)
    E, W = k.shape[0], x.shape[3]
    if k.dim() != 3 or k.shape[1:] != (9, W) or vec.shape != (E, 1, W):
        raise ValueError(f"k must be (E, 9, {W}) and vec (E, 1, {W}), got {tuple(k.shape)}, "
                         f"{tuple(vec.shape)}")
    if device < 0:
        return plain_grid_const(x, k, vec)
    _check_on(k, device, (E, 9, W), "k")
    _check_on(vec, device, (E, 1, W), "vec")
    out = grid_const_kernel(x, k, vec)
    launches.add("probe_grid.const")
    return out


def grid_compute_channel_sums(x, we, k):
    """we (C, E) with E >= C and k (E, 9, W), bf16 on the card (C <= 48 there):
    the compute chain's (E,) channel sums."""
    device = _check_grid_x(x)
    C, W = x.shape[1], x.shape[3]
    if we.dim() != 2 or we.shape[0] != C or we.shape[1] < C or k.shape != (we.shape[1], 9, W):
        raise ValueError(f"we must be ({C}, E >= {C}) and k (E, 9, {W}), got "
                         f"{tuple(we.shape)}, {tuple(k.shape)}")
    if device < 0:
        return plain_grid_compute_channel_sums(x, we, k)
    if C > COMPUTE_MAX_C:
        raise ValueError(f"the compute kernel takes C <= {COMPUTE_MAX_C}, got {C}")
    _check_on(we, device, tuple(we.shape), "we")
    _check_on(k, device, tuple(k.shape), "k")
    out = grid_compute_kernel(x, we, k)
    launches.add("probe_grid.compute")
    return out


def grid_compute(x, we, k):
    """The probe's output (C, 1, 1): the first C of ``grid_compute_channel_sums``."""
    return grid_compute_channel_sums(x, we, k)[:x.shape[1]].view(-1, 1, 1)


def _layout_device(x, w=None):
    """The CUDA device index of the tensors when they are on the card (and fit the
    kernels), -1 when x is on the CPU; raises for anything else."""
    if not x.is_cuda:
        if x.is_cpu:
            return -1
        raise ValueError(f"the layout probes run on CUDA or CPU tensors, got {x.device}")
    device = x.get_device()
    if x.dtype is not _F32 or not x.is_contiguous() or w is not None and (
            w.get_device() != device or w.dtype is not _F32 or not w.is_contiguous()):
        raise TypeError(f"the layout kernels take contiguous float32 tensors on {x.device}")
    return device


def gram_rows(x, width=None):
    """x (C, R, L): the C x C Gram matrix of each channel's rows, each row cut to
    its first ``width`` values (all L when None)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (C, R, L), got {tuple(x.shape)}")
    C, R, L = x.shape
    width = L if width is None else width
    if not 1 <= width <= L:
        raise ValueError(f"width must be in 1..{L}, got {width}")
    device = _layout_device(x)
    if device < 0:
        return plain_gram_rows(x, width)
    out = x.new_empty((C, C))
    _gram(device, x.data_ptr(), out.data_ptr(), C, R, width, L)
    launches.add("probe_layout.gram")
    return out


def copy_scale(x, shape, scale: float = 1.0):
    """x * scale as a new contiguous tensor of ``shape`` (same number of elements)."""
    n = x.numel()
    if n != math.prod(shape):
        raise ValueError(f"cannot copy {tuple(x.shape)} into {tuple(shape)}")
    device = _layout_device(x)
    if device < 0:
        return plain_copy_scale(x, tuple(shape), scale)
    out = x.new_empty(shape)
    _copy_scale(device, x.data_ptr(), out.data_ptr(), n, scale)
    launches.add("probe_layout.copy_scale")
    return out


def channel_mix(x, w):
    """x (C, H, W), w (C, C2) -> (H, C2, W): sum over c of w[c, c'] x[c, h, w]."""
    if x.dim() != 3 or w.dim() != 2 or w.shape[0] != x.shape[0]:
        raise ValueError(f"x must be (C, H, W) and w (C, C2), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    device = _layout_device(x, w)
    if device < 0:
        return plain_channel_mix(x, w)
    C, H, W = x.shape
    out = x.new_empty((H, w.shape[1], W))
    _channel_mix(device, x.data_ptr(), w.data_ptr(), out.data_ptr(), C, w.shape[1], H, W)
    launches.add("probe_layout.channel_mix")
    return out


def empty_kernel(device: int = 0):
    """One launch of a kernel that does nothing, on CUDA device ``device``: the
    card's least time per launch, timed beside the layout kernels (on no probe's
    path, uncounted)."""
    _empty(device)
