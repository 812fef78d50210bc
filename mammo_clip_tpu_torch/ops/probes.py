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

Layout probes (``_run`` over the Mosaic probes), fp32:

  gram_rows(x, width)            X X^T of each channel's rows flattened (only the
                                 first ``width`` values of each row count: the
                                 zero padding of ``concat_aligned``)
  copy_scale(x, shape, scale)    x * scale in another shape (the reshape probes)
  channel_mix(x, w)              o[h, c', w] = sum_c w[c, c'] x[c, h, w] (what
                                 ``dot_3d_rank3rhs`` means; the JAX probe
                                 contracts the wrong axis and fails, fault R6)

On a CUDA tensor each wrapper launches its kernel (grid kernels take bf16 x,
the layout kernels fp32) or raises; a CPU tensor takes the plain version.
``launches`` counts the kernel paths' calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .mbconv import LaunchCounter, _check

ROWS = 8  # the probe's tile height
launches = LaunchCounter([f"probe_grid.{k}" for k in ("base", "halo", "const", "compute")]
                         + [f"probe_layout.{k}" for k in ("gram", "copy_scale", "channel_mix")])


def _lib():
    from .cuda_lib import load

    return load()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


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


def plain_grid_compute(x, we, k):
    """The compute chain over the whole image at once (no tile touches another:
    the depthwise sum has no vertical halo), at the probe's rounding points."""
    C, W = x.shape[1], x.shape[3]
    z = torch.einsum("ce,nchw->nehw", we.float(), x.float()).to(torch.bfloat16)
    wpad = F.pad(F.silu(z.float()).to(torch.bfloat16), (1, 1))
    d = torch.zeros(z.shape, device=x.device, dtype=torch.float32)
    for a in range(3):
        for b in range(3):
            d = d + (wpad[..., b:b + W] * k[None, :, 3 * a + b, None, :]).float()
    return d[:, :C].sum((0, 2, 3)).view(-1, 1, 1)


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
    if x.dim() != 4 or x.shape[2] % ROWS:
        raise ValueError(f"x must be (N, C, H, W) with H % {ROWS} == 0, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"the grid probes run on CUDA or CPU tensors, got {x.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.shape[3] % 2:
        raise TypeError(f"x must be contiguous bfloat16 with an even W, got {x.dtype}, "
                        f"{tuple(x.shape)}")
    return True


def _check_on(t, x, shape, name):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != x.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
        raise TypeError(f"{name} must be contiguous bfloat16 on {x.device}")


def grid_sum_kernel(lib, kind: int, x, k=None, vec=None):
    """One call of the base (0), halo (1) or const (2) kernel and its reduction."""
    N, C, H, W = x.shape
    E = 0 if k is None else k.shape[0]
    part = torch.empty(N * H // ROWS, C, device=x.device, dtype=torch.float32)
    out = torch.empty(C, 1, 1, device=x.device, dtype=torch.float32)
    _check(lib.pr_grid_sum(kind, x.data_ptr(), None if k is None else k.data_ptr(),
                           None if vec is None else vec.data_ptr(), part.data_ptr(),
                           out.data_ptr(), N, C, E, H, W, _stream(x)), "pr_grid_sum")
    return out


def grid_compute_kernel(lib, x, we, k):
    N, C, H, W = x.shape
    E = we.shape[1]
    part = torch.empty(N * H // ROWS, E, device=x.device, dtype=torch.float32)
    out = torch.empty(C, 1, 1, device=x.device, dtype=torch.float32)
    _check(lib.pr_grid_compute(x.data_ptr(), we.data_ptr(), k.data_ptr(), part.data_ptr(),
                               out.data_ptr(), N, C, E, H, W, _stream(x)), "pr_grid_compute")
    return out


def grid_base(x):
    if not _check_grid_x(x):
        return plain_grid_base(x)
    with torch.cuda.device(x.device):
        out = grid_sum_kernel(_lib(), 0, x)
    launches.add("probe_grid.base")
    return out


def grid_halo(x):
    if not _check_grid_x(x):
        return plain_grid_halo(x)
    with torch.cuda.device(x.device):
        out = grid_sum_kernel(_lib(), 1, x)
    launches.add("probe_grid.halo")
    return out


def grid_const(x, k, vec):
    """k (E, 9, W) and vec (E, 1, W), bf16 on the card."""
    on_card = _check_grid_x(x)
    E, W = k.shape[0], x.shape[3]
    if k.dim() != 3 or k.shape[1:] != (9, W) or vec.shape != (E, 1, W):
        raise ValueError(f"k must be (E, 9, {W}) and vec (E, 1, {W}), got {tuple(k.shape)}, "
                         f"{tuple(vec.shape)}")
    if not on_card:
        return plain_grid_const(x, k, vec)
    _check_on(k, x, (E, 9, W), "k")
    _check_on(vec, x, (E, 1, W), "vec")
    with torch.cuda.device(x.device):
        out = grid_sum_kernel(_lib(), 2, x, k, vec)
    launches.add("probe_grid.const")
    return out


def grid_compute(x, we, k):
    """we (C, E) with E >= C and k (E, 9, W), bf16 on the card."""
    on_card = _check_grid_x(x)
    C, W = x.shape[1], x.shape[3]
    if we.dim() != 2 or we.shape[0] != C or we.shape[1] < C or k.shape != (we.shape[1], 9, W):
        raise ValueError(f"we must be ({C}, E >= {C}) and k (E, 9, {W}), got "
                         f"{tuple(we.shape)}, {tuple(k.shape)}")
    if not on_card:
        return plain_grid_compute(x, we, k)
    _check_on(we, x, tuple(we.shape), "we")
    _check_on(k, x, tuple(k.shape), "k")
    with torch.cuda.device(x.device):
        out = grid_compute_kernel(_lib(), x, we, k)
    launches.add("probe_grid.compute")
    return out


def _check_layout(*ts):
    """True when the tensors are on the card (and fit the kernels), False on the CPU."""
    x = ts[0]
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"the layout probes run on CUDA or CPU tensors, got {x.device}")
    for t in ts:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"the layout kernels take contiguous float32 tensors on {x.device}")
    return True


def gram_rows(x, width=None):
    """x (C, R, L): the C x C Gram matrix of each channel's rows, each row cut to
    its first ``width`` values (all L when None)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (C, R, L), got {tuple(x.shape)}")
    C, R, L = x.shape
    width = L if width is None else width
    if not 1 <= width <= L:
        raise ValueError(f"width must be in 1..{L}, got {width}")
    if not _check_layout(x):
        return plain_gram_rows(x, width)
    out = torch.empty(C, C, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _check(_lib().pr_gram(x.data_ptr(), out.data_ptr(), C, R, width, L, _stream(x)),
               "pr_gram")
    launches.add("probe_layout.gram")
    return out


def copy_scale(x, shape, scale: float = 1.0):
    """x * scale as a new contiguous tensor of ``shape`` (same number of elements)."""
    shape = tuple(shape)
    if x.numel() != torch.Size(shape).numel():
        raise ValueError(f"cannot copy {tuple(x.shape)} into {shape}")
    if not _check_layout(x):
        return plain_copy_scale(x, shape, scale)
    out = torch.empty(shape, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _check(_lib().pr_copy_scale(x.data_ptr(), out.data_ptr(), x.numel(), float(scale),
                                    _stream(x)), "pr_copy_scale")
    launches.add("probe_layout.copy_scale")
    return out


def channel_mix(x, w):
    """x (C, H, W), w (C, C2) -> (H, C2, W): sum over c of w[c, c'] x[c, h, w]."""
    if x.dim() != 3 or w.dim() != 2 or w.shape[0] != x.shape[0]:
        raise ValueError(f"x must be (C, H, W) and w (C, C2), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if not _check_layout(x, w):
        return plain_channel_mix(x, w)
    C, H, W = x.shape
    out = torch.empty(H, w.shape[1], W, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _check(_lib().pr_channel_mix(x.data_ptr(), w.data_ptr(), out.data_ptr(), C, w.shape[1],
                                     H, W, _stream(x)), "pr_channel_mix")
    launches.add("probe_layout.channel_mix")
    return out
