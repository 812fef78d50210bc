"""ctypes bindings for the native preprocessing library (``preprocess/native/``),
and a plain numpy version of each native function.

The library is host code (no device op runs on this path): ``mammo_native.cpp``
built with ``g++ -O3 -shared -fPIC -std=c++17`` at first use, never at import,
into ``mammo_clip_tpu_torch/build/``, named by a hash of its sources and flags
and compiled to a temporary file that ``os.replace`` puts in place, so several
processes may build at once. ``load_native()`` returns None where no compiler
is present or the build fails; callers then take the plain versions.

The plain versions carry the native semantics (they are not
``breast_crop.py``'s numpy path):

* ``normalize_u16_to_u8_plain``: float32 min-max, inverted *after* scaling,
  rounded with ``+0.5``; it differs from ``normalize_dicom_pixels`` (invert
  first, truncate) by up to one grey level;
* ``area_resize_plain``: the separable float32 box filter of
  ``area_resize_u8``, taps and summation order included (the port's
  no-compiler path in place of ``cv2.resize(INTER_AREA)``);
* crop bounds are ``breast_crop.breast_roi_bounds`` itself;
* ``clahe_plain``: ``clahe_u8``'s tile LUTs and bilinear blend in float32;
* ``png_unfilter_plain``: the five PNG row filters (``data/png.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .breast_crop import breast_roi_bounds

PACKAGE_DIR = Path(__file__).resolve().parent.parent
NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = PACKAGE_DIR / "build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-Wall"]


class BuildInfo:
    """What the last build of a library did in this process."""

    def __init__(self):
        self.path: Optional[Path] = None
        self.seconds = 0.0
        self.compiled = False


build_info = {}  # library stem -> BuildInfo


def compiler() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


def build_library(stem: str, sources: Sequence[Path], extra: Sequence[str] = ()) -> Path:
    """Compile ``sources`` into ``BUILD_DIR/lib<stem>-<hash>.so`` (skipped when
    that file exists). Raises RuntimeError without a compiler or on a failed
    build."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    h = hashlib.sha1()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join([*CXX_FLAGS, *extra]).encode())
    out = BUILD_DIR / f"lib{stem}-{h.hexdigest()[:12]}.so"
    info = build_info.setdefault(stem, BuildInfo())
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, sources), *extra]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed ({res.returncode}):\n{res.stderr[-4000:]}")
        os.replace(tmp, out)
        info.compiled = True
    info.path = out
    info.seconds = time.perf_counter() - t0
    return out


def build_native() -> Path:
    return build_library("mammo_native", [NATIVE_DIR / "mammo_native.cpp"])


_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_i32p = ctypes.POINTER(ctypes.c_int32)


def bind_native(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of mammo_native.cpp's functions."""
    lib.normalize_u16_to_u8.argtypes = [_u16p, ctypes.c_int64, ctypes.c_int, _u8p]
    lib.breast_crop_bounds.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _i32p]
    lib.area_resize_u8.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_int,
                                   ctypes.c_int]
    lib.preprocess_mammogram_u16.argtypes = [
        _u16p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _u8p, ctypes.c_int, ctypes.c_int, _i32p,
    ]
    lib.clahe_u8.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_float, _u8p]
    lib.png_unfilter.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p]
    lib.png_unfilter.restype = ctypes.c_int
    return lib


_lib: Optional[ctypes.CDLL] = None
_failed = False


def load_native() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None without a compiler or
    when the build fails."""
    global _lib, _failed
    if _lib is None and not _failed:
        try:
            _lib = bind_native(ctypes.CDLL(str(build_native())))
        except (RuntimeError, OSError):
            _failed = True
    return _lib


def native_available() -> bool:
    return load_native() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _checked(arr: np.ndarray, dtype, ndim: int = 2):
    """The library and a C-contiguous copy of ``arr``, after checking what the
    C functions assume of their pointers."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("the native preprocessing library is unavailable (no g++?)")
    if arr.dtype != dtype or arr.ndim != ndim:
        raise ValueError(f"expected a {ndim}-D {np.dtype(dtype).name} array, got "
                         f"{arr.ndim}-D {arr.dtype}")
    return lib, np.ascontiguousarray(arr)


# ------------------------------------------------------------------ native


def normalize_native(raw_u16: np.ndarray, invert: bool = False) -> np.ndarray:
    lib, raw_u16 = _checked(raw_u16, np.uint16, raw_u16.ndim)
    out = np.empty(raw_u16.shape, np.uint8)
    lib.normalize_u16_to_u8(_ptr(raw_u16, ctypes.c_uint16), raw_u16.size, int(invert),
                            _ptr(out, ctypes.c_uint8))
    return out


def breast_crop_bounds_native(img: np.ndarray, threshold: int = 40) -> Tuple[int, int, int, int]:
    lib, img = _checked(img, np.uint8)
    out = np.zeros(4, np.int32)
    lib.breast_crop_bounds(_ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1],
                           threshold, _ptr(out, ctypes.c_int32))
    return tuple(int(v) for v in out)


def area_resize_native(img: np.ndarray, out_size: Tuple[int, int]) -> np.ndarray:
    lib, img = _checked(img, np.uint8)
    dh, dw = out_size
    out = np.zeros((dh, dw), np.uint8)
    lib.area_resize_u8(_ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1],
                       _ptr(out, ctypes.c_uint8), dh, dw)
    return out


def preprocess_mammogram_native(
    raw_u16: np.ndarray, out_size: Tuple[int, int], invert: bool = False,
    crop_threshold: int = 40,
) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """Fused normalize -> breast crop -> area resize; returns (uint8 image, bounds)."""
    lib, raw_u16 = _checked(raw_u16, np.uint16)
    dh, dw = out_size
    out = np.zeros((dh, dw), np.uint8)
    bounds = np.zeros(4, np.int32)
    lib.preprocess_mammogram_u16(
        _ptr(raw_u16, ctypes.c_uint16), raw_u16.shape[0], raw_u16.shape[1],
        int(invert), crop_threshold, _ptr(out, ctypes.c_uint8), dh, dw,
        _ptr(bounds, ctypes.c_int32),
    )
    return out, tuple(int(v) for v in bounds)


def clahe_native(img: np.ndarray, tiles: Tuple[int, int] = (8, 8),
                 clip_limit: float = 2.0) -> np.ndarray:
    """Contrast-limited adaptive histogram equalization (cv2's CLAHE within +-1
    grey level)."""
    lib, img = _checked(img, np.uint8)
    out = np.zeros_like(img)
    lib.clahe_u8(_ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1],
                 tiles[0], tiles[1], clip_limit, _ptr(out, ctypes.c_uint8))
    return out


def png_unfilter_native(data: bytes, h: int, stride: int, bpp: int = 1) -> np.ndarray:
    src = np.frombuffer(data, np.uint8)
    lib, src = _checked(src, np.uint8, 1)
    if src.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {src.size} bytes, expected {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    bad = lib.png_unfilter(_ptr(src, ctypes.c_uint8), h, stride, bpp, _ptr(out, ctypes.c_uint8))
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type {src[(bad - 1) * (stride + 1)]}, "
                         f"not 0-4")
    return out


# ------------------------------------------------------------------ plain versions

_F = np.float32


def normalize_u16_to_u8_plain(raw_u16: np.ndarray, invert: bool = False) -> np.ndarray:
    """``normalize_u16_to_u8``: v = (x - lo) / (hi - lo) in float32, 1 - v when
    inverting, then uint8(v * 255 + 0.5)."""
    raw = np.asarray(raw_u16)
    if raw.size == 0:
        return np.zeros(raw.shape, np.uint8)
    lo, hi = int(raw.min()), int(raw.max())
    denom = _F(1.0) / _F(hi - lo) if hi > lo else _F(0.0)
    v = (raw.astype(np.int32) - lo).astype(_F) * denom
    if invert:
        v = _F(1.0) - v
    return (v * _F(255.0) + _F(0.5)).astype(np.uint8)


def _area_taps(s: int, d: int) -> Tuple[np.ndarray, np.ndarray]:
    """Source index and float32 weight of each tap of each output position, as
    ``area_resize_u8`` computes them: (taps, d) each; unused taps weigh 0."""
    scale = _F(s) / _F(d)
    x = np.arange(d)
    a = x.astype(_F) * scale
    b = (x + 1).astype(_F) * scale
    ia = a.astype(np.int64)
    ib = np.minimum((b - _F(1e-6)).astype(np.int64), s - 1)
    n = max(int((ib - ia).max()) + 1, 1)
    idx = ia[None, :] + np.arange(n)[:, None]
    used = idx <= ib[None, :]
    idx = np.minimum(idx, np.maximum(ib, 0)[None, :])
    lo = np.maximum(a[None, :], idx.astype(_F))
    hi = np.minimum(b[None, :], (idx + 1).astype(_F))
    return idx, np.where(used, hi - lo, _F(0.0)).astype(_F)


def area_resize_plain(img: np.ndarray, out_size: Tuple[int, int]) -> np.ndarray:
    """``area_resize_u8`` in numpy: the same taps, weights and float32
    summation order (horizontal pass, then vertical)."""
    src = np.asarray(img, np.uint8).astype(_F)
    sh, sw = src.shape
    dh, dw = out_size
    idx, wgt = _area_taps(sw, dw)
    acc = np.zeros((sh, dw), _F)
    wsum = np.zeros(dw, _F)
    for k in range(idx.shape[0]):
        acc = acc + wgt[k][None, :] * src[:, idx[k]]
        wsum = wsum + wgt[k]
    tmp = acc / wsum[None, :]
    idx, wgt = _area_taps(sh, dh)
    acc = np.zeros((dh, dw), _F)
    wsum = np.zeros(dh, _F)
    for k in range(idx.shape[0]):
        acc = acc + wgt[k][:, None] * tmp[idx[k], :]
        wsum = wsum + wgt[k]
    q = np.minimum(np.maximum(acc / wsum[:, None], _F(0.0)), _F(255.0))
    return (q + _F(0.5)).astype(np.uint8)


def preprocess_mammogram_plain(
    raw_u16: np.ndarray, out_size: Tuple[int, int], invert: bool = False,
    crop_threshold: int = 40,
) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """``preprocess_mammogram_u16`` in numpy."""
    norm = normalize_u16_to_u8_plain(raw_u16, invert)
    bounds = breast_roi_bounds(norm, crop_threshold)
    y0, y1, x0, x1 = bounds
    return area_resize_plain(norm[y0:y1, x0:x1], out_size), tuple(int(v) for v in bounds)


def clahe_plain(img: np.ndarray, tiles: Tuple[int, int] = (8, 8),
                clip_limit: float = 2.0) -> np.ndarray:
    """``clahe_u8`` in numpy: per-tile clipped histograms, CDF LUTs, and the
    bilinear blend of the four surrounding tiles' LUTs, in float32."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape
    ty_n, tx_n = max(1, tiles[0]), max(1, tiles[1])
    th, tw = -(-h // ty_n), -(-w // tx_n)
    luts = np.zeros((ty_n, tx_n, 256), _F)
    for ty in range(ty_n):
        for tx in range(tx_n):
            y0, x0 = ty * th, tx * tw
            y1, x1 = min(y0 + th, h), min(x0 + tw, w)
            area = (y1 - y0) * (x1 - x0)
            hist = np.bincount(img[y0:y1, x0:x1].ravel(), minlength=256).astype(np.int64)
            clip = max(1, int(_F(_F(clip_limit) * _F(area)) / _F(256.0)))
            excess = int(np.maximum(hist - clip, 0).sum())
            hist = np.minimum(hist, clip)
            hist += excess // 256 + (np.arange(256) < excess % 256)
            luts[ty, tx] = (_F(255.0) / _F(area)) * np.cumsum(hist).astype(_F)

    def blend(n, t, tiles_n):
        f = (np.arange(n).astype(_F) - _F(t / 2.0) + _F(0.5)) / _F(t)
        t0 = np.floor(f).astype(np.int64)
        wt = f - t0.astype(_F)
        t1 = np.clip(t0 + 1, 0, tiles_n - 1)
        return np.clip(t0, 0, tiles_n - 1), t1, wt

    ty0, ty1, wy = blend(h, th, ty_n)
    tx0, tx1, wx = blend(w, tw, tx_n)
    wx, wy = wx[None, :], wy[:, None]
    v00 = luts[ty0[:, None], tx0[None, :], img]
    v01 = luts[ty0[:, None], tx1[None, :], img]
    v10 = luts[ty1[:, None], tx0[None, :], img]
    v11 = luts[ty1[:, None], tx1[None, :], img]
    top = v00 * (_F(1.0) - wx) + v01 * wx
    bot = v10 * (_F(1.0) - wx) + v11 * wx
    out = top * (_F(1.0) - wy) + bot * wy
    return (np.minimum(np.maximum(out, _F(0.0)), _F(255.0)) + _F(0.5)).astype(np.uint8)


def png_unfilter_plain(data: bytes, h: int, stride: int, bpp: int = 1) -> np.ndarray:
    """``png_unfilter`` in numpy: None, Sub and Up vectorised per row, Average
    and Paeth one byte at a time."""
    src = np.frombuffer(data, np.uint8)
    if src.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {src.size} bytes, expected {h * (stride + 1)}")
    src = src.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, row = int(src[y, 0]), src[y, 1:]
        if kind == 0:
            cur = row.copy()
        elif kind == 1:
            cur = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = row + prev
        elif kind in (3, 4):
            cur = np.zeros(stride, np.uint8)
            r, up = row.tolist(), prev.tolist()
            vals: List[int] = [0] * stride
            for i in range(stride):
                a = vals[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                vals[i] = (r[i] + pred) & 0xFF
            cur[:] = vals
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}, not 0-4")
        out[y] = cur
        prev = cur
    return out


# ------------------------------------------------------------------ dispatch


def area_resize(img: np.ndarray, out_size: Tuple[int, int]) -> np.ndarray:
    """The native area resize, else its plain version."""
    if native_available():
        return area_resize_native(img, out_size)
    return area_resize_plain(img, out_size)


def png_unfilter(data: bytes, h: int, stride: int, bpp: int = 1) -> np.ndarray:
    """The native PNG row unfilter, else its plain version."""
    if native_available():
        return png_unfilter_native(data, h, stride, bpp)
    return png_unfilter_plain(data, h, stride, bpp)
