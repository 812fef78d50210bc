"""ctypes bindings for the native DICOM codec and pool (port of
``mammo_clip_tpu/preprocess/dicom_native.py``).

First-party pixel decode for the offline conversion tool: JPEG-2000 lossless (the
RSNA mammography transfer syntax — reference decoded it with NVIDIA DALI,
preprocess_image_to_png_kaggle.py:95-100), JPEG Lossless process 14 SV1 (VinDr —
reference used dicomsdl, preprocess_image_to_png_vindr.py:80-88), JPEG-LS, and
uncompressed syntaxes. ``write_dicom_u16`` is the test-fixture encoder.

``native/mammo_dicom.cpp`` (the GDCM-backed codec), ``native/mammo_pool.cpp``
(the threaded pool) and ``native/mammo_native.cpp`` (the fused pipeline the pool
calls) are built at first use into one library under
``mammo_clip_tpu_torch/build/`` (``native_bindings.build_library``), against the
GDCM headers in ``$GDCM_INC`` (default ``/usr/include/gdcm-3.0``).
``dicom_available()`` / ``pool_available()`` gate callers: without the headers,
a compiler or a link, they are False (pydicom remains a fallback in
dicom_tool.read_dicom_pixels).
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .native_bindings import NATIVE_DIR, bind_native, build_library

GDCM_LIBS = ["-lgdcmMSFF", "-lgdcmDSED", "-lgdcmDICT", "-lgdcmIOD", "-lgdcmCommon"]

_STATUS = {0: "ok", 1: "read failed", 2: "unsupported format", 3: "buffer mismatch",
           4: "write failed"}
_lib: Optional[ctypes.CDLL] = None
_failed = False


def gdcm_include() -> Path:
    return Path(os.environ.get("GDCM_INC", "/usr/include/gdcm-3.0"))


def gdcm_found() -> bool:
    return (gdcm_include() / "gdcmImageReader.h").exists()


def build_dicom() -> Path:
    """Build the codec, the pool and the fused pipeline into one library.
    Raises RuntimeError without the GDCM headers, a compiler or a link."""
    if not gdcm_found():
        raise RuntimeError(f"GDCM headers not found in {gdcm_include()} (set GDCM_INC)")
    sources = [NATIVE_DIR / n for n in ("mammo_dicom.cpp", "mammo_pool.cpp", "mammo_native.cpp")]
    return build_library("mammo_dicom", sources,
                         [f"-I{gdcm_include()}", *GDCM_LIBS, "-lpthread"])


def load_dicom_native() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        lib = bind_native(ctypes.CDLL(str(build_dicom())))
    except (RuntimeError, OSError):
        _failed = True
        return None
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.dicom_image_info.argtypes = [ctypes.c_char_p, i64p, i64p, i32p, i32p, i32p]
    lib.dicom_read_u16.argtypes = [ctypes.c_char_p, u16p, ctypes.c_int64]
    lib.dicom_write_u16.argtypes = [ctypes.c_char_p, u16p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
    lib.dicom_batch_preprocess.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.dicom_batch_preprocess.restype = ctypes.c_int
    _lib = lib
    return lib


def dicom_available() -> bool:
    return load_dicom_native() is not None


def _require() -> ctypes.CDLL:
    lib = load_dicom_native()
    if lib is None:
        raise RuntimeError("native DICOM codec unavailable (GDCM headers not found in "
                           f"{gdcm_include()}, or no g++)")
    return lib


def load_pool() -> Optional[ctypes.CDLL]:
    """The parallel decode+preprocess pool (native/mammo_pool.cpp), in the
    codec's library: one call converts a batch of DICOMs on every host core
    with zero Python in the loop."""
    return load_dicom_native()


def pool_available() -> bool:
    return load_pool() is not None


def read_dicom_u16(path: str) -> Tuple[np.ndarray, bool]:
    """Decode a DICOM file -> (uint16 pixel array (H, W), monochrome1 flag).

    8-bit pixels are widened; signed 16-bit is shifted +32768 (order-preserving,
    harmless under the per-image min-max normalization that follows)."""
    lib = _require()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    bits, sgn, mono1 = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.dicom_image_info(str(path).encode(), ctypes.byref(rows), ctypes.byref(cols),
                              ctypes.byref(bits), ctypes.byref(sgn), ctypes.byref(mono1))
    if rc != 0:
        raise ValueError(f"DICOM info failed for {path}: {_STATUS.get(rc, rc)}")
    out = np.empty((rows.value, cols.value), np.uint16)
    rc = lib.dicom_read_u16(str(path).encode(),
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), out.size)
    if rc != 0:
        raise ValueError(f"DICOM decode failed for {path}: {_STATUS.get(rc, rc)}")
    return out, bool(mono1.value)


def batch_preprocess(
    paths, out_size: Tuple[int, int], n_threads: int = 0,
    crop_threshold: int = 40, trim: int = 5,
):
    """Decode + normalize + breast-crop + resize a batch of DICOMs in parallel.

    Returns (images (N, H, W) uint8, bounds (N, 4) int32 crop rects in the
    trimmed frame, status (N,) int32 — 0 = ok, see _STATUS). Matches
    dicom_tool.convert_one's native path per file (including the 5-pixel edge
    trim, which the pool applies only when rows and cols exceed 2 * trim);
    n_threads <= 0 uses every host core."""
    lib = _require()
    n = len(paths)
    h, w = out_size
    images = np.zeros((n, h, w), np.uint8)
    bounds = np.zeros((n, 4), np.int32)
    status = np.zeros(n, np.int32)
    if n == 0:
        return images, bounds, status
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.dicom_batch_preprocess(
        c_paths, n, h, w, crop_threshold, trim, n_threads,
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return images, bounds, status


# transfer-syntax codes understood by dicom_write_u16 (test-fixture encoder)
TS_RAW = 0  # explicit-VR little-endian
TS_J2K = 1  # JPEG-2000 lossless (RSNA)
TS_JLS = 2  # JPEG-LS lossless
TS_JPEG_LOSSLESS = 3  # JPEG lossless process 14 SV1 (VinDr)


def write_dicom_u16(path: str, pixels: np.ndarray, ts: int = TS_RAW,
                    monochrome1: bool = False) -> None:
    """Encode a uint16 image as a DICOM file (fixture generator for tests)."""
    lib = _require()
    pixels = np.ascontiguousarray(pixels, np.uint16)
    if pixels.ndim != 2:
        raise ValueError(f"expected a 2-D image, got shape {pixels.shape}")
    rc = lib.dicom_write_u16(str(path).encode(),
                             pixels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                             pixels.shape[0], pixels.shape[1], int(ts), int(monochrome1))
    if rc != 0:
        raise ValueError(f"DICOM encode failed for {path}: {_STATUS.get(rc, rc)}")
