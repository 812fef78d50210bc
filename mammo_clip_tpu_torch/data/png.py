"""PNG reader and writer for 8-bit greyscale images, with the standard
library's ``zlib`` and ``struct`` and numpy (no OpenCV or PIL).

These are the PNGs of the reference's image trees and of the DICOM tool's
``--png`` output: colour type 0, bit depth 8, not interlaced. Any other
colour type, bit depth or Adam7 interlacing raises a ``ValueError`` that names
it. Decoding undoes all five row filters (None, Sub, Up, Average, Paeth) with
``preprocess/native_bindings.png_unfilter`` (the native library, else its
plain version). The writer filters every row with None, or cycles through the
filter types it is given (forward filtering vectorises; only its inverse is
sequential).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
COLOUR_TYPES = {0: "greyscale", 2: "truecolour", 3: "indexed-colour",
                4: "greyscale with alpha", 6: "truecolour with alpha"}


def _chunks(data: bytes, name: str):
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{name}: bad CRC in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: no IEND chunk")


def decode_png(data: bytes, name: str = "PNG") -> np.ndarray:
    """PNG bytes -> (H, W) uint8."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if colour != 0:
        raise ValueError(f"{name}: colour type {colour} "
                         f"({COLOUR_TYPES.get(colour, 'invalid')}) is not supported: only "
                         f"8-bit greyscale (colour type 0)")
    if depth != 8:
        raise ValueError(f"{name}: bit depth {depth} is not supported: only 8-bit greyscale")
    if interlace != 0:
        raise ValueError(f"{name}: Adam7 interlacing is not supported")
    from ..preprocess.native_bindings import png_unfilter

    return png_unfilter(zlib.decompress(b"".join(idat)), h, w, 1)


def read_png(path) -> np.ndarray:
    """An 8-bit greyscale PNG file -> (H, W) uint8."""
    return decode_png(Path(path).read_bytes(), str(path))


def _filter_rows(img: np.ndarray, filters) -> np.ndarray:
    """(H, W) uint8 -> (H, 1 + W) filtered scanlines, row y with filter type
    ``filters[y % len(filters)]`` (PNG spec §9, one byte per pixel)."""
    x = img.astype(np.int16)
    a = np.pad(x, ((0, 0), (1, 0)))[:, :-1]  # left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]  # up
    c = np.pad(x, ((1, 0), (1, 0)))[:-1, :-1]  # up-left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    predictors = [0, a, b, (a + b) >> 1, paeth]
    kinds = np.asarray([filters[y % len(filters)] for y in range(img.shape[0])], np.uint8)
    out = np.empty((img.shape[0], img.shape[1] + 1), np.uint8)
    out[:, 0] = kinds
    for k in set(kinds.tolist()):
        rows = kinds == k
        pred = predictors[k] if k == 0 else predictors[k][rows]
        out[rows, 1:] = ((x[rows] - pred) % 256).astype(np.uint8)
    return out


def encode_png(img: np.ndarray, level: int = 6, filters=(0,)) -> bytes:
    """(H, W) uint8 -> 8-bit greyscale PNG bytes (zlib ``level``; row y
    filtered with type ``filters[y % len(filters)]``, each in 0-4)."""
    img = np.ascontiguousarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"write_png takes an (H, W) uint8 array, got {img.dtype} {img.shape}")
    if not filters or any(k not in range(5) for k in filters):
        raise ValueError(f"PNG filter types are 0-4, got {filters}")
    h, w = img.shape

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    raw = _filter_rows(img, tuple(filters)).tobytes()
    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))


def write_png(path, img: np.ndarray, level: int = 6, filters=(0,)) -> None:
    Path(path).write_bytes(encode_png(img, level, filters))
