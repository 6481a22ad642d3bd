"""Image files read as grayscale without OpenCV: a PNG decoder and encoder
on stdlib ``zlib`` and numpy, and a binary PGM reader.

``imread_gray`` returns what ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``
returns for the files a camera sequence holds: PNG of colour type 0 (gray),
2 (RGB), 4 (gray + alpha) or 6 (RGBA) at 8 or 16 bits, any of the five row
filters, not interlaced; and binary (P5) PGM with a maxval of 255. 16-bit
samples keep their high byte, as OpenCV keeps it for gray. Colour becomes
gray by native/loader.cpp's own integer luma, ``(299 R + 587 G + 114 B) //
1000``, with alpha dropped; libpng, under OpenCV, rounds its fixed-point
luma instead, so a colour pixel may read one grey level apart from
OpenCV's. Palette PNG, interlaced PNG, JPEG and 16-bit PGM raise
``ValueError``. ``write_png`` writes an 8-bit grayscale PNG (every row
filtered with Up).

Rows are unfiltered by ``csrc/png_unfilter.cpp``, built with g++ on first
use into the git-ignored ``_build/``; where it does not build, by numpy
(None, Sub, Up) and Python loops (Average, Paeth; many times slower,
``python -m mobile_slam_tpu_torch.probes.png_decode`` times both).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import zlib
from typing import NamedTuple

import numpy as np

from mobile_slam_tpu_torch.io import native_loader

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_UNFILTER_SOURCE = os.path.join(_PKG_DIR, "csrc", "png_unfilter.cpp")
_unfilter_fn = None     # the C function once loaded; False where it does not build

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


# Samples per pixel of the PNG colour types read (3, palette, is not).
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class ImageHeader(NamedTuple):
    """Width, height, sample depth and PNG colour type (0 for PGM) of an
    image file."""

    width: int
    height: int
    bit_depth: int
    color_type: int = 0


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length


def _ihdr(body: bytes):
    if len(body) != 13:
        raise ValueError("bad IHDR chunk")
    w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
    if color not in CHANNELS:
        raise ValueError(f"PNG color type {color}"
                         f"{' (palette)' if color == 3 else ''}: only 0, 2, 4 and 6 are read")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth}: only 8 and 16 are read")
    if comp != 0 or filt != 0:
        raise ValueError("unknown PNG compression or filter method")
    if interlace != 0:
        raise ValueError("interlaced PNG is not read")
    if w == 0 or h == 0:
        raise ValueError("empty PNG")
    return w, h, depth, color


def _pgm_header(data: bytes):
    """(width, height, maxval, offset of the pixels) of a P5 file."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and (data[pos:pos + 1].isspace() or data[pos:pos + 1] == b"#"):
            if data[pos:pos + 1] == b"#":
                while pos < len(data) and data[pos:pos + 1] != b"\n":
                    pos += 1
            else:
                pos += 1
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise ValueError("bad PGM header")
        fields.append(int(data[start:pos]))
    return fields[0], fields[1], fields[2], pos + 1   # one whitespace byte


def read_header(path: str) -> ImageHeader:
    """The header of a PNG or PGM file, without decoding its pixels."""
    with open(path, "rb") as f:
        head = f.read(64)
    if head.startswith(PNG_SIGNATURE):
        if head[12:16] != b"IHDR":
            raise ValueError(f"{path}: PNG without a leading IHDR chunk")
        return ImageHeader(*_ihdr(head[16:29]))
    if head.startswith(b"P5"):
        w, h, maxval, _ = _pgm_header(head)
        return ImageHeader(w, h, 8 if maxval < 256 else 16)
    raise ValueError(f"{path}: neither PNG nor binary PGM")


def _paeth_row(cur: np.ndarray, prev: np.ndarray, bpp: int) -> None:
    c_l, p_l = cur.tolist(), prev.tolist()
    for x in range(len(c_l)):
        a = c_l[x - bpp] if x >= bpp else 0
        b = p_l[x]
        c = p_l[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        c_l[x] = (c_l[x] + pred) & 0xFF
    cur[:] = c_l


def _average_row(cur: np.ndarray, prev: np.ndarray, bpp: int) -> None:
    c_l, p_l = cur.tolist(), prev.tolist()
    for x in range(len(c_l)):
        a = c_l[x - bpp] if x >= bpp else 0
        c_l[x] = (c_l[x] + ((a + p_l[x]) >> 1)) & 0xFF
    cur[:] = c_l


def native_unfilter():
    """The C row unfilter, or None where it does not build."""
    global _unfilter_fn
    if _unfilter_fn is None:
        _unfilter_fn = False
        with open(_UNFILTER_SOURCE, "rb") as f:      # keyed by the source
            key = hashlib.sha256(f.read()).hexdigest()[:16]
        lib = os.path.join(_PKG_DIR, "_build", f"libmslam_png_unfilter_{key}.so")
        if native_loader.build_library(_UNFILTER_SOURCE, lib):
            fn = ctypes.CDLL(lib).msp_png_unfilter
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int]
            _unfilter_fn = fn
    return _unfilter_fn or None


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(raw, np.uint8)
    if rows.size < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    rows = rows[:h * (stride + 1)].reshape(h, stride + 1)
    fn = native_unfilter()
    if fn is not None:
        out = np.empty((h, stride), np.uint8)
        bad = fn(rows.ctypes.data, out.ctypes.data, h, stride, bpp)
        if bad:
            raise ValueError(f"PNG row filter {rows[bad - 1, 0]}")
        return out
    return _unfilter_rows(rows, h, stride, bpp)


def _unfilter_rows(rows: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, cur = rows[y, 0], rows[y, 1:].copy()
        if kind == 1:     # Sub: a running sum along each byte lane
            lanes = cur.reshape(-1, bpp).astype(np.int64)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif kind == 2:   # Up
            cur = cur + prev
        elif kind == 3:   # Average
            _average_row(cur, prev, bpp)
        elif kind == 4:   # Paeth
            _paeth_row(cur, prev, bpp)
        elif kind != 0:
            raise ValueError(f"PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out


def _luma(px: np.ndarray) -> np.ndarray:
    """native/loader.cpp's gray of (..., >= 3) uint8 RGB(A) samples."""
    r, g, b = (px[..., i].astype(np.uint32) for i in range(3))
    return ((299 * r + 587 * g + 114 * b) // 1000).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """(H, W) uint8 gray from the bytes of a PNG (module docstring)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG")
    size, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            size = _ihdr(body)
        elif kind == b"IDAT":
            idat.append(body)
    if size is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color = size
    channels = CHANNELS[color]
    bpp = channels * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    px = rows.reshape(h, w, channels, depth // 8)[..., 0]     # 16-bit: the high byte
    if channels >= 3:
        return _luma(px)
    return np.ascontiguousarray(px[..., 0])


def decode_pgm(data: bytes) -> np.ndarray:
    """(H, W) uint8 from the bytes of a binary PGM with maxval 255."""
    if not data.startswith(b"P5"):
        raise ValueError("not a binary PGM")
    w, h, maxval, pos = _pgm_header(data)
    if maxval != 255:
        raise ValueError(f"PGM maxval {maxval}: only 255 is read")
    if len(data) < pos + w * h:
        raise ValueError("truncated PGM")
    return np.frombuffer(data, np.uint8, count=w * h, offset=pos).reshape(h, w).copy()


def imread_gray(path: str) -> np.ndarray:
    """A PNG or PGM file as (H, W) uint8 gray."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    if data.startswith(b"P5"):
        return decode_pgm(data)
    raise ValueError(f"{path}: neither PNG nor binary PGM")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """The bytes of an 8-bit grayscale PNG of ``img`` ((H, W) uint8)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"expected (H, W) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape
    up = img.copy()
    up[1:] -= img[:-1]                  # Up filter, wrapping mod 256
    rows = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
