"""Host time of decoding one camera frame, by image format and decoder.

    python -m mobile_slam_tpu_torch.probes.png_decode [--size 512] [--reps 5]

A textured (size, size) frame is written as a grayscale PNG whose every row
uses one of the five row filters, at 8 and 16 bits, and decoded by
``io/png.py`` with its C row unfilter (``csrc/png_unfilter.cpp``) and with
its Python rows; the 8-bit file with the Up filter (what the port's writer
produces) also by the native loader (``native/loader.cpp``). Prints one JSON
object: median ms per decode for each case.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import tempfile
import time
import zlib

import numpy as np

from mobile_slam_tpu_torch.io import native_loader, png

FILTERS = ("none", "sub", "up", "average", "paeth")


def filtered_png(img: np.ndarray, ftype: int) -> bytes:
    """A grayscale PNG of ``img`` (uint8 or uint16) whose every row uses
    row filter ``ftype``; the predictors come from the known pixels."""
    h, w = img.shape
    bpp = img.itemsize
    raw = np.frombuffer(img.astype(">u2" if bpp == 2 else np.uint8).tobytes(),
                        np.uint8).reshape(h, w * bpp).astype(np.int64)
    a = np.zeros_like(raw)
    a[:, bpp:] = raw[:, :-bpp]
    b = np.zeros_like(raw)
    b[1:] = raw[:-1]
    c = np.zeros_like(raw)
    c[1:, bpp:] = raw[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = [np.zeros_like(raw), a, b, (a + b) // 2, paeth][ftype]
    rows = np.concatenate([np.full((h, 1), ftype), (raw - pred) & 0xFF], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (png.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8 * bpp, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.astype(np.uint8).tobytes(), 6))
            + chunk(b"IEND", b""))


def median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    rs = np.random.RandomState(0)
    coarse = rs.rand(args.size // 8, args.size // 8)
    smooth = np.kron(coarse, np.ones((8, 8)))
    img16 = np.clip(smooth * 60000 + rs.randn(args.size, args.size) * 300,
                    0, 65535).astype(np.uint16)
    img8 = (img16 >> 8).astype(np.uint8)
    native = png.native_unfilter()
    out = {"size": args.size, "native_unfilter": native is not None}
    with tempfile.TemporaryDirectory() as tmp:
        for depth, img in ((8, img8), (16, img16)):
            for ftype, name in enumerate(FILTERS):
                data = filtered_png(img, ftype)
                want = img if depth == 8 else img8
                for route in ("c", "python"):
                    if route == "c" and native is None:
                        continue
                    png._unfilter_fn = native if route == "c" else False
                    if not np.array_equal(png.decode_png(data), want):
                        raise SystemExit(f"{depth}-bit {name} ({route}) decodes wrong")
                    out[f"png{depth}_{name}_{route}_ms"] = median_ms(
                        lambda: png.decode_png(data), args.reps)
                png._unfilter_fn = None
        path = os.path.join(tmp, "up8.png")
        with open(path, "wb") as f:
            f.write(filtered_png(img8, 2))
        if native_loader.available():
            out["native_loader_up8_ms"] = median_ms(
                lambda: native_loader.decode_image(path, args.size, args.size), args.reps)
        out["imread_gray_up8_ms"] = median_ms(lambda: png.imread_gray(path), args.reps)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
