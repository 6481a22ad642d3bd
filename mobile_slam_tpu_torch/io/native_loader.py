"""ctypes bindings for the native data-loading runtime (native/loader.cpp),
the torch port's copy of mobile_slam_tpu.io.native_loader.

Provides fast CSV parsing, 8-bit PNG/PGM grayscale decoding and a
background prefetching image stream (``PrefetchingImageStream``).
``ensure_built()`` compiles the repo's ``native/loader.cpp`` with g++ (and
zlib) on first use into the git-ignored ``mobile_slam_tpu_torch/_build/``
(``build_library``, which io/png.py uses too); when that fails, callers use
the pure-Python readers (io/dataset.py, io/png.py). Host I/O only.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "loader.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libmslam_loader.so")
_lib = None


def build_library(source: str, lib_path: str, libs=(), force: bool = False) -> bool:
    """Compile ``source`` with g++ into the shared library ``lib_path``
    unless it exists (``force``: in any case). Returns whether it does."""
    if os.path.exists(lib_path) and not force:
        return True
    if not os.path.exists(source):
        return False
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    # Build beside the target and rename: concurrent builds (test workers)
    # never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib_path))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                        source, *libs, "-o", tmp],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib_path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def ensure_built(force: bool = False) -> bool:
    """Build the shared library if needed (``force``: rebuild it and load
    it again). Returns availability."""
    global _lib
    if _lib is not None and not force:
        return True
    if not build_library(_SOURCE, _LIB_PATH, ["-lz"], force=force):
        return False
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return False

    lib.msp_parse_csv.restype = ctypes.c_long
    lib.msp_parse_csv.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_void_p)]
    lib.msp_parse_image_csv.restype = ctypes.c_long
    lib.msp_parse_image_csv.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p)]
    lib.msp_decode_image.restype = ctypes.c_int
    lib.msp_decode_image.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int]
    lib.msp_open.restype = ctypes.c_void_p
    lib.msp_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int]
    lib.msp_next.restype = ctypes.c_long
    lib.msp_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.msp_close.argtypes = [ctypes.c_void_p]
    lib.msp_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return True


def available() -> bool:
    return ensure_built()


def parse_csv(path: str, cols: int) -> np.ndarray:
    """Native CSV parse -> (N, cols) float64; malformed lines skipped."""
    assert ensure_built()
    out = ctypes.c_void_p()
    n = _lib.msp_parse_csv(path.encode(), cols, ctypes.byref(out))
    if n < 0:
        raise IOError(f"cannot parse {path}")
    buf = np.ctypeslib.as_array(
        ctypes.cast(out, ctypes.POINTER(ctypes.c_double)), (n * cols,)
    ).copy().reshape(n, cols)
    _lib.msp_free(out)
    return buf


def parse_image_csv(path: str):
    """Native image-index parse -> (ts seconds (N,), filenames list)."""
    assert ensure_built()
    ts_p = ctypes.c_void_p()
    names_p = ctypes.c_void_p()
    n = _lib.msp_parse_image_csv(path.encode(), ctypes.byref(ts_p),
                                 ctypes.byref(names_p))
    if n < 0:
        raise IOError(f"cannot parse {path}")
    ts = np.ctypeslib.as_array(
        ctypes.cast(ts_p, ctypes.POINTER(ctypes.c_double)), (n,)
    ).copy()
    names = ctypes.cast(names_p, ctypes.c_char_p).value.decode()
    _lib.msp_free(ts_p)
    _lib.msp_free(names_p)
    return ts, [s for s in names.split("\n") if s]


def decode_image(path: str, width: int, height: int) -> np.ndarray:
    """Native PNG/PGM grayscale decode -> (H, W) uint8."""
    assert ensure_built()
    out = np.empty((height, width), np.uint8)
    rc = _lib.msp_decode_image(path.encode(),
                               out.ctypes.data_as(ctypes.c_void_p),
                               width, height)
    if rc != 0:
        raise IOError(f"decode failed ({rc}) for {path}")
    return out


class PrefetchingImageStream:
    """Sequential 8-bit image stream decoded ``prefetch`` frames ahead by a
    worker thread of the native loader (the reference's worker ring buffer,
    web/js/vio-worker.js:72-165). Iterates (index, (H, W) uint8); a frame
    that fails to decode is skipped."""

    def __init__(self, image_dir: str, filenames: list[str], width: int,
                 height: int, prefetch: int = 4):
        assert ensure_built()
        self.width = width
        self.height = height
        joined = "\n".join(filenames).encode()
        self._h = _lib.msp_open(image_dir.encode(), joined, width, height,
                                prefetch)
        if not self._h:
            raise IOError("msp_open failed")

    def __iter__(self):
        return self

    def __next__(self):
        out = np.empty((self.height, self.width), np.uint8)
        while True:
            idx = _lib.msp_next(self._h, out.ctypes.data_as(ctypes.c_void_p))
            if idx == -1:
                raise StopIteration
            if idx != -2:       # -2: decode error, the frame is skipped
                return int(idx), out

    def close(self):
        if self._h:
            _lib.msp_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
