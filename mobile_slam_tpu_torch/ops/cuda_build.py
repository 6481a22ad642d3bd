"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` is compiled by nvcc for ``sm_90a`` into a shared
library with a plain C interface (route (b): no PyTorch headers, seconds
per file) under the git-ignored ``_build/<hash>/`` directory, keyed by the
source, the shared headers and the flags, and loaded with ctypes. ``build``
starts one nvcc per missing library, all at once, and waits for all of
them; ``load`` builds one library on first use. Both raise with nvcc's
output when a build fails, and ``load`` raises when no CUDA device is
present: nothing falls back to a plain version. nvcc runs with
``-Xptxas -v``; its output is kept beside the library and ``ptxas_report``
reads each kernel's registers, shared memory and spills from it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("lk_kernels", "probe_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _find_nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: keyed by a hash of the source, every
    shared header and the flags."""
    if name not in SOURCES:
        raise ValueError(f"unknown CUDA source {name!r}; known: {SOURCES}")
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / h.hexdigest()[:16] / f"lib{name}.so"


def build(*names: str) -> None:
    """Compile every named library that is not built yet, one nvcc each,
    all started together."""
    jobs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((cmd, proc, tmp, so))
    failures = []
    for cmd, proc, tmp, so in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        else:
            so.with_suffix(".log").write_text(out)    # ptxas -v: see ptxas_report
            os.replace(tmp, so)
    if failures:
        raise RuntimeError("\n".join(failures))


def ptxas_report(name: str) -> list[str]:
    """What ptxas said of each kernel of a built library, one line each:
    name (with its integer template argument), registers, static shared
    memory and spills."""
    log = library_path(name).with_suffix(".log").read_text()
    lines = []
    for m in re.finditer(r"Compiling entry function '_Z(\d+)(\w+)'.*?\n.*?\n\s*(\d+) bytes stack"
                         r" frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n.*?Used "
                         r"(\d+) registers(?:.*?(\d+) bytes smem)?", log):
        n, rest, _, st, ld, regs, smem = m.groups()
        arg = re.match(r"ILi(\d+)E", rest[int(n):])
        lines.append(f"{rest[:int(n)]}{f'<{arg.group(1)}>' if arg else ''}: {regs} registers, "
                     f"{smem or 0} B static shared memory, spills {st} B stored / {ld} B loaded")
    return lines


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, compiled first if needed. Raises when no
    CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"the {name} CUDA kernels need a CUDA device; "
                           "torch.cuda.is_available() is False")
    build(name)
    return ctypes.CDLL(str(library_path(name)))


def check(rc: int, name: str) -> None:
    """Raise for a non-zero cudaError_t returned by a launch entry point."""
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the int ctypes passes."""
    return torch.cuda.current_stream(t.device).cuda_stream
