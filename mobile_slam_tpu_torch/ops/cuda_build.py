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
``sass_loop_loads`` counts each kernel's global loads inside its loops in
the built machine code (cuobjdump), which shows whether the compiler kept
a loop's loads or moved them out.
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


def _find_tool(tool: str = "nvcc") -> str:
    """A CUDA toolkit program: under CUDA_HOME / CUDA_PATH, on PATH, or under
    /usr/local/cuda."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", tool)):
            return os.path.join(root, "bin", tool)
    found = shutil.which(tool)
    if found:
        return found
    default = f"/usr/local/cuda/bin/{tool}"
    if os.path.exists(default):
        return default
    raise RuntimeError(f"{tool} not found: set CUDA_HOME or put {tool} on PATH")


def _kernel_name(mangled: str) -> str:
    """``_Z15lk_probe_kernelILi3EEv...`` -> ``lk_probe_kernel<3>``: the name
    and its integer template arguments."""
    m = re.match(r"_Z(\d+)(\w+)", mangled)
    n, rest = int(m.group(1)), m.group(2)
    args = re.match(r"I((?:Li\d+E)+)E", rest[n:])
    targs = "<" + ", ".join(re.findall(r"Li(\d+)E", args.group(1))) + ">" if args else ""
    return rest[:n] + targs


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
        cmd = [_find_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
    name (with its integer template arguments), registers, static shared
    memory and spills."""
    log = library_path(name).with_suffix(".log").read_text()
    lines = []
    for m in re.finditer(r"Compiling entry function '(_Z\w+)'.*?\n.*?\n\s*(\d+) bytes stack"
                         r" frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n.*?Used "
                         r"(\d+) registers(?:.*?(\d+) bytes smem)?", log):
        mangled, _, st, ld, regs, smem = m.groups()
        lines.append(f"{_kernel_name(mangled)}: {regs} registers, "
                     f"{smem or 0} B static shared memory, spills {st} B stored / {ld} B loaded")
    return lines


def count_loop_loads(sass: str) -> dict[str, tuple[int, int]]:
    """Per kernel of cuobjdump's ``-sass`` listing: (global loads inside a
    loop, global loads in all). A loop is the code from a branch's target
    up to the branch, where the target lies before it; the target is a
    label (``BRA `(.L_x_3)``) or an address (``BRA 0x350``)."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = _kernel_name(part.split(None, 1)[0])
        labels, code = {}, []     # label / address -> index into code
        for line in part.splitlines()[1:]:
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                labels[lab.group(1)] = len(code)
                continue
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if ins:
                labels[int(ins.group(1), 16)] = len(code)
                code.append(ins.group(2))
        in_loop = [False] * len(code)
        for i, ins in enumerate(code):
            br = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))", ins)
            if br:
                start = labels.get(br.group(1) or int(br.group(2), 16))
                if start is not None and start <= i:
                    in_loop[start:i + 1] = [True] * (i + 1 - start)
        loads = [bool(re.search(r"\bLDG\b", ins)) for ins in code]
        out[name] = (sum(l and b for l, b in zip(loads, in_loop)), sum(loads))
    return out


def sass_loop_loads(name: str) -> dict[str, tuple[int, int]]:
    """``count_loop_loads`` of the built library ``name``."""
    proc = subprocess.run([_find_tool("cuobjdump"), "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True)
    return count_loop_loads(proc.stdout)


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
