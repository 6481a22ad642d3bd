"""The port imports without JAX or Triton, and its CUDA kernels fail loudly
(never fall back) where no GPU is present."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
import mobile_slam_tpu_torch
import mobile_slam_tpu_torch.engine.vio_engine
import mobile_slam_tpu_torch.ops.lk
import mobile_slam_tpu_torch.convert
import mobile_slam_tpu_torch.eval.simulation
import mobile_slam_tpu_torch.engine.example
bad = [m for m in ("jax", "jaxlib", "triton") if m in sys.modules]
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_without_jax_or_triton():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_module_imports_without_nvcc_and_build_raises_without_gpu():
    from mobile_slam_tpu_torch.ops import lk

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="CUDA"):
        lk.build_kernels()
    # The CUDA entry points raise too (they build first); nothing was counted.
    with pytest.raises(RuntimeError, match="CUDA"):
        lk._extract_patches_cuda(torch.zeros(32, 32), torch.zeros(4, 2), 21)
    assert lk.launch_counts == {"track_pyramidal": 0, "refine_template": 0,
                                "extract_patches": 0}


def test_dispatch_sends_cpu_tensors_to_the_plain_version():
    from mobile_slam_tpu_torch.ops import lk

    before = dict(lk.launch_counts)
    img = torch.rand(40, 40) * 255
    pts = torch.tensor([[20.0, 20.0], [10.5, 12.25]])
    a = lk.extract_patches(img, pts, 21)
    b = lk.extract_patches_ref(img, pts, 21)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert lk.launch_counts == before
