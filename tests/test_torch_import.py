"""The port imports without JAX, Triton or anything of the JAX package, its
entry points default to the card, and its CUDA kernels fail loudly (never
fall back) where no GPU is present."""

import inspect
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib
import pkgutil
import sys
import mobile_slam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mobile_slam_tpu_torch.__path__,
                                                "mobile_slam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m in ("jax", "jaxlib", "triton")
       or m == "mobile_slam_tpu" or m.startswith("mobile_slam_tpu.")]
print("IMPORTED", len(names), "LOADED", bad)
sys.exit(1 if bad or len(names) < 40 else 0)
"""


def test_port_imports_without_jax_or_triton():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("entry", ["VIOEngine", "ChunkedImageServer", "call_overhead.run",
                                   "lk_pack_probe.run", "gateway.serve",
                                   "gateway.ClientSession", "logging.device_trace",
                                   "launch.run_ranks", "dryrun.dryrun_multichip",
                                   "entry.entry"])
def test_entry_points_default_to_the_card(entry):
    from mobile_slam_tpu_torch import entry as unit
    from mobile_slam_tpu_torch.engine.serving import ChunkedImageServer
    from mobile_slam_tpu_torch.engine.vio_engine import VIOEngine
    from mobile_slam_tpu_torch.parallel import dryrun, launch
    from mobile_slam_tpu_torch.probes import call_overhead, lk_pack_probe
    from mobile_slam_tpu_torch.utils import logging
    from mobile_slam_tpu_torch.web import gateway

    fn = {"VIOEngine": VIOEngine, "ChunkedImageServer": ChunkedImageServer,
          "call_overhead.run": call_overhead.run, "lk_pack_probe.run": lk_pack_probe.run,
          "gateway.serve": gateway.serve, "gateway.ClientSession": gateway.ClientSession,
          "logging.device_trace": logging.device_trace.__wrapped__,
          "launch.run_ranks": launch.run_ranks, "dryrun.dryrun_multichip": dryrun.dryrun_multichip,
          "entry.entry": unit.entry}[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_engine_on_the_card_raises_without_one():
    from mobile_slam_tpu.engine.example import tiny_config
    from mobile_slam_tpu_torch.engine.vio_engine import VIOEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="cuda"):
        VIOEngine(tiny_config())


def test_ranks_on_the_card_raise_without_one():
    from mobile_slam_tpu_torch.parallel import batch, launch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run_ranks(print, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.make_mesh()


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
