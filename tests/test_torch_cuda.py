"""GPU tier of the PyTorch port: ``pytest -m cuda tests/test_torch_cuda.py``.

Runs chip_smoke.py in a subprocess: it builds the CUDA kernels, holds
each against its plain PyTorch version at main-path shapes and drives the
port's engine and chunked server over the bench sequence. The subprocess
exits with 42 when no CUDA device is present, and the test then skips; the
probe-kernel test decides inside itself and skips without a card too.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
def test_chip_smoke_on_gpu():
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=1200, cwd=REPO)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    if proc.returncode == 42:
        pytest.skip("no CUDA device")
    assert proc.returncode == 0, "chip_smoke.py failed (see output above)"
    assert proc.stdout.strip().splitlines()[-1].startswith('{"ok": true')


@pytest.mark.cuda
def test_probe_kernels_match_plain_versions():
    """P1 and P2 build, launch and agree with their plain versions on the
    card: P1 exact on inputs where its block sum shows; P2 full within
    0.02 px, the other modes' displacement within 1e-6 px (constant or zero
    steps), every mode's witness within 1e-4 relative."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from mobile_slam_tpu_torch.probes import call_overhead as p1
    from mobile_slam_tpu_torch.probes import lk_pack_probe as p2

    pts, img = p1.check_inputs("cuda")
    out = p1._touch_points_cuda(pts, img)
    assert torch.equal(out, p1.touch_points_ref(pts, img))
    assert bool((out != pts).all())
    q, prev_p, next_p = p2.inputs("cuda")
    for mode in p2.MODES:
        a, wa = p2._lk_probe_cuda(q, prev_p, next_p, p2.PAD, mode)
        b, wb = p2.lk_probe_ref(q, prev_p, next_p, p2.PAD, mode)
        tol = 0.02 if mode == "full" else 1e-6
        assert float((a - b).abs().max()) <= tol, mode
        assert float(((wa - wb).abs() / wb.abs().clamp(min=1.0)).max()) <= 1e-4, mode
    torch.cuda.synchronize()
