"""GPU tier of the PyTorch port: ``pytest -m cuda tests/test_torch_cuda.py``.

Runs chip_smoke.py in a subprocess: it builds the CUDA LK kernels, holds
each against its plain PyTorch version at main-path shapes and drives the
port's engine over the bench sequence. The subprocess exits with 42 when no
CUDA device is present, and the test then skips.
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
