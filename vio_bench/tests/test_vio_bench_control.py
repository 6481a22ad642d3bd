"""The control of ``correct`` on the card: each cell run under the control
its configuration names (``control.py``; ``solve_skipped``, which breaks
the stated trajectory guarantee) must come out not correct. Card only (the ``cuda``
marker; skips without a card). On the card's machine, from the root of the
repo: ``python -m pytest --noconftest -m cuda vio_bench/tests/test_vio_bench_control.py``
(about 2 minutes a cell)."""

from __future__ import annotations

import pytest
import torch

from vio_bench import control, harness

SEED = 2 ** 31 + 29
BENCH = harness.benchmark()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [c["name"] for c in BENCH["workloads"]])
def test_the_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control runs the cell on an NVIDIA GPU")
    harness.set_cache_dirs()
    cell = harness.find_cell(BENCH, workload)
    arm = harness.load_json("configs", f"{cell['config']}.json")["control"]
    out = control.run_arm(workload, SEED, BENCH["run_seconds"], arm)
    assert not out["correct"], out
