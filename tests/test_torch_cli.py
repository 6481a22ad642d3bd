"""The port's file-driven entry point (``python -m mobile_slam_tpu_torch.cli``)
on the CPU.

1. ``cli.main([cfg, "--cpu", "--frames=24", "--pipelined",
   "--checkpoint=..."])`` on a 1.25 s sequence that the port's writer
   produced (configs/tum_vi_room1.yaml with ``max_cnt`` 60): exit code 0,
   TRACKING reached, the run directory holds the config copy, a TUM
   trajectory of finite poses, live.json and the evaluation; one warning
   says that ``--checkpoint`` is not written under ``--pipelined``, and no
   snapshot is written.
2. Without ``--cpu``, on a machine without a CUDA device, it raises and
   writes no run directory: it does not fall back to the CPU.
3. Importing ``cli``, ``VIOSystem``, ``checkpoint`` and ``io`` loads no
   module of the JAX package and not JAX itself (a fresh interpreter).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mobile_slam_tpu_torch import cli
from mobile_slam_tpu_torch.io import synthetic
from mobile_slam_tpu_torch.io.trajectory import read_tum

torch.set_num_threads(1)      # one thread per test worker, as tests/_torch_parity.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 24


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    seq = str(root / "seq")
    synthetic.write_sequence(seq, synthetic.sim_config(1.25, seed=7, noise=True))
    text = open(os.path.join(REPO, "configs", "tum_vi_room1.yaml")).read()
    lines = [f"dataset_path: {seq}" if ln.startswith("dataset_path:")
             else "max_cnt: 60" if ln.startswith("max_cnt:") else ln
             for ln in text.splitlines()]
    path = root / "cfg.yaml"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_cli_runs_on_the_cpu(config_path, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    snapshot = tmp_path / "snap.npz"
    assert cli.main([config_path, "--cpu", f"--frames={FRAMES}", "--pipelined",
                     f"--checkpoint={snapshot}"]) == 0
    err = capsys.readouterr().err
    assert err.count("--checkpoint is not written under --pipelined") == 1
    assert "[cli] device: cpu" in err
    assert not snapshot.exists()
    (run,) = os.listdir(tmp_path / "logs")
    run = tmp_path / "logs" / run
    for name in ("config.yaml", "trajectory_pose.txt", "live.json", "evaluation.txt",
                 "evaluation.json"):
        assert (run / name).exists(), name
    assert (run / "config.yaml").read_text() == open(config_path).read()
    ts, p, q = read_tum(str(run / "trajectory_pose.txt"))
    assert len(ts) > 10 and np.isfinite(p).all() and np.isfinite(q).all()
    assert np.all(np.diff(ts) > 0)
    live = json.loads((run / "live.json").read_text())
    assert live["frames"] == 20 and live["status"] == "TRACKING"
    assert {"tracker_dispatch", "solve_dispatch", "result_wait"} <= set(live["stage_ms"])
    evaluation = json.loads((run / "evaluation.json").read_text())
    assert evaluation["frames"] == FRAMES and evaluation["poses"] == len(ts)
    assert np.isfinite(evaluation["ate_rmse_m"])


def test_cli_without_cpu_raises_on_a_machine_without_a_card(config_path, tmp_path,
                                                             monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main([config_path, f"--frames={FRAMES}"])
    assert not (tmp_path / "logs").exists()


def test_entry_point_imports_nothing_of_jax():
    code = ("import sys\n"
            "import mobile_slam_tpu_torch.cli, mobile_slam_tpu_torch.engine.vio_system\n"
            "import mobile_slam_tpu_torch.engine.checkpoint\n"
            "import mobile_slam_tpu_torch.io.dataset, mobile_slam_tpu_torch.io.native_loader\n"
            "import mobile_slam_tpu_torch.io.png, mobile_slam_tpu_torch.io.synthetic\n"
            "import mobile_slam_tpu_torch.io.trajectory, mobile_slam_tpu_torch.eval.visualizer\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'mobile_slam_tpu' or m.startswith('mobile_slam_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
