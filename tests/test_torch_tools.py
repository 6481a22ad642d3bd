"""The port's user tools against the repo's scripts, run in process on the CPU.

1. ``tools.compare_trajectories`` against
   ``scripts/evaluation/compare_trajectories.py`` on a run directory (TUM
   camera poses and the run's config) written from the simulation's
   trajectory (the ground truth io/synthetic writes as mocap0) with seeded
   noise and a similarity transform, and on the bare TUM file: the printed ATE / RPE lines are the same text, and every ATE / RPE
   figure the two compute agrees within 1e-9 m (deg for rotations). Without
   matplotlib, ``--save`` fails with a message saying so.
2. ``tools.export_replay_dataset`` against ``scripts/export_replay_dataset.py``
   at ``--duration=1 --size=64``: the same frame files, equal pixel for
   pixel after decoding, ``imu.csv`` the same text and ``manifest.json``
   equal key for key.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from mobile_slam_tpu_torch.config import load_config
from mobile_slam_tpu_torch.eval import simulation as sim
from mobile_slam_tpu_torch.io import synthetic
from mobile_slam_tpu_torch.io import trajectory as ttraj
from mobile_slam_tpu_torch.tools import compare_trajectories, export_replay_dataset
from mobile_slam_tpu_torch.utils.rotations import rot_to_quat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECONDS = 7.0        # RPE at 5 s needs pairs 5 s apart
TOL = 1e-9


def _script(rel):
    spec = importlib.util.spec_from_file_location(os.path.basename(rel)[:-3],
                                                  os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(mod, argv, capsys):
    saved = sys.argv
    sys.argv = [mod.__file__] + list(argv)
    try:
        mod.main()
    finally:
        sys.argv = saved
    return capsys.readouterr().out


# ---------------------------------------------------------------------------
# 1. compare_trajectories
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """(run directory, ground-truth CSV): the simulation's 7 s trajectory at
    the camera's 20 Hz (the mocap0 CSV as io/synthetic writes it), and the
    camera poses of a run that saw it through a similarity transform with
    seeded noise, in a logs/<ts>/ layout with the run's config copy."""
    root = tmp_path_factory.mktemp("compare")
    cfg_path = synthetic.CONFIG
    cfg = load_config(cfg_path)
    traj = sim.make_trajectory(SECONDS, 20.0)
    ts = synthetic.T_EPOCH + traj.ts
    gt = root / "gt.csv"
    with open(gt, "w") as f:
        f.write("#timestamp [ns],px,py,pz,qw,qx,qy,qz\n")
        for t, p, q in zip(ts, traj.p, traj.q):
            f.write(f"{int(round(t * 1e9))},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n")

    rs = np.random.RandomState(3)
    to_rot = compare_trajectories.quat_to_rot_np
    s, t0 = 1.3, np.array([0.4, -0.2, 1.1])
    Rs = to_rot(np.array([0.9, 0.1, -0.3, 0.2]) / np.linalg.norm([0.9, 0.1, -0.3, 0.2]))
    p_wb = s * (traj.p + rs.normal(scale=0.01, size=(len(ts), 3))) @ Rs.T + t0
    dq = np.concatenate([np.ones((len(ts), 1)), rs.normal(scale=0.005, size=(len(ts), 3))], 1)
    R_wb = Rs @ to_rot(traj.q) @ to_rot(dq / np.linalg.norm(dq, axis=1, keepdims=True))
    R_wc = R_wb @ cfg.camera.r_ic_mat
    p_wc = p_wb + R_wb @ cfg.camera.t_ic_vec
    run = root / "logs" / "run"
    run.mkdir(parents=True)
    keep = rs.rand(len(ts)) > 0.1                                # a run loses a few frames
    ttraj.write_tum(str(run / "trajectory_pose.txt"), ts[keep], p_wc[keep],
                    rot_to_quat(torch.as_tensor(R_wc[keep])).numpy())
    with open(cfg_path) as src, open(run / "config.yaml", "w") as dst:
        dst.write(src.read())
    return str(run), str(gt)


def _recording(mod, monkeypatch):
    """Patch ``mod``'s compute_ate / compute_rpe to record their results."""
    got = []
    for name in ("compute_ate", "compute_rpe"):
        fn = getattr(mod, name)

        def rec(*a, _fn=fn, **k):
            got.append(_fn(*a, **k))
            return got[-1]

        monkeypatch.setattr(mod, name, rec)
    return got


@pytest.mark.parametrize("source", ["run_dir", "tum_file"])
def test_compare_trajectories_matches_script(run_dir, source, capsys, monkeypatch):
    path, gt = run_dir
    if source == "tum_file":
        path = os.path.join(path, "trajectory_pose.txt")      # no config: camera poses as they are
    argv = [path, "--gt", gt, "--no-display"]
    script = _script("scripts/evaluation/compare_trajectories.py")
    want = _recording(script, monkeypatch)
    ref_out = _run_script(script, argv, capsys)
    got = _recording(compare_trajectories, monkeypatch)
    assert compare_trajectories.main(argv) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert [ln for ln in lines if ln.startswith(("ATE", "RPE"))] == lines and len(lines) == 3
    assert out == ref_out
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for field in dataclasses.fields(a):
            x, y = getattr(a, field.name), getattr(b, field.name)
            assert x == y if isinstance(x, int) else abs(x - y) <= TOL, field.name
    assert got[0].num_pairs > 100 and got[2].num_pairs > 0      # RPE at 5 s found pairs


def test_compare_trajectories_save_needs_matplotlib(run_dir, monkeypatch, tmp_path):
    """The card's machine has no matplotlib: ``--save`` then exits with a
    message, after printing the figures."""
    path, gt = run_dir
    monkeypatch.setitem(sys.modules, "matplotlib", None)      # import raises ImportError
    with pytest.raises(SystemExit, match="matplotlib is not installed"):
        compare_trajectories.main([path, "--gt", gt, "--save", str(tmp_path / "p.png"),
                                   "--no-display"])
    assert not (tmp_path / "p.png").exists()


# ---------------------------------------------------------------------------
# 2. export_replay_dataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = tmp_path_factory.mktemp("replay")
    ours, ref = str(root / "port"), str(root / "ref")
    flags = ["--duration=1", "--size=64"]
    assert export_replay_dataset.main([ours] + flags) == 0
    saved = sys.argv
    sys.argv = ["export_replay_dataset.py", ref] + flags
    try:
        _script("scripts/export_replay_dataset.py").main()
    finally:
        sys.argv = saved
    return ours, ref


def test_export_frames_equal_script(exports):
    ours, ref = exports
    names = sorted(os.listdir(os.path.join(ref, "frames")))
    assert names == sorted(os.listdir(os.path.join(ours, "frames")))
    assert len(names) == 21 and all(n.endswith(".png") for n in names)
    for name in names:
        a, b = (cv2.imread(os.path.join(r, "frames", name), cv2.IMREAD_UNCHANGED)
                for r in (ours, ref))
        assert a.shape == (64, 64) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_export_imu_and_manifest_equal_script(exports):
    ours, ref = exports
    with open(os.path.join(ours, "imu.csv")) as a, open(os.path.join(ref, "imu.csv")) as b:
        assert a.read() == b.read()
    with open(os.path.join(ours, "manifest.json")) as a, \
            open(os.path.join(ref, "manifest.json")) as b:
        got, want = json.load(a), json.load(b)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    assert [f["file"] for f in got["frames"]] == [f"frames/{i:05d}.png" for i in range(21)]
