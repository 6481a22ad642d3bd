"""CPU tests of the benchmark's harness (run from the root of the repo:
``python -m pytest vio_bench/tests/test_vio_bench_harness.py``)."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from vio_bench import harness, roofline
from vio_bench.entries import common, replay
from vio_bench.sim import render, world
from vio_bench.sim.cameras import Camera

ROOT = harness.ROOT
BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "mobile_slam_tpu"}
PORT = "mobile_slam_tpu_torch"


def _imports(path: Path) -> set:
    """Top-level names of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def _modules(path: Path) -> set:
    """Full names of the vio_bench modules a file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("vio_bench"):
            out |= {f"{node.module}.{a.name}" for a in node.names} | {node.module}
        elif isinstance(node, ast.Import):
            out |= {a.name for a in node.names if a.name.startswith("vio_bench")}
    return out


def _file(module: str):
    path = ROOT / Path(*module.split("."))
    for cand in (path.with_suffix(".py"), path / "__init__.py"):
        if cand.exists():
            return cand
    return None


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves_to_its_files(cell):
    cfg = harness.load_json("configs", f"{cell['config']}.json")
    traffic = harness.load_json("traffic", f"{cell['traffic']}.json")
    limits = harness.load_json("limits", f"{cell['name']}.json")
    assert cfg["name"] == cell["config"]
    assert (harness.BENCH_DIR / "entries" / f"{traffic['entry']}.py").exists()
    assert set(limits["checks"]) == {"unanswered", "missing_pct", "ate_m", "err_max_m"}
    assert traffic["check_frames"] > 0
    assert cfg["control"] in __import__("vio_bench.control").control.ARMS
    assert harness.reported_e2e(BENCH, cell) and harness.reported_layers(BENCH, cell)
    assert "setup_s" in {m["name"] for m in harness.reported_e2e(BENCH, cell)}


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_resolves_and_reads_nothing_from_nothing(metric):
    assert harness.read_metric(metric["name"], {}) is None
    moves = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    for w in metric["workloads"]:
        assert w in moves.get("workloads", [w])


def test_configs_and_layers():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("vio_bench/") and cfg["name"] == c["name"]
        assert c["reduced"] == list(cfg["reduced"])
        assert cfg["source"] and cfg["deployment"] and cfg["assumed"]
        common.vio_config(cfg)          # every key is the port's
    assert {w["config"] for w in BENCH["workloads"]} == set(names)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert layers["lk_roofline"] == {"kernels (ops/lk.py, csrc/lk_kernels.cu: K1-K3)"}


def test_names_units_and_limits_of_the_contract():
    allowed = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
               "per_layer"}
    assert set(BENCH) == allowed
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for part, want in keys.items():
        for e in BENCH[part]:
            extra = {"workloads"} if part in ("end_to_end", "per_layer") else set()
            assert want <= set(e) <= want | extra, (part, e["name"])
    for c in BENCH["configs"]:
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
        assert len(c["reduced"]) <= 16
    assert len(BENCH["command"]) <= 32
    assert all(1 <= len(w) <= 200 and "\n" not in w and "\t" not in w for w in BENCH["command"])
    everything = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in everything:
        assert NAME.match(e["name"]), e["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and w["chips"] in (1, 4)
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("device_trace", "host_clock") and 0.01 <= m["bound"] <= 0.25
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_nothing_imports_jax_or_the_jax_package():
    for path in harness.BENCH_DIR.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    todo = [p for p in (harness.BENCH_DIR / "reference").rglob("*.py")]
    seen = set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        assert PORT not in _imports(path) and not _imports(path) & FORBIDDEN, path
        todo += [f for f in map(_file, _modules(path)) if f is not None]
    assert any("sim" in str(p) for p in seen)        # the simulator is the reference's truth


def _fake_run():
    recs = dict(window_s=45.0, busy_s=2.0, launches=100000, syncs=500, frames=50,
                lk_least_s=1e-6, lk_device_s=1e-3,
                device_ops=[["k", 1.0]], idle_gaps=[["host in x; then k", 0.1]])
    return harness.Run(e2e={"replay_fps": 3.0, "setup_s": 40.0},
                       records=recs, checks={"ate_m": 0.01}, attempted=50, failed=0,
                       memory_peak_bytes=1)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_result_line_keys(cell, trace):
    correct, out = harness.judge({"ate_m": 0.01}, {"ate_m": {"max": 0.05}, "track_drift_p90_px":
                                                    {"max": 1.0}})
    assert not correct and out["track_drift_p90_px"]["value"] is None
    device = {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1}
    line = harness.result_line(cell, BENCH, _fake_run(), bool(trace), out, correct, device)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    json.dumps(line)
    want = harness.reported_layers(BENCH, cell) if trace else harness.reported_e2e(BENCH, cell)
    assert set(line["metrics"]) == {m["name"] for m in want}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert all(0 < v["value"] <= 100 for k, v in line["metrics"].items() if "%" == {
            m["name"]: m["unit"] for m in BENCH["per_layer"]}[k])


def test_bound_arithmetic_equals_the_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    for win in (15, 21):
        for fn in ("template_flops", "sums_flops", "track_iter_flops", "refine_iter_flops",
                   "refine_fixed_flops"):
            assert getattr(roofline, fn)(win) == getattr(cs, f"_{fn}")(win)
    assert roofline.bound(1e6, 3e9) == cs._bound(1e6, 3e9)
    assert roofline.bound(1e9, 3e6) == cs._bound(1e9, 3e6)
    g = torch.Generator().manual_seed(0)
    pyr0 = [torch.rand(64 >> lv, 80 >> lv, generator=g) for lv in range(3)]
    pyr1 = [torch.rand(64 >> lv, 80 >> lv, generator=g) for lv in range(3)]
    pts = torch.rand(20, 2, generator=g) * torch.tensor([80.0, 64.0])
    wins = [(lv, torch.rand(20, generator=g) * (80 >> lv), torch.rand(20, generator=g) * (64 >> lv))
            for lv in range(3)]
    assert roofline.k1_read_bytes(pyr0, pyr1, pts, wins, 15) == cs._k1_read_bytes(
        pyr0, pyr1, pts, wins, 15)
    oy = roofline.origin(pts[:, 1], 8, 9, 64, 18)
    ox = roofline.origin(pts[:, 0], 8, 9, 80, 18)
    assert torch.equal(oy, cs._origin(pts[:, 1], 8, 9, 64, 18))
    assert roofline.footprint_bytes(pyr0[0], oy, ox, 18) == cs._footprint_bytes(pyr0[0], oy, ox, 18)
    one = roofline.least_s("track", 160, 21, 3, 512, 512)
    assert 0 < one < roofline.least_s("track", 640, 21, 3, 512, 512) < 1e-4


GREY_LEVELS = 1     # frames of the torch renderer against the numpy one, at any pixel


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_frozen_renderer_agrees_with_the_ports(name):
    from mobile_slam_tpu_torch.eval import simulation as psim
    from mobile_slam_tpu_torch.models.cameras.base import make_camera

    cfg = harness.load_json("configs", f"{name}.json")
    sim = dict(cfg["sim"], duration=0.5, cam_time_offset=0.0)
    rec = world.simulate(sim, 2 ** 31 + 17, t0=4.5)
    r_ic, t_ic = common.mount(cfg)
    frames = render.render(rec, Camera.from_config(cfg["camera"]), r_ic, t_ic, "cpu")
    pcam = make_camera(common.vio_config(cfg).camera, dtype=torch.float64, device="cpu")
    seen = types.SimpleNamespace(gt_q=rec.seen_q, gt_p=rec.seen_p, landmarks=rec.landmarks)
    for fi in (0, len(frames) - 1):
        ref = psim.render_frame(seen, fi, pcam, r_ic, t_ic)
        assert np.abs(ref.astype(int) - frames[fi].astype(int)).max() <= GREY_LEVELS


def test_frozen_world_equals_the_ports():
    from mobile_slam_tpu_torch.eval import simulation as psim

    ts, p, q, v, acc, gyr = world.make_trajectory(3.0, 200.0)
    ref = psim.make_trajectory(3.0, 200.0)
    for a, b in ((p, ref.p), (q, ref.q), (v, ref.v), (acc, ref.acc_body), (gyr, ref.gyr_body)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(world.make_landmarks(200, 5), psim.make_landmarks(200, 5))


def test_recordings_come_from_the_seed():
    cfg = harness.load_json("configs", "tumvi_room_512.json")
    sim = dict(cfg["sim"], duration=1.0)
    seeds = world.recording_seeds(2 ** 31 + 5, 3)
    assert seeds == world.recording_seeds(2 ** 31 + 5, 3) and len(set(seeds)) == 3
    a, b = world.simulate(sim, seeds[0]), world.simulate(sim, seeds[0])
    assert np.array_equal(a.imu_acc, b.imu_acc) and np.array_equal(a.landmarks, b.landmarks)
    assert not np.array_equal(a.landmarks, world.simulate(sim, seeds[1]).landmarks)
    phases = [0.0, 2.25, 4.5, 6.75]
    assert sorted(world.phase_order(99, phases, 4)) == phases


def test_a_checkout_of_the_benchmark_alone_refuses(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "vio_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-m", "vio_bench.run", "--workload",
                           BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_without_a_card_the_run_refuses():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    code = harness.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "3",
                         "--seconds", "1", "--trace", "0"], 0.0)
    assert code != 0



# The failed count (``replay.failed_frames``) on recordings of 301 frames at
# 20 Hz: the set-up feeds the first recording's first FED0 frames, and a
# fresh engine serves its first pose at frame 11 (its window of 10 filled).
FED0, INIT, FIRST = 40, 25, 11


def _recording(k: int, n: int, poses=range(FIRST, 301), bad=()) -> tuple:
    """(fed stamps, [(served stamp, ok)]) of the ``k``-th recording fed
    ``n`` frames, with good poses at the frames ``poses`` less ``bad``."""
    fed = [100.0 * k + 0.05 * i for i in range(n)]
    return fed, [(fed[i], i in poses and i not in bad) for i in range(n)]


def _old_count(segments, fed0, window) -> int:
    """The count before ``init_frames``: every window frame without a pose."""
    failed = 0
    for k, (fed, served) in enumerate(segments):
        ok = {ts for ts, good in served if good}
        window_fed = (fed[fed0:] if k == 0 else fed)[:window]
        window -= len(window_fed)
        failed += sum(ts not in ok for ts in window_fed)
    return failed


def test_a_second_recording_initialising_at_frame_11_fails_nothing():
    segments = [_recording(0, 301), _recording(1, 48)]
    window = 301 - FED0 + 48
    assert replay.first_pose_frame(*segments[1]) == FIRST
    assert replay.failed_frames(segments, FED0, window, INIT) == 0
    assert _old_count(segments, FED0, window) == FIRST


def test_a_recording_that_never_serves_fails_past_init_frames():
    segments = [_recording(0, 301), _recording(1, 48, poses=())]
    assert replay.first_pose_frame(*segments[1]) is None
    assert replay.failed_frames(segments, FED0, 301 - FED0 + 48, INIT) == 48 - INIT
    # frames past the window are not the window's
    assert replay.failed_frames(segments, FED0, 301 - FED0 + 30, INIT) == 30 - INIT


@pytest.mark.parametrize("bad,want", [((15,), 1), ((30,), 1), ((12, 24, 25, 40), 4)],
                         ids=["inside-init", "past-init", "both"])
def test_a_pose_missing_after_the_first_fails(bad, want):
    segments = [_recording(0, 301), _recording(1, 48, bad=bad)]
    assert replay.failed_frames(segments, FED0, 301 - FED0 + 48, INIT) == want


@pytest.mark.parametrize("bad", [(), (50,), (45, 46, 120, 200), (39, 41, 250)])
@pytest.mark.parametrize("window", [130, 261])
def test_one_recording_counts_as_before(bad, window):
    segments = [_recording(0, 301, bad=bad)]
    want = _old_count(segments, FED0, window)
    assert replay.failed_frames(segments, FED0, window, INIT) == want
    assert want == sum(FED0 <= i < FED0 + window for i in bad)


def test_init_frames_comes_from_the_traffic_file():
    traffic = harness.load_json("traffic", "replay_chunk25.json")
    assert replay.init_frames(traffic) == 25
    del traffic["init_frames"]
    with pytest.raises(ValueError, match="init_frames"):
        replay.init_frames(traffic)
    for wrong in (None, -1, 2.5, "25", True):
        with pytest.raises(ValueError, match="init_frames"):
            replay.init_frames(dict(traffic, init_frames=wrong))
