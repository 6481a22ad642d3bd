"""What the entry modules share: the recordings of a run, the port's
configuration built from the configuration file, IMU feeding, the checks
against the reference and the reduction of the trace's K1-K3 records."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from vio_bench import roofline
from vio_bench.reference import truth
from vio_bench.sim import render, world
from vio_bench.sim.cameras import Camera

MIN_TRACK_COUNT = 2      # a slot counts once the tracker has carried it a frame


def mount(cfg: dict):
    cam = cfg["camera"]
    return np.asarray(cam["r_ic"], float).reshape(3, 3), np.asarray(cam["t_ic"], float)


def camera(cfg: dict) -> Camera:
    return Camera.from_config(cfg["camera"])


def recordings(cfg: dict, traffic: dict, seed: int, n: int, duration: float,
               device) -> list[world.Recording]:
    """``n`` recordings of ``duration`` seconds from the run's seed, each
    with its own landmarks, noise and figure phase, rendered on ``device``;
    the device's memory statistics are reset after, so that the peak the
    run reports is the program's."""
    sim = dict(cfg["sim"], duration=duration)
    r_ic, t_ic = mount(cfg)
    cam = camera(cfg)
    out = []
    for s, t0 in zip(world.recording_seeds(seed, n), world.phase_order(seed, traffic["phases_s"], n)):
        rec = world.simulate(sim, s, t0)
        rec.frames = render.render(rec, cam, r_ic, t_ic, device)
        out.append(rec)
    release(device)
    return out


def release(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def vio_config(cfg: dict):
    """The port's ``VIOConfig`` as the configuration file states it."""
    from mobile_slam_tpu_torch.config import (CameraConfig, EstimatorConfig,
                                              TrackerConfig, VIOConfig)

    cam = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["camera"].items()}
    return VIOConfig(camera=CameraConfig(**cam), tracker=TrackerConfig(**cfg["tracker"]),
                     estimator=EstimatorConfig(**cfg["estimator"]))


def feed_imu(sink, rec: world.Recording, imu_i: int, ts: float) -> int:
    """Push the recording's IMU samples up to ``ts`` into ``sink``."""
    while imu_i < len(rec.imu_ts) and rec.imu_ts[imu_i] <= ts + 1e-9:
        sink.push_imu(rec.imu_ts[imu_i], rec.imu_acc[imu_i], rec.imu_gyr[imu_i])
        imu_i += 1
    return imu_i


def tracked_slots(tracker_state):
    """References to the tracker's slot tensors (no copy, no sync)."""
    return tracker_state.ids, tracker_state.pts, tracker_state.active, tracker_state.track_cnt


def track_drift(cfg: dict, sequences, notes: list | None = None) -> float | None:
    """90th percentile of the drift (px) of the tracked corners from their
    landmarks (``truth.track_drift_px``) over ``sequences`` [(recording,
    [(frame, slots of one sequence)])]: the tail, where tracks that slid
    off their point show; None without a later sighting. The median and
    the count go to ``notes``."""
    cam, (r_ic, t_ic) = camera(cfg), mount(cfg)
    drift = []
    for rec, samples in sequences:
        rows = []
        for fi, (ids, pts, active, cnt) in samples:
            keep = (active & (cnt >= MIN_TRACK_COUNT)).cpu().numpy()
            rows.append((fi, ids.cpu().numpy()[keep], pts.cpu().numpy()[keep]))
        drift.append(truth.track_drift_px(rec, cam, r_ic, t_ic, rows))
    drift = np.concatenate(drift) if drift else np.zeros(0)
    if not len(drift):
        return None
    if notes is not None:
        notes.append(f"track drift: {len(drift)} sightings, median {np.median(drift):.4f} px, "
                     f"p90 {np.percentile(drift, 90):.4f} px")
    return float(np.percentile(drift, 90))


def trajectory_checks(segments) -> dict:
    """ATE (RMSE) and the largest single error over trajectory segments
    [(recording, stamps, positions)], each the worst segment's; None when
    a segment gives no number."""
    ate, worst = 0.0, 0.0
    for rec, ts, p in segments:
        err = truth.trajectory_errors(rec, ts, p)
        if err is None:
            return {"ate_m": None, "err_max_m": None}
        ate = max(ate, float(np.sqrt(np.mean(err ** 2))))
        worst = max(worst, float(err.max()))
    if not segments:
        return {"ate_m": None, "err_max_m": None}
    return {"ate_m": ate, "err_max_m": worst}


def lk_least(records: dict, cfg: dict, slots: int) -> dict:
    """The trace's K1-K3 launches with the least time their shapes need
    (``roofline.least_s``); {} when the run was not traced."""
    if "lk" not in records:
        return {}
    tr, cam = cfg["tracker"], cfg["camera"]
    least = dev = 0.0
    for kind, rec in records["lk"].items():
        least += rec["launches"] * roofline.least_s(
            kind, slots, tr["lk_window_size"], tr["lk_pyramid_levels"], cam["height"], cam["width"])
        dev += rec["device_s"]
    return {"lk_least_s": least, "lk_device_s": dev}


class Marks:
    """Host-clock marks of a run's set-up, printed as the seconds between
    them (``setup_s`` broken down)."""

    def __init__(self, t_start: float):
        self.marks = [("process start", t_start)]

    def __call__(self, label: str) -> None:
        self.marks.append((label, time.perf_counter()))

    def line(self) -> str:
        return "set-up: " + ", ".join(
            f"{b[0]} {b[1] - a[1]:.2f} s" for a, b in zip(self.marks, self.marks[1:]))
