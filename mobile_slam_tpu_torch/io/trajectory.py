"""Trajectory output: TUM-format writer + per-run result logging.

Mirror of src/utility/test_result_logger.cpp: a timestamped logs/<ts>/
directory holding a copy of the config, the TUM-format trajectory
(`# timestamp tx ty tz qx qy qz qw`, test_result_logger.cpp:84), and the
evaluation summary; poses are appended with periodic flush (:89-108).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np


def write_tum(path: str, ts, p, q_wxyz) -> None:
    """Write a TUM-format trajectory file (qx qy qz qw order on disk)."""
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, pos, quat in zip(ts, p, q_wxyz):
            f.write(
                f"{t:.9f} {pos[0]:.6f} {pos[1]:.6f} {pos[2]:.6f} "
                f"{quat[1]:.6f} {quat[2]:.6f} {quat[3]:.6f} {quat[0]:.6f}\n"
            )


def read_tum(path: str):
    """Read a TUM-format trajectory. Returns (ts, p (N,3), q_wxyz (N,4))."""
    ts, p, q = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            if len(v) < 8:
                continue
            ts.append(v[0])
            p.append(v[1:4])
            q.append([v[7], v[4], v[5], v[6]])  # xyzw -> wxyz
    return (np.asarray(ts), np.asarray(p).reshape(-1, 3),
            np.asarray(q).reshape(-1, 4))


class ResultLogger:
    """TestResultLogger parity: logs/<timestamp>/ run directory."""

    FLUSH_EVERY = 50  # periodic flush (vio_system.cpp:289-293)

    def __init__(self, log_root: str = "logs", config_blob: str | None = None):
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self.dir = os.path.join(log_root, stamp)
        os.makedirs(self.dir, exist_ok=True)
        if config_blob is not None:
            with open(os.path.join(self.dir, "config.yaml"), "w") as f:
                f.write(config_blob)
        self.ts: list[float] = []
        self.p: list[np.ndarray] = []
        self.q: list[np.ndarray] = []

    @property
    def trajectory_path(self) -> str:
        return os.path.join(self.dir, "trajectory_pose.txt")

    def add_pose(self, t: float, p, q_wxyz) -> None:
        self.ts.append(float(t))
        self.p.append(np.asarray(p, float))
        self.q.append(np.asarray(q_wxyz, float))
        if len(self.ts) % self.FLUSH_EVERY == 0:
            self.flush()

    def flush(self) -> None:
        write_tum(self.trajectory_path, self.ts, self.p, self.q)

    def save_evaluation(self, results: dict) -> None:
        self.flush()
        with open(os.path.join(self.dir, "evaluation.txt"), "w") as f:
            for k, v in results.items():
                f.write(f"{k}: {v}\n")
        with open(os.path.join(self.dir, "evaluation.json"), "w") as f:
            json.dump(results, f, indent=2, default=float)
