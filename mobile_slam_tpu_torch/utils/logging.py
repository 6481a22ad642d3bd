"""Leveled logging and frame profiling (torch twin of
mobile_slam_tpu.utils.logging).

Leveled ``debug`` / ``info`` / ``warn`` / ``error`` to stderr with the
caller's file:line (level from ``SLAM_LOG_LEVEL``), a ``FrameProfiler``
that aggregates per-stage wall times and the frame rate, and
``device_trace``, a ``torch.profiler`` capture that writes a Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import os
import sys
import time

LEVELS = {"DEBUG": 0, "INFO": 1, "WARN": 2, "ERROR": 3}
_LEVEL = LEVELS.get(os.environ.get("SLAM_LOG_LEVEL", "INFO").upper(), 1)


def _log(level: str, msg: str) -> None:
    if LEVELS[level] >= _LEVEL:
        frame = sys._getframe(2)
        loc = f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"
        print(f"[{level}] {loc} {msg}", file=sys.stderr)


def debug(msg: str) -> None:
    _log("DEBUG", msg)


def info(msg: str) -> None:
    _log("INFO", msg)


def warn(msg: str) -> None:
    _log("WARN", msg)


def error(msg: str) -> None:
    _log("ERROR", msg)


class FrameProfiler:
    """Per-stage wall-time aggregation + FPS counter."""

    def __init__(self, window: int = 120):
        self.stages = collections.defaultdict(
            lambda: collections.deque(maxlen=window))
        self.frame_times = collections.deque(maxlen=window)
        self._last_frame = None

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.stages[name].append(time.perf_counter() - t0)

    def tick_frame(self) -> None:
        now = time.perf_counter()
        if self._last_frame is not None:
            self.frame_times.append(now - self._last_frame)
        self._last_frame = now

    @property
    def fps(self) -> float:
        if not self.frame_times:
            return 0.0
        return len(self.frame_times) / sum(self.frame_times)

    def summary(self) -> dict:
        out = {"fps": self.fps}
        for name, times in self.stages.items():
            if times:
                out[f"{name}_ms"] = 1e3 * sum(times) / len(times)
        return out


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Profile the enclosed code with ``torch.profiler``: CPU activity, and
    CUDA activity when ``device`` is a CUDA device (which raises on a
    machine without one). On exit the trace is
    written to ``log_dir/trace.json`` (Chrome trace format). Yields the
    profiler, whose ``key_averages()`` summarize the run."""
    from torch.profiler import ProfilerActivity, profile

    from mobile_slam_tpu_torch.engine.vio_engine import require_device

    activities = [ProfilerActivity.CPU]
    if require_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
