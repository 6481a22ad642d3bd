"""Leveled logging, the span recorder and the device trace (torch twin of
mobile_slam_tpu.utils.logging).

Leveled ``debug`` / ``info`` / ``warn`` / ``error`` to stderr with the
caller's file:line (level from ``SLAM_LOG_LEVEL``).

The span recorder: the program opens ``span(name, **attrs)`` at the
boundaries of a frame's stages (engine/serving.py, engine/chunked.py,
frontend/tracker.py, engine/estimator.py, engine/vio_engine.py). A span is
stamped with ``CLOCK_NS``, the clock ``torch.profiler`` (kineto) stamps its
events with, so spans and the profiler's host and device events compare
directly. Recording is off by default: a span then reads the clock twice,
which its caller may use (``Span.seconds``), and keeps nothing. Under
``tracing()`` each closed span is kept, with its parent and its request (a
frame: the chunk's span id and the frame's index, or the frame's host
stamp in stream mode), in a bounded list that only ``drain()`` hands out.
No span reads a tensor or waits for the device.

``device_trace`` writes a ``torch.profiler`` Chrome trace with the spans
on a track of their own.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import sys
import threading
import time

LEVELS = {"DEBUG": 0, "INFO": 1, "WARN": 2, "ERROR": 3}
_LEVEL = LEVELS.get(os.environ.get("SLAM_LOG_LEVEL", "INFO").upper(), 1)

# Epoch nanoseconds: what kineto's events' start_ns() read (tests/test_torch_tracing.py
# holds a record_function inside a span on the CPU and a kernel launch on the card).
CLOCK_NS = time.time_ns
SPAN_LIMIT = 1 << 20
SPAN_TRACK = "program spans"     # device_trace's track (Chrome trace "pid") of the spans


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


class Span:
    """One stretch of the program, and the context manager around it.
    ``start_ns`` / ``end_ns`` on ``CLOCK_NS``; ``id``, ``parent`` (the
    enclosing span's id) and ``request`` are set only while recording
    (``id`` None otherwise). A span without a request of its own takes its
    parent's."""

    __slots__ = ("name", "attrs", "request", "start_ns", "end_ns", "id", "parent",
                 "_rec")

    def __init__(self, rec: Recorder, name: str, request, attrs: dict):
        self._rec, self.name, self.request, self.attrs = rec, name, request, attrs
        self.id = self.parent = None

    def __enter__(self) -> Span:
        if self._rec.on:
            self._rec._open(self)
        self.start_ns = CLOCK_NS()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = CLOCK_NS()
        if self.id is not None:
            self._rec._close(self)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Recorder:
    """Spans of every thread of the process, each thread with its own
    stack of open spans. Keeps at most ``limit`` closed spans until
    ``drain()``; those past it are counted in ``dropped``."""

    def __init__(self, limit: int = SPAN_LIMIT):
        self.limit = limit
        self.on = False
        self.dropped = 0
        self._depth = 0
        self._spans: list[Span] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def span(self, name: str, request=None, **attrs) -> Span:
        return Span(self, name, request, attrs)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, s: Span) -> None:
        stack = self._stack()
        s.id = next(self._ids)
        if stack:
            s.parent = stack[-1].id
            if s.request is None:
                s.request = stack[-1].request
        stack.append(s)

    def _close(self, s: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is s:
            stack.pop()
        if len(self._spans) < self.limit:
            self._spans.append(s)
        else:
            self.dropped += 1

    def enclosing(self, name: str):
        """The id of this thread's innermost open span named ``name``
        (None when off or there is none)."""
        if self.on:
            for s in reversed(self._stack()):
                if s.name == name:
                    return s.id
        return None

    @contextlib.contextmanager
    def tracing(self):
        """Record spans inside the block (nests); yields the recorder."""
        with self._lock:
            self._depth += 1
            self.on = True
        try:
            yield self
        finally:
            with self._lock:
                self._depth -= 1
                self.on = self._depth > 0

    def drain(self) -> list[Span]:
        """The closed spans kept so far, in closing order; empties the list."""
        out, self._spans = self._spans, []
        return out


RECORDER = Recorder()
span = RECORDER.span
tracing = RECORDER.tracing
drain = RECORDER.drain


def frame_request(index: int):
    """The request id of frame ``index`` of the innermost open ``chunk``
    span: (the chunk's span id, index); None when off."""
    return (RECORDER.enclosing("chunk"), index) if RECORDER.on else None


def traced(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with RECORDER.span(name):
                return fn(*args, **kwargs)
        return inner

    return wrap


def self_ns(spans: list[Span]) -> dict:
    """{span id: its duration less the part of it its child spans cover}
    (``choosing-metrics``' self time)."""
    children: dict = {}
    for s in spans:
        children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = {}
    for s in spans:
        covered, end = 0, s.start_ns
        for a, b in sorted(children.get(s.id, ())):
            a, b = max(a, end), min(b, s.end_ns)
            if b > a:
                covered += b - a
                end = b
        out[s.id] = (s.end_ns - s.start_ns) - covered
    return out


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Profile the enclosed code with ``torch.profiler`` (CPU activity, and
    CUDA activity when ``device`` is a CUDA device, which raises on a
    machine without one) and record the program's spans beside it. On exit
    the trace is written to ``log_dir/trace.json`` (Chrome trace format),
    with the recorder's spans (it drains the recorder) as complete events
    on a track of their own, ``SPAN_TRACK``, on the profiler's clock.
    Yields the profiler, whose ``key_averages()`` summarize the run."""
    from torch.profiler import ProfilerActivity, profile

    from mobile_slam_tpu_torch.engine.vio_engine import require_device

    activities = [ProfilerActivity.CPU]
    if require_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with tracing(), profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    # Kineto writes each event's "ts" in microseconds after baseTimeNanoseconds.
    base_ns = trace.get("baseTimeNanoseconds", 0)
    for s in drain():
        args = dict(s.attrs, id=s.id, parent=s.parent, request=str(s.request))
        trace["traceEvents"].append({
            "ph": "X", "cat": "span", "name": s.name, "pid": SPAN_TRACK, "tid": 0,
            "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)
