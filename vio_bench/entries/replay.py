"""Bulk replay of recordings through the port's chunked server
(``engine/serving.ChunkedImageServer``), unpaced: frames and IMU go in as
fast as the server takes them.

Set-up: the run's recordings and their frames, a server on the first
recording, streamed until it enters chunked mode, and one warm chunk. The
window continues that recording; when a recording ends, ``flush`` runs its
last, partial chunk and the next recording (the run's list, round) starts
in a new server, whose start-up falls inside the window. The window ends
with the first chunk (or streamed frame) that completes after ``seconds``.
``replay_fps`` is every frame whose result came back in the window over the
window's elapsed time. Where the window held fewer than ``check_frames``
frames (a slower program or host), the replay goes on, untimed, until it
has: the checks always judge at least that many frames past the set-up.

``failed`` counts the window's frames without a pose, less a recording's
initialisation: its frames before its first pose, among the first
``init_frames`` (the traffic file's) fed to its fresh server. The
configuration owes a pose only once the first is served; the cap keeps a
recording that never serves one failing.
"""

from __future__ import annotations

import math
import sys
import time

import torch

from vio_bench.entries import common
from vio_bench.harness import Run
from vio_bench.trace import Trace

MIN_SEGMENT_POSES = 30   # a recording started at the window's end is too short to align


class Segment:
    """One recording through one server."""

    def __init__(self, rec, server):
        self.rec, self.server = rec, server
        self.fi = self.imu_i = 0
        self.fed, self.results, self.states = [], [], []

    @property
    def done(self) -> bool:
        return self.fi >= len(self.rec.cam_ts)

    def step(self) -> tuple[int, bool]:
        """Feed the next frame; (results that came back, whether the server
        ran work for it)."""
        rec, server, fi = self.rec, self.server, self.fi
        ts = float(rec.cam_ts[fi])
        self.imu_i = common.feed_imu(server, rec, self.imu_i, ts)
        streaming = server.mode == "stream"
        out = server.process_frame(rec.frames[fi], ts)
        self.fed.append((ts, streaming))
        self.results += out
        if streaming or out:
            carry = server._carry
            state = carry.tracker_state if carry is not None else server.engine.tracker_state
            self.states.append((fi, common.tracked_slots(state)))
        self.fi += 1
        return len(out), streaming or bool(out)

    def flush(self) -> int:
        out = self.server.flush()
        self.results += out
        return len(out)


def run(cfg, traffic, seed, seconds, trace, t_start, device="cuda") -> Run:
    from mobile_slam_tpu_torch.engine.serving import ChunkedImageServer

    init = init_frames(traffic)
    marks = common.Marks(t_start)
    marks("imports")
    vio_cfg = common.vio_config(cfg)
    recs = common.recordings(cfg, traffic, seed, traffic["recordings"],
                             traffic["recording_s"], device)

    def segment(k: int) -> Segment:
        return Segment(recs[k % len(recs)], ChunkedImageServer(
            vio_cfg, chunk_size=traffic["chunk_size"], stable_frames=traffic["stable_frames"],
            device=device))

    marks(f"{len(recs)} recordings and frames")
    segs = [segment(0)]
    marks("server")
    while segs[0].server.mode == "stream":
        if segs[0].fi >= traffic["max_setup_frames"]:
            raise RuntimeError(f"no chunked mode within {segs[0].fi} frames")
        segs[0].step()
    marks(f"{segs[0].fi} frames to chunked mode")
    while segs[0].server.n_chunks < 1:
        if segs[0].fi >= traffic["max_setup_frames"]:
            raise RuntimeError(f"no chunk within {segs[0].fi} frames")
        segs[0].step()
    marks("warm chunk")
    fed0, came = len(segs[0].fed), 0

    def fed() -> int:
        return len(segs[0].fed) - fed0 + sum(len(s.fed) for s in segs[1:])

    def step() -> tuple[int, bool]:
        seg = segs[-1]
        if seg.done:
            n = seg.flush()
            segs.append(segment(len(segs)))
            return n, False
        return seg.step()

    with Trace(trace) as tr:
        t_w = time.perf_counter()
        setup_s = t_w - t_start
        while True:
            n, ran = step()
            came += n
            if ran and time.perf_counter() - t_w >= seconds:
                break
        elapsed = time.perf_counter() - t_w
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    window = fed()
    while fed() < traffic["check_frames"]:
        step()
    segs[-1].flush()
    for s in segs:
        del s.server
    common.release(device)

    notes = [f"{window} frames in the window; {fed() - window} frames after it for the checks"]
    checks, failed = _checks(cfg, segs, fed0, window, init, notes)
    print(f"vio_bench: {came} results of {window} frames in {elapsed:.3f} s over "
          f"{len(segs)} recording(s)", file=sys.stderr)
    print(f"vio_bench: {marks.line()}", file=sys.stderr)
    records = tr.records()
    records.update(frames=window, **common.lk_least(records, cfg, cfg["tracker"]["max_points"]))
    return Run(e2e={"replay_fps": came / elapsed, "setup_s": setup_s}, records=records,
               checks=checks, attempted=window, failed=failed, memory_peak_bytes=peak,
               notes=notes)


def init_frames(traffic: dict) -> int:
    """The traffic's ``init_frames``, a whole number of frames; no default."""
    n = traffic.get("init_frames")
    if type(n) is not int or n < 0:
        raise ValueError(f"the traffic file needs init_frames, a whole number of frames; "
                         f"it has {n!r}")
    return n


def first_pose_frame(fed, served) -> int | None:
    """The frames fed before the first good pose of a recording (``fed``:
    its stamps in order; ``served``: [(stamp, ok)]); None without one."""
    first = min((ts for ts, ok in served if ok), default=None)
    return None if first is None else sum(ts < first for ts in fed)


def failed_frames(segments, fed0: int, window: int, init: int) -> int:
    """The window's frames without a good pose. The window is the first
    ``window`` frames past the first recording's ``fed0``, through the
    recordings in turn (``segments``: [(fed stamps, [(served stamp, ok)])]).
    A frame among the first ``init`` fed to its recording, before that
    recording's first pose, is its initialisation and is not counted."""
    failed = 0
    for k, (fed, served) in enumerate(segments):
        ok = {ts for ts, good in served if good}
        first = min(ok, default=math.inf)
        start = fed0 if k == 0 else 0
        frames = list(enumerate(fed))[start:start + window]
        window -= len(frames)
        failed += sum(ts not in ok and not (i < init and ts < first) for i, ts in frames)
    return failed


def _checks(cfg, segs, fed0, window, init, notes) -> tuple[dict, int]:
    """The numbers compared, over every frame the recordings' servers
    were fed; and the window's frames without a pose (``failed_frames``)."""
    unanswered, missing, after = 0, 0, 0
    trajectories, tracks, segments, firsts = [], [], [], []
    for k, s in enumerate(segs):
        back = {r.ts for r in s.results}
        unanswered += sum(ts not in back for ts, streaming in s.fed if not streaming)
        unanswered += len(back - {ts for ts, _ in s.fed})
        ok = {r.ts for r in s.results if r.ok}
        first = min(ok) if ok else float("inf")
        later = [ts for ts, _ in s.fed if ts > first]
        after += len(later)
        missing += sum(ts not in ok for ts in later)
        segments.append(([ts for ts, _ in s.fed], [(r.ts, bool(r.ok)) for r in s.results]))
        n = first_pose_frame(*segments[-1])
        firsts.append(f"none in {len(s.fed)}" if n is None else str(n))
        good = [r for r in s.results if r.ok]
        if k == 0 or len(good) >= MIN_SEGMENT_POSES:
            trajectories.append((s.rec, [r.ts for r in good], [r.p for r in good]))
        tracks.append((s.rec, s.states))
    notes.append(f"frames to first pose by recording: {', '.join(firsts)} (init_frames {init})")
    failed = failed_frames(segments, fed0, window, init)
    return dict(unanswered=float(unanswered), missing_pct=100.0 * missing / max(after, 1),
                track_drift_p90_px=common.track_drift(cfg, tracks, notes),
                **common.trajectory_checks(trajectories)), failed
