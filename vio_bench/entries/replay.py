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
"""

from __future__ import annotations

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
    checks, failed = _checks(cfg, segs, fed0, window, notes)
    print(f"vio_bench: {came} results of {window} frames in {elapsed:.3f} s over "
          f"{len(segs)} recording(s)", file=sys.stderr)
    print(f"vio_bench: {marks.line()}", file=sys.stderr)
    records = tr.records()
    records.update(frames=window, **common.lk_least(records, cfg, cfg["tracker"]["max_points"]))
    return Run(e2e={"replay_fps": came / elapsed, "setup_s": setup_s}, records=records,
               checks=checks, attempted=window, failed=failed, memory_peak_bytes=peak,
               notes=notes)


def _checks(cfg, segs, fed0, window, notes) -> tuple[dict, int]:
    """The numbers compared, over every frame the recordings' servers
    were fed; and the window's frames without a pose (its first
    ``window`` frames past the set-up's ``fed0``)."""
    unanswered, missing, after, failed = 0, 0, 0, 0
    trajectories, tracks = [], []
    for k, s in enumerate(segs):
        back = {r.ts for r in s.results}
        unanswered += sum(ts not in back for ts, streaming in s.fed if not streaming)
        unanswered += len(back - {ts for ts, _ in s.fed})
        ok = {r.ts for r in s.results if r.ok}
        first = min(ok) if ok else float("inf")
        later = [ts for ts, _ in s.fed if ts > first]
        after += len(later)
        missing += sum(ts not in ok for ts in later)
        window_fed = (s.fed[fed0:] if k == 0 else s.fed)[:window]
        window -= len(window_fed)
        failed += sum(ts not in ok for ts, _ in window_fed)
        good = [r for r in s.results if r.ok]
        if k == 0 or len(good) >= MIN_SEGMENT_POSES:
            trajectories.append((s.rec, [r.ts for r in good], [r.p for r in good]))
        tracks.append((s.rec, s.states))
    return dict(unanswered=float(unanswered), missing_pct=100.0 * missing / max(after, 1),
                track_drift_p90_px=common.track_drift(cfg, tracks, notes),
                **common.trajectory_checks(trajectories)), failed
