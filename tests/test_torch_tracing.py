"""The port's span recorder (utils/logging.py) and the spans the program
opens at the boundaries of a frame's stages: nesting, parents, self time and
requests; nothing kept while off; the profiler's clock; a short CPU run of
``ChunkedImageServer`` traced and untraced (every span name, frames inside
chunks, identical poses); and, on the card, a span around one K1 launch
and the host syncs of one chunk with the recorder on and off.

No JAX here: the card's tests (``-m cuda``) run from this file too."""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import pytest
import torch

from mobile_slam_tpu_torch.config import EstimatorConfig, TrackerConfig, VIOConfig
from mobile_slam_tpu_torch.engine import example
from mobile_slam_tpu_torch.engine.serving import ChunkedImageServer
from mobile_slam_tpu_torch.engine.vio_engine import FrameResult, Status
from mobile_slam_tpu_torch.eval import simulation as sim
from mobile_slam_tpu_torch.models.cameras.base import make_camera
from mobile_slam_tpu_torch.utils import logging as slog

CHUNK = 4
# The spans of a chunked run's frames and chunks, and of the streamed frames
# before it (engine/serving.py, chunked.py, estimator.py, vio_engine.py,
# frontend/tracker.py); ``recover`` needs a failed tail (its own test).
CHUNK_SPANS = {"chunk", "chunk.upload", "chunk.step", "chunk.readback", "preprocess",
               "frame", "kf_flag", "gates", "track", "bookkeeping", "solve", "triangulate",
               "optimize", "marginalize", "slide"}
STREAM_SPANS = {"stream_frame", "tracker_dispatch", "solve_dispatch", "result_wait"}
SOLVE_CHILDREN = {"triangulate", "optimize", "marginalize", "slide"}


def _ns(ms: float) -> int:
    return int(ms * 1e6)


def _by_id(spans) -> dict:
    return {s.id: s for s in spans}


def test_spans_nest_with_parents_and_requests():
    rec = slog.Recorder()
    with rec.tracing():
        with rec.span("chunk", index=3) as chunk:
            with rec.span("frame", request=(chunk.id, 0), index=0) as frame:
                with rec.span("solve") as solve:
                    with rec.span("optimize") as opt:
                        pass
            with rec.span("chunk.readback") as rb:
                pass
    spans = rec.drain()
    assert [s.name for s in spans] == ["optimize", "solve", "frame", "chunk.readback", "chunk"]
    assert chunk.parent is None and frame.parent == chunk.id and rb.parent == chunk.id
    assert solve.parent == frame.id and opt.parent == solve.id
    assert opt.request == solve.request == frame.request == (chunk.id, 0)
    assert chunk.request is None and rb.request is None and chunk.attrs == {"index": 3}
    assert len({s.id for s in spans}) == 5
    for child, parent in ((opt, solve), (solve, frame), (frame, chunk), (rb, chunk)):
        assert parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_self_time_is_what_the_children_leave():
    def span(i, name, parent, a, b):
        s = slog.Span(None, name, None, {})
        s.id, s.parent, s.start_ns, s.end_ns = i, parent, _ns(a), _ns(b)
        return s

    spans = [span(1, "solve", None, 0, 10), span(2, "triangulate", 1, 1, 3),
             span(3, "optimize", 1, 3, 8), span(4, "inner", 3, 4, 5)]
    self_ms = {i: ns / 1e6 for i, ns in slog.self_ns(spans).items()}
    assert self_ms == pytest.approx({1: 3.0, 2: 2.0, 3: 4.0, 4: 1.0})


def test_nothing_is_kept_while_off_and_drain_empties():
    rec = slog.Recorder()
    with rec.span("track") as off:
        pass
    assert off.id is None and off.parent is None and rec.drain() == []
    assert off.end_ns >= off.start_ns and off.seconds >= 0     # the two clock reads
    with rec.tracing() as on:
        assert on is rec and rec.on
        with rec.span("track"):
            pass
    assert not rec.on
    assert [s.name for s in rec.drain()] == ["track"] and rec.drain() == []


def test_recording_nests_is_bounded_and_keeps_threads_apart():
    rec = slog.Recorder(limit=3)
    with rec.tracing():
        with rec.tracing():
            pass
        assert rec.on                     # the inner block leaves the outer one on
        with rec.span("outer") as outer:
            seen = []
            worker = threading.Thread(target=lambda: seen.append(rec.span("other").__enter__()))
            worker.start()
            worker.join(timeout=10)
            assert not worker.is_alive()
            for _ in range(3):
                with rec.span("inner"):
                    pass
    assert seen[0].parent is None         # another thread: not under ``outer``
    assert outer.id is not None and rec.dropped == 1          # ``outer`` closed past the limit
    assert [s.name for s in rec.drain()] == ["inner"] * 3


def test_span_clock_is_the_profilers():
    """A ``record_function`` inside a span, under a CPU ``torch.profiler``,
    lies inside the span's interval (within 1 ms)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    rec = slog.Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof, rec.tracing():
        with rec.span("outer") as outer:
            with record_function("inside_the_span"):
                torch.ones(32, 32) @ torch.ones(32, 32)
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "inside_the_span"]
    assert len(events) == 1
    e = events[0]
    slack = _ns(1.0)
    assert outer.start_ns - slack <= e.start_ns() <= e.start_ns() + e.duration_ns() \
        <= outer.end_ns + slack


def small_cfg() -> VIOConfig:
    return VIOConfig(
        camera=example.bench_config().camera,
        tracker=TrackerConfig(max_cnt=60, max_points=64, fisheye=True),
        estimator=EstimatorConfig(max_features=128, max_imu_per_interval=16,
                                  num_iterations=2, acc_n=0.04, gyr_n=0.004,
                                  acc_w=4e-4, gyr_w=2e-5, td_init=0.0))


def _sequence(seconds: float = 1.0):
    """The bench sequence's first ``seconds``: (data, rendered frames)."""
    cfg = small_cfg()
    cam = make_camera(cfg.camera, dtype=torch.float64, device="cpu")
    data = sim.simulate(example.bench_sim_config(seconds), cam, cfg.camera.r_ic_mat,
                        cfg.camera.t_ic_vec)
    return data, [sim.render_frame(data, fi, cam, example.R_IC, cfg.camera.t_ic_vec)
                  for fi in range(len(data.frames))]


def _serve(server, data, frames, stop=None) -> list:
    """Feed the frames and their IMU to ``server`` until ``stop()``; flush."""
    results, imu_i = [], 0
    for fi, img in enumerate(frames):
        ts = data.cam_ts[fi]
        while imu_i < len(data.imu_ts) and data.imu_ts[imu_i] <= ts + 1e-9:
            server.push_imu(data.imu_ts[imu_i], data.imu_acc[imu_i], data.imu_gyr[imu_i])
            imu_i += 1
        results += server.process_frame(img, ts)
        if stop is not None and stop():
            return results
    return results + server.flush()


@pytest.fixture(scope="module")
def served():
    """The same short sequence through a CPU server (chunks of CHUNK),
    traced and untraced: {traced: (results, spans, server)}."""
    data, frames = _sequence()
    out = {}
    for traced in (True, False):
        server = ChunkedImageServer(small_cfg(), device="cpu", chunk_size=CHUNK,
                                    stable_frames=2)
        slog.drain()
        with slog.tracing() if traced else contextlib.nullcontext():
            results = _serve(server, data, frames)
        out[traced] = (results, slog.drain(), server)
    return out


def test_a_traced_run_opens_every_stage_span(served):
    results, spans, server = served[True]
    assert server.n_chunks >= 2 and server.frames_streamed >= 10
    assert {s.name for s in spans} == CHUNK_SPANS | STREAM_SPANS
    assert served[False][1] == []                     # untraced: nothing kept
    assert sum(s.name == "chunk" for s in spans) == server.n_chunks


def test_frames_nest_in_chunks_and_optimize_in_solve(served):
    spans = served[True][1]
    by_id = _by_id(spans)
    chunks = {s.id: s for s in spans if s.name == "chunk"}

    def ancestors(s):
        while s.parent is not None:
            s = by_id[s.parent]
            yield s

    for s in spans:
        names = [a.name for a in ancestors(s)]
        if s.name == "frame":
            chunk_id = next(a.id for a in ancestors(s) if a.name == "chunk")
            assert by_id[s.parent].name == "chunk.step"
            assert s.request == (chunk_id, s.attrs["index"])
        if s.name in SOLVE_CHILDREN:
            assert by_id[s.parent].name == "solve"
        if s.name in ("track", "bookkeeping", "solve"):
            # inside a chunk's frame, or a streamed frame's dispatch
            assert "frame" in names or "stream_frame" in names
        if s.name == "stream_frame":
            assert s.parent is None and isinstance(s.request, float)
        if s.name in ("chunk.upload", "chunk.step", "chunk.readback"):
            assert s.parent in chunks
    for s in spans:
        for a in ancestors(s):
            assert a.start_ns <= s.start_ns <= s.end_ns <= a.end_ns


def test_each_chunk_has_a_frame_span_per_frame(served):
    spans, server = served[True][1], served[True][2]
    by_id = _by_id(spans)
    frames: dict = {}
    for s in spans:
        if s.name == "frame":
            frames.setdefault(by_id[s.parent].parent, []).append(s.attrs["index"])
    chunks = [s for s in spans if s.name == "chunk"]
    assert sorted(frames) == sorted(c.id for c in chunks)
    for c in chunks:
        # a padded last chunk runs its padding too: CHUNK frames, `frames` real
        assert frames[c.id] == list(range(CHUNK)) and 1 <= c.attrs["frames"] <= CHUNK
    assert sum(c.attrs["frames"] for c in chunks) == server.frames_chunked
    assert sum(s.name == "solve" for s in spans) >= CHUNK * len(chunks)


def test_poses_are_bit_identical_traced_and_untraced(served):
    on, off = served[True][0], served[False][0]
    assert len(on) == len(off) and sum(r.ok for r in on) >= 5
    for a, b in zip(on, off):
        assert (a.ts, a.ok, a.is_keyframe, a.chunked) == (b.ts, b.ok, b.is_keyframe, b.chunked)
        assert np.array_equal(a.p, b.p) and np.array_equal(a.q, b.q)


def test_stage_ms_is_the_spans_moving_average(served):
    """``VIOEngine.get_timing`` (the CLI's live.json) reads the EMAs of the
    stream spans' durations."""
    spans, server = served[True][1], served[True][2]
    timing = server.engine.get_timing()
    assert set(timing) == {"tracker_dispatch", "solve_dispatch", "result_wait"}
    for name, ms in timing.items():
        ema = None
        for s in spans:
            if s.name == name:
                dt = s.seconds * 1e3
                ema = dt if ema is None else ema + 0.05 * (dt - ema)
        assert ms == round(ema, 3), name


class _Tracking:
    """Stands in for the engine in a replay: TRACKING from its second frame."""

    def __init__(self, real):
        self.real, self.calls = real, 0

    def process_frame(self, image, ts, imu_override=None):
        self.calls += 1
        status = Status.TRACKING if self.calls >= 2 else Status.INITIALIZING
        return FrameResult(status == Status.TRACKING, None, status, 0, False)

    def get_body_state(self):
        return np.zeros(3), np.array([1.0, 0, 0, 0]), np.zeros(3)

    def __getattr__(self, name):
        return getattr(self.real, name)


def test_a_failed_tail_is_recovered_inside_a_recover_span():
    server = ChunkedImageServer(small_cfg(), device="cpu", chunk_size=CHUNK,
                                recover_tail=2, stable_frames=2)
    eng = server.engine
    server._enter_chunked()
    ok = torch.tensor([True, True, False, False])

    def gated_step(carry, inputs, ransac_draws=None):
        n = inputs.img.shape[0]
        q = torch.zeros(n, 4).index_fill(1, torch.tensor([0]), 1.0)
        return carry, (torch.zeros(n, 3), q, ok, torch.zeros(n, dtype=torch.bool))

    server._step = gated_step
    eng._t0 = 0.0
    slog.drain()
    with slog.tracing():
        for k in range(CHUNK):
            eng.push_imu(0.05 * k + 0.01, np.zeros(3), np.zeros(3))
            server.engine = _Tracking(eng) if k == CHUNK - 1 else eng
            server.process_frame(np.zeros((512, 512)), 0.05 * (k + 1))
    spans = slog.drain()
    assert server.n_recoveries == 1
    recover = [s for s in spans if s.name == "recover"]
    chunk = [s for s in spans if s.name == "chunk"]
    assert len(recover) == 1 and recover[0].attrs == {"frames": 2} and recover[0].parent is None
    assert len(chunk) == 1 and chunk[0].end_ns <= recover[0].start_ns


@pytest.mark.cuda
def test_spans_on_the_card_enclose_their_launch_and_add_no_sync():
    """A span around one K1 launch encloses the launch's host call
    (``cudaLaunchKernel``) in the profiler's trace, and one chunk's host
    syncs (``probes/sync_sites.SyncSites``) count the same with the
    recorder on and off."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from mobile_slam_tpu_torch.ops import image as im
    from mobile_slam_tpu_torch.ops import lk
    from mobile_slam_tpu_torch.probes.sync_sites import SyncSites

    gen = torch.Generator(device="cuda").manual_seed(0)
    img = torch.rand((128, 160), generator=gen, device="cuda") * 255
    pyr0, pyr1 = im.build_pyramid(img, 2), im.build_pyramid(torch.roll(img, (1, 2), (0, 1)), 2)
    pts = torch.rand((40, 2), generator=gen, device="cuda") * 100 + 14
    act = torch.ones(40, dtype=torch.bool, device="cuda")
    prm = lk.LKParams(window=21, levels=2)
    lk.track_pyramidal(pyr0, pyr1, pts, act, prm)         # build and configure first
    torch.cuda.synchronize()
    slog.drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, slog.tracing():
        with slog.span("one_k1") as one:
            lk.track_pyramidal(pyr0, pyr1, pts, act, prm)
        torch.cuda.synchronize()
    slog.drain()
    events = list(prof.profiler.kineto_results.events())
    kernel = [e for e in events if "lk_track_kernel" in e.name()
              and e.device_type() == torch.autograd.DeviceType.CUDA]
    assert len(kernel) == 1
    launch = [e for e in events if e.correlation_id() == kernel[0].correlation_id()
              and "LaunchKernel" in e.name()]
    assert len(launch) == 1, [e.name() for e in events]
    assert one.start_ns <= launch[0].start_ns() <= launch[0].end_ns() <= one.end_ns

    # One chunk's syncs, from the same carry, traced and untraced.
    server = ChunkedImageServer(small_cfg(), device="cuda", chunk_size=CHUNK, stable_frames=2)
    seen = []
    step = server._step

    def keep(carry, inputs, ransac_draws=None):
        seen.append((carry, inputs))
        return step(carry, inputs, ransac_draws)

    server._step = keep
    _serve(server, *_sequence(), stop=lambda: bool(seen))
    assert seen, "the server never ran a chunk"
    carry, inputs = seen[0]
    state = carry.gen.get_state()
    sites, outs = [], []
    # The first pass warms what these draws reach first (cached device
    # constants copy once); the traced and untraced passes that follow compare.
    for traced in (False, True, False):
        gen_c = torch.Generator(device="cuda")
        gen_c.set_state(state)
        torch.cuda.synchronize()
        with slog.tracing() if traced else contextlib.nullcontext(), SyncSites() as counted:
            _, out = step(carry._replace(gen=gen_c), inputs)
            out[0].cpu()
        sites.append(counted.sites)
        outs.append(out)
    assert slog.drain()
    assert sites[1] == sites[2] and sum(sites[1].values()) > 0, (sites[1] - sites[2],
                                                                  sites[2] - sites[1])
    assert all(torch.equal(a, b) for a, b in zip(outs[1], outs[2]))
