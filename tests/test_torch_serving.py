"""The port's chunked image server (engine/serving.py): the recovery
contract of tests/test_serving_recovery.py on the port, the growth gate's
two cases step by step against the reference's, the failed-tail replay
with the chunk step and the engine stubbed, and a short CPU run of the
whole serving path.

The port has no buffer donation, but the ordering of the recovery still
matters: the engine takes the carry's tracker, bans, RANSAC generator and
estimator state BEFORE the rebuild, so that the learned td survives.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import ransac_draws, reference_compile_cache  # noqa: F401
from tests.test_torch_tracker import tracker_sequence

from mobile_slam_tpu.engine import chunked as jchunked
from mobile_slam_tpu.engine import vio_engine as jvio
from mobile_slam_tpu.engine.example import tiny_config
from mobile_slam_tpu.ops import lk_pallas
from mobile_slam_tpu_torch.config import EstimatorConfig, TrackerConfig, VIOConfig
from mobile_slam_tpu_torch.engine import chunked, example
from mobile_slam_tpu_torch.engine import vio_engine as tvio
from mobile_slam_tpu_torch.engine.serving import ChunkedImageServer, ServeResult
from mobile_slam_tpu_torch.engine.vio_engine import FrameResult, Status, VIOEngine
from mobile_slam_tpu_torch.eval import simulation as sim
from mobile_slam_tpu_torch.eval.evaluator import compute_ate
from mobile_slam_tpu_torch.models.cameras.base import make_camera
from mobile_slam_tpu_torch.ops import lk
from mobile_slam_tpu_torch.utils import logging as slog

L = chunked.GROWTH_WINDOW


def small_cfg():
    return VIOConfig(
        camera=example.bench_config().camera,
        tracker=TrackerConfig(max_cnt=60, max_points=64, fisheye=True),
        estimator=EstimatorConfig(max_features=128, max_imu_per_interval=16,
                                  num_iterations=2, acc_n=0.04, gyr_n=0.004,
                                  acc_w=4e-4, gyr_w=2e-5, td_init=0.0))


def _carry(eng: VIOEngine, state=None) -> chunked.ImageChunkCarry:
    f32 = dict(dtype=torch.float32)
    return chunked.ImageChunkCarry(
        est_state=eng.state if state is None else state,
        tracker_state=eng.tracker_state, banned_ids=eng._banned_ids, gen=eng._gen,
        depth_ema=torch.tensor(1.0, **f32), vel_ema=torch.tensor(0.3, **f32),
        lag_depth=torch.zeros(L, **f32), lag_vel=torch.zeros(L, **f32),
        lag_i=torch.tensor(0, dtype=torch.int32))


def test_rebuild_discards_nan_td():
    """A NaN-diverged tail carries td = NaN; the rebuild falls back to
    td_init instead of seeding the fresh state with it."""
    eng = VIOEngine(small_cfg(), device="cpu")
    eng.state = eng.state._replace(td=torch.tensor(float("nan")))
    eng._rebuild_estimator()
    assert float(eng.state.td) == pytest.approx(float(eng.cfg.estimator.td_init), abs=1e-9)
    assert eng.status == Status.INITIALIZING


def test_recover_refreshes_state_from_carry():
    """_recover adopts the live carry (tracker, bans, generator, estimator
    state) and rebuilds from it: the learned td survives."""
    server = ChunkedImageServer(small_cfg(), device="cpu", chunk_size=4)
    eng = server.engine
    live = eng.state._replace(td=torch.tensor(0.0077))
    server._carry = _carry(eng, live)._replace(
        gen=torch.Generator().manual_seed(11),
        banned_ids=torch.arange(eng.cfg.estimator.max_features, dtype=torch.int32))
    carry = server._carry
    server._mode = "chunked"
    server._recover()

    assert server.mode == "stream" and server.n_recoveries == 1
    assert eng.status == Status.INITIALIZING
    assert int(eng.state.frame_count) == 0
    assert float(eng.state.td) == pytest.approx(0.0077, abs=1e-7)
    assert eng._gen is carry.gen and eng._banned_ids is carry.banned_ids
    assert eng.tracker_state is carry.tracker_state


def _run_gate(depths, vels, ring_d, ring_v):
    """Step the port's and the reference's growth gates side by side;
    returns the per-step trip flags (asserted identical)."""
    td, tv, ti = (torch.full((L,), ring_d, dtype=torch.float32),
                  torch.full((L,), ring_v, dtype=torch.float32),
                  torch.tensor(0, dtype=torch.int32))
    jd, jv, ji = (jnp.full((L,), ring_d, jnp.float32), jnp.full((L,), ring_v, jnp.float32),
                  jnp.asarray(0, jnp.int32))
    flags = []
    for d, v in zip(depths, vels):
        td, tv, ti, tg = chunked.growth_gate(td, tv, ti, torch.tensor(d, dtype=torch.float32),
                                             torch.tensor(v, dtype=torch.float32))
        jd, jv, ji, jg = jchunked.growth_gate(jd, jv, ji, jnp.asarray(d, jnp.float32),
                                              jnp.asarray(v, jnp.float32))
        assert bool(tg) == bool(jg)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        flags.append(bool(tg))
    return flags


def test_growth_gate_detects_compounding_runaway():
    """A compounding 2.3%/frame joint depth + velocity inflation trips
    within the ring window; a depth-only change and a steady state never
    do."""
    grow = 1.023 ** np.arange(1, 3 * L + 1)
    flags = _run_gate(3.0 * grow, 1.0 * grow, 3.0, 1.0)
    assert any(flags) and flags.index(True) < 2 * L
    assert not any(_run_gate(3.0 * 1.03 ** np.arange(1, 3 * L + 1),
                             np.ones(3 * L), 3.0, 1.0))
    assert not any(_run_gate(np.full(2 * L, 3.2), np.full(2 * L, 1.1), 3.0, 1.0))


def test_growth_gate_ignores_acceleration_from_hover():
    """Accelerating from near-hover (0.02 -> 1.0 m/s over one lag window)
    while depth grows 2%/frame, then cruising, must not trip."""
    depths, vels, depth, vel = [], [], 2.0, 0.02
    for k in range(3 * L):
        if k < L:
            depth *= 1.02
            vel = min(1.0, vel + (1.0 - 0.02) / L)
        depths.append(depth)
        vels.append(vel)
    assert not any(_run_gate(depths, vels, 2.0, 0.02))


class _StubEngine:
    """Records replayed frames; reports TRACKING once it has seen two."""

    def __init__(self, real: VIOEngine):
        self.real = real
        self.calls = []

    def process_frame(self, image, ts, imu_override=None):
        self.calls.append((ts, imu_override))
        status = Status.TRACKING if len(self.calls) >= 2 else Status.INITIALIZING
        return FrameResult(status == Status.TRACKING, None, status, 0, False)

    def get_body_state(self):
        return np.full(3, 7.0), np.array([1.0, 0, 0, 0]), np.zeros(3)

    def __getattr__(self, name):
        return getattr(self.real, name)


def test_failed_tail_replays_through_the_stream():
    """A chunk whose last recover_tail frames are all gated: the server
    recovers, replays exactly the failed frames through the streaming
    engine with their own IMU slices, reports the replayed results in
    their place and goes back to chunks once the engine tracks again."""
    server = ChunkedImageServer(small_cfg(), device="cpu", chunk_size=8,
                                recover_tail=3, stable_frames=2)
    eng = server.engine
    server._enter_chunked()
    ok = torch.tensor([True] * 4 + [False] * 4)

    def fake_step(carry, inputs, ransac_draws=None):
        n = inputs.img.shape[0]
        return carry, (torch.zeros(n, 3), torch.zeros(n, 4).index_fill(1, torch.tensor([0]), 1.0),
                       ok, torch.zeros(n, dtype=torch.bool))

    server._step = fake_step
    for k in range(8):
        ts = 0.05 * (k + 1)
        eng._t0 = 0.0
        for j in range(k + 1):   # k + 1 IMU samples in this frame's interval
            eng.push_imu(0.05 * k + 0.04 * (j + 1) / (k + 1), np.zeros(3), np.zeros(3))
        stub = _StubEngine(eng)
        server.engine = stub if k == 7 else eng
        out = server.process_frame(np.zeros((512, 512)), ts)
    assert server.n_recoveries == 1 and server.n_chunks == 1
    assert [c[0] for c in stub.calls] == pytest.approx([0.25, 0.3, 0.35, 0.4])
    assert [len(c[1][0]) for c in stub.calls] == [5, 6, 7, 8]
    assert [r.chunked for r in out] == [True] * 4 + [False] * 4
    assert [r.ok for r in out] == [True] * 4 + [False, True, True, True]
    assert all(isinstance(r, ServeResult) for r in out)
    assert server.mode == "chunked" and server._carry is not None


@pytest.fixture
def interpret_mode():
    lk_pallas._INTERPRET = True
    yield
    lk_pallas._INTERPRET = False


def test_imu_override_matches_reference(interpret_mode, monkeypatch):
    """``process_frame(imu_override=)``, the seam the server's replay uses,
    against the reference engine's: four frames of a translating texture
    at ``tiny_config()`` size, float64, each with its own IMU slice given
    as the override while the engines' own buffers hold other samples.
    The port's tracker is handed the reference engine's per-frame RANSAC
    draws. Bars: the same status, keyframe flag and feature count per
    frame, the same tracker ids, tracker points within 0.02 px (the bar of
    tests/test_torch_tracker.py), the window's IMU buffers and
    preintegration within 1e-9 (both sides take the override in float64),
    and neither engine drained its own buffer."""
    cfg = tiny_config()
    jcfg = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker,
                                                                use_pallas=True))
    jeng = jvio.VIOEngine(jcfg, jnp.float64)
    # Its tracker state typed as its tracker step returns it (float32 points,
    # zeros either way), so that the step compiles once.
    jeng.tracker_state = jeng.tracker_state._replace(
        pts=jeng.tracker_state.pts.astype(jnp.float32))
    teng = VIOEngine(cfg, device="cpu", dtype=torch.float64)
    draws, key = [], jax.random.PRNGKey(0)      # the reference engine's key
    detect = tvio.trk.detect_and_track

    def with_reference_draws(*args, generator=None, **kw):
        return detect(*args, ransac_draws=draws.pop(0), **kw)

    monkeypatch.setattr(tvio.trk, "detect_and_track", with_reference_draws)
    rng = np.random.default_rng(5)
    for k, img in enumerate(tracker_sequence(4)):
        ts = 0.05 * k
        for eng in (jeng, teng):    # samples the override must leave alone
            eng.push_imu(ts - 0.01, np.array([0.0, 0.0, 9.8]), np.zeros(3))
        n = 3 + k
        override = (np.full(n, 0.05 / n), rng.normal([0.1, -0.2, 9.8], 0.3, (n, 3)),
                    rng.normal(0.0, 0.05, (n, 3)))
        key, sub = jax.random.split(key)
        draws.append(torch.as_tensor(ransac_draws(sub, cfg.tracker.ransac_iters)))
        rj = jeng.process_frame(img, ts, imu_override=override)
        rt = teng.process_frame(img, ts, imu_override=override)
        assert (rt.status, rt.ok, rt.is_keyframe, rt.num_features) == (
            rj.status, rj.ok, rj.is_keyframe, rj.num_features), k
        np.testing.assert_array_equal(teng.tracker_state.ids.numpy(),
                                      np.asarray(jeng.tracker_state.ids))
        act = teng.tracker_state.active.numpy()
        np.testing.assert_allclose(teng.tracker_state.pts.numpy()[act],
                                   np.asarray(jeng.tracker_state.pts)[act], atol=0.02)
    assert rt.num_features > 0
    assert len(jeng._pending_imu) == len(teng._pending_imu) == 4
    assert int(teng.state.frame_count) == int(jeng.state.frame_count) == 4
    jw, tw = jeng.state.window, teng.state.window
    pairs = [(f"pre.{n}", getattr(tw.pre, n), getattr(jw.pre, n)) for n in jw.pre._fields]
    pairs += [(n, getattr(tw, n), getattr(jw, n))
              for n in ("imu_dt", "imu_acc", "imu_gyr", "imu_cnt", "imu_acc0", "imu_gyr0")]
    for name, a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9, err_msg=name)


def test_serving_path_on_cpu():
    """The whole path at a small size: stream until TRACKING + 3 frames,
    chunks of 4, a padded last chunk; every frame answered, finite poses,
    a ``chunk`` span for each chunk, no CUDA kernel launched."""
    cfg = small_cfg()
    cam = make_camera(cfg.camera, dtype=torch.float64, device="cpu")
    data = sim.simulate(example.bench_sim_config(1.3), cam, cfg.camera.r_ic_mat,
                        cfg.camera.t_ic_vec)
    server = ChunkedImageServer(cfg, device="cpu", chunk_size=4, stable_frames=4)
    before = dict(lk.launch_counts)
    results, imu_i = [], 0
    with slog.tracing():
        for fi in range(len(data.frames)):
            ts = data.cam_ts[fi]
            while imu_i < len(data.imu_ts) and data.imu_ts[imu_i] <= ts + 1e-9:
                server.push_imu(data.imu_ts[imu_i], data.imu_acc[imu_i], data.imu_gyr[imu_i])
                imu_i += 1
            results += server.process_frame(
                sim.render_frame(data, fi, cam, example.R_IC, cfg.camera.t_ic_vec), ts)
        results += server.flush()
    spans = slog.drain()
    assert server.n_chunks >= 2 and server.frames_chunked >= 8
    chunked_res = [r for r in results if r.chunked]
    assert len(chunked_res) == server.frames_chunked
    ok = [r for r in results if r.ok]
    assert len(ok) >= 10 and np.isfinite(np.asarray([r.p for r in ok])).all()
    ate = compute_ate(np.asarray([r.ts for r in ok]), np.asarray([r.p for r in ok]),
                      data.cam_ts, data.gt_p)
    assert ate.rmse < 0.05
    assert sum(s.name == "chunk" for s in spans) == server.n_chunks
    assert lk.launch_counts == before
