"""The port's pipelined streaming, packed transfers, ``measure_device_step``
and map points against the JAX package, on the CPU.

1. The port's pipelined feature path at depth 1 and 4, restored from one
   snapshot, matches its synchronous run pose by pose (keyed by
   ``FrameResult.ts``) within 1e-4 m, the bar of
   tests/test_cross_path_parity.py; ``flush_all`` drains every frame.
2. Both engines, float64, from a cold start over the port's simulation of a
   short bench stretch, pipelined (depth 1) from the frame that reaches
   TRACKING: the same poses keyed by ``res.ts`` within 1e-5 (the bar of
   tests/test_torch_feature_path.py), the same tags, flags and
   ``is_initialized()`` on every call, the same pose from ``flush``, and the
   packed TRACKING input (``_last_flat``) equal element-wise.
3. ``measure_device_step`` is None before TRACKING and positive after, and
   leaves the engine's state as it was.
4. ``get_map_points``' device function equals the reference's
   ``_map_points_device`` on a converted example state (float64, 1e-9).
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from tests._torch_parity import F64, example_state, reference_compile_cache, tonp  # noqa: F401

from mobile_slam_tpu.config import (CameraConfig, EstimatorConfig, TrackerConfig,
                                    VIOConfig)
from mobile_slam_tpu.engine import estimator as jest
from mobile_slam_tpu.engine import vio_engine as jvio
from mobile_slam_tpu.engine.example import tiny_config
from mobile_slam_tpu_torch import convert
from mobile_slam_tpu_torch.engine import checkpoint as ckpt
from mobile_slam_tpu_torch.engine import example as texample
from mobile_slam_tpu_torch.engine import vio_engine as tvio
from mobile_slam_tpu_torch.engine.vio_engine import Status, VIOEngine
from mobile_slam_tpu_torch.eval import simulation as sim
from mobile_slam_tpu_torch.models.cameras.base import make_camera

SYNC_TOL = 1e-4     # m, pipelined against synchronous (same engine)
POSE_TOL = 1e-5     # port against the reference
PIPELINED = 8       # pipelined calls after the frame that reaches TRACKING


def feature_cfg() -> VIOConfig:
    return VIOConfig(
        camera=CameraConfig(**dataclasses.asdict(texample.bench_config().camera)),
        tracker=TrackerConfig(max_cnt=60, max_points=64, fisheye=True),
        estimator=EstimatorConfig(max_features=96, max_imu_per_interval=16,
                                  num_iterations=2, acc_n=0.04, gyr_n=0.004,
                                  acc_w=4e-4, gyr_w=2e-5))


@pytest.fixture(scope="module")
def world():
    cfg = feature_cfg()
    cam = make_camera(cfg.camera, dtype=F64, device="cpu")
    scfg = dataclasses.replace(texample.bench_sim_config(1.7), max_features=60,
                               num_landmarks=500)
    return cfg, sim.simulate(scfg, cam, cfg.camera.r_ic_mat, cfg.camera.t_ic_vec)


def _push(engines, data, imu_i, ts):
    while imu_i < len(data.imu_ts) and data.imu_ts[imu_i] <= ts + 1e-9:
        for eng in engines:
            eng.push_imu(data.imu_ts[imu_i], data.imu_acc[imu_i], data.imu_gyr[imu_i])
        imu_i += 1
    return imu_i


def _features(eng, data, fi):
    f = data.frames[fi]
    return eng.process_features(data.cam_ts[fi], f["ids"], f["rays"], uv=f["uv"], vel=f["vel"])


def test_pipelined_matches_sync_with_one_frame_lag(world, tmp_path):
    cfg, data = world
    eng, imu_i, fi0 = VIOEngine(cfg, device="cpu"), 0, None
    for fi, ts in enumerate(data.cam_ts):
        imu_i = _push([eng], data, imu_i, ts)
        if _features(eng, data, fi).status == Status.TRACKING:
            fi0 = fi + 1
            break
    assert fi0 is not None, "never reached TRACKING"
    snap = str(tmp_path / "at_init.npz")
    ckpt.save_engine(snap, eng)

    def run(depth):
        e = VIOEngine(cfg, device="cpu")
        ckpt.load_engine(snap, e)
        if depth:
            e.enable_pipelined_streaming(True, depth=depth)
        out, j, lagged = {}, imu_i, 0
        for fi in range(fi0, len(data.cam_ts)):
            j = _push([e], data, j, data.cam_ts[fi])
            res = _features(e, data, fi)
            lagged += res.ts is None and res.status == Status.TRACKING and depth > 0
            if res.ok:
                out[round(res.ts if res.ts is not None else data.cam_ts[fi], 6)] = res.pose
        tail = e.flush_all()
        assert len(tail) == depth and e._pending == []
        for res in tail:
            assert res.ok
            out[round(res.ts, 6)] = res.pose
        assert lagged == depth      # the first `depth` calls return no new pose
        return out

    sync = run(0)
    assert len(sync) >= 10
    for depth in (1, 4):
        pipe = run(depth)
        assert sorted(pipe) == sorted(sync), depth
        dp = max(np.linalg.norm(sync[t][:3, 3] - pipe[t][:3, 3]) for t in sync)
        assert dp < SYNC_TOL, f"pipelined depth={depth} diverged: max {dp:.2e} m"


@pytest.fixture(scope="module")
def both_pipelined(world):
    """Both engines (float64), pipelined from the frame that reaches
    TRACKING: per call (reference result, port result, reference flat,
    port flat, port measure_device_step before the call's frame, both
    engines' is_initialized())."""
    cfg, data = world
    jeng = jvio.VIOEngine(cfg, jnp.float64)
    teng = VIOEngine(cfg, device="cpu", dtype=F64)
    rows, imu_i, init = [], 0, None
    for fi, ts in enumerate(data.cam_ts):
        imu_i = _push([jeng, teng], data, imu_i, ts)
        step_ms = teng.measure_device_step(1) if fi % 4 == 0 else None
        res = [_features(eng, data, fi) for eng in (jeng, teng)]
        flats = [None if e._last_flat is None else np.asarray(e._last_flat) for e in (jeng, teng)]
        rows.append((*res, *flats, step_ms, (jeng.is_initialized(), teng.is_initialized())))
        if init is None and res[0].status == jvio.Status.TRACKING:
            init = fi
            for eng in (jeng, teng):
                eng.enable_pipelined_streaming(True, depth=1)
        if init is not None and fi >= init + PIPELINED:
            break
    tails = ([jeng.flush()], [teng.flush()])
    assert jeng.flush() is None and teng.flush() is None
    return init, rows, tails, teng


def test_pipelined_matches_reference(both_pipelined):
    init, rows, (jtail, ttail), _ = both_pipelined
    assert init is not None, "the reference engine never initialized"
    poses_j, poses_t = {}, {}
    for fi, (rj, rt, *_rest, (init_j, init_t)) in enumerate(rows):
        assert (rt.status.value, rt.ok, rt.is_keyframe, rt.num_features) == (
            rj.status.value, rj.ok, rj.is_keyframe, rj.num_features), fi
        assert init_t == init_j == (rj.status == jvio.Status.TRACKING), fi
        assert (rt.ts is None) == (rj.ts is None) and (rt.ts is None or rt.ts == rj.ts), fi
        for poses, r in ((poses_j, rj), (poses_t, rt)):
            if r.ok:
                poses[r.ts if r.ts is not None else fi] = r.pose
    assert len(jtail) == len(ttail) == 1
    for poses, r in ((poses_j, jtail[0]), (poses_t, ttail[0])):
        poses[r.ts] = r.pose
    assert sorted(poses_t) == sorted(poses_j)
    assert len([k for k in poses_t if isinstance(k, float)]) == PIPELINED
    for k in poses_j:
        np.testing.assert_allclose(poses_t[k], poses_j[k], atol=POSE_TOL, rtol=0,
                                   err_msg=str(k))


def test_packed_input_matches_reference(both_pipelined):
    init, rows, _, teng = both_pipelined
    packed = 0
    for fi, (_, _, fj, ft, *_) in enumerate(rows):
        assert (fj is None) == (ft is None), fi
        if fj is not None:
            assert ft.shape == fj.shape and ft.dtype == np.float64
            np.testing.assert_array_equal(ft, fj, err_msg=f"frame {fi}")
            packed += 1
    assert packed == PIPELINED     # every frame after the initializing one
    cfg = teng.cfg
    assert ft.size == (2 + 7 * cfg.estimator.max_imu_per_interval
                       + 9 * cfg.tracker.max_points)


def test_measure_device_step(both_pipelined):
    init, rows, _, teng = both_pipelined
    before = [r[4] for fi, r in enumerate(rows) if fi <= init and fi % 4 == 0]
    after = [r[4] for fi, r in enumerate(rows) if fi > init + 1 and fi % 4 == 0]
    assert before and all(ms is None for ms in before)
    assert after and all(ms is not None and ms > 0 for ms in after)
    state = teng.state
    assert teng.measure_device_step(1) > 0
    assert teng.state is state


def test_map_points_match_reference():
    cfg = tiny_config()
    jp = jest.make_params(cfg, jnp.float64)
    jstate, _ = example_state(cfg, jp, jnp.float64)
    # Solve every landmark at a depth off the initial one, some behind.
    rng = np.random.default_rng(4)
    n = jstate.table.depth.shape[0]
    jstate = jstate._replace(table=jstate.table._replace(
        solve_flag=jnp.asarray(rng.integers(0, 2, n), jnp.int32),
        depth=jnp.asarray(rng.uniform(-1.0, 8.0, n))))
    pts_j, good_j = jvio._map_points_device(jstate.table, jstate.window, jp.ex_t, jp.ex_q,
                                            jp.init_depth)
    st = convert.estimator_state(tonp(jstate), dtype=F64, device="cpu")
    params = convert.static_params(tonp(jp), dtype=F64, device="cpu")
    pts_t, good_t = tvio._map_points_device(st.table, st.window, params.ex_t, params.ex_q,
                                            params.init_depth)
    good = np.asarray(good_j)
    assert good.sum() > 0
    np.testing.assert_array_equal(good_t.numpy(), good)
    np.testing.assert_allclose(pts_t.numpy()[good], np.asarray(pts_j)[good], atol=1e-9, rtol=0)
