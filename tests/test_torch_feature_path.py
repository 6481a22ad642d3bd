"""The port's feature path against the JAX package, float64 on the CPU.

1. ``VIOEngine.process_features``: both engines from a cold start over the
   port's simulation of a short bench stretch (KB fisheye 512x512, 64
   slots), through initialization into TRACKING and EXTRA tracking frames.
   Bars: the same status, ok, keyframe flag and feature count on every
   frame; the window-tip body state within 1e-5 (m, unit quaternion, m/s)
   on every TRACKING frame. Both engines pack their TRACKING-frame input
   into one float32 vector (mobile_slam_tpu/engine/vio_engine.py:504-523;
   tests/test_torch_pipelined.py holds the two vectors equal), so the
   inputs agree to the bit; the states agree to the bar, not to the bit
   (the two estimators sum in other orders).
2. The feature-path ``make_chunked_step`` from the reference engine's warm
   state (converted) over the next T frames, the same stacked inputs on
   both sides: poses within 1e-5 (the bar of tests/test_torch_slice.py),
   identical ok and keyframe flags.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import F64, reference_compile_cache, t64, tonp  # noqa: F401

from mobile_slam_tpu.config import (CameraConfig, EstimatorConfig, TrackerConfig,
                                    VIOConfig)
from mobile_slam_tpu.engine import chunked as jchunked
from mobile_slam_tpu.engine import estimator as jest
from mobile_slam_tpu.engine import vio_engine as jvio
from mobile_slam_tpu_torch import convert
from mobile_slam_tpu_torch.engine import chunked
from mobile_slam_tpu_torch.engine import example as texample
from mobile_slam_tpu_torch.engine.estimator import FrameInput
from mobile_slam_tpu_torch.engine.vio_engine import Status, VIOEngine
from mobile_slam_tpu_torch.eval import simulation as sim
from mobile_slam_tpu_torch.models.cameras.base import make_camera

POSE_TOL = 1e-5
EXTRA = 4       # tracking frames streamed after the one that initializes
T = 4           # frames of the chunk


def feature_cfg() -> VIOConfig:
    return VIOConfig(
        camera=CameraConfig(**dataclasses.asdict(texample.bench_config().camera)),
        tracker=TrackerConfig(max_cnt=60, max_points=64, fisheye=True),
        estimator=EstimatorConfig(max_features=96, max_imu_per_interval=16,
                                  num_iterations=2, acc_n=0.04, gyr_n=0.004,
                                  acc_w=4e-4, gyr_w=2e-5))


@pytest.fixture(scope="module")
def streams():
    """Both engines fed the same frames and IMU samples until TRACKING +
    EXTRA frames; per-frame results and body states."""
    cfg = feature_cfg()
    cam = make_camera(cfg.camera, dtype=F64, device="cpu")
    scfg = dataclasses.replace(texample.bench_sim_config(1.6), max_features=60,
                               num_landmarks=500)
    data = sim.simulate(scfg, cam, cfg.camera.r_ic_mat, cfg.camera.t_ic_vec)
    jeng = jvio.VIOEngine(cfg, jnp.float64)
    teng = VIOEngine(cfg, device="cpu", dtype=F64)
    rows, imu_i, init = [], 0, None
    for fi, ts in enumerate(data.cam_ts):
        while imu_i < len(data.imu_ts) and data.imu_ts[imu_i] <= ts + 1e-9:
            for eng in (jeng, teng):
                eng.push_imu(data.imu_ts[imu_i], data.imu_acc[imu_i], data.imu_gyr[imu_i])
            imu_i += 1
        f = data.frames[fi]
        res = [eng.process_features(ts, f["ids"], f["rays"], uv=f["uv"], vel=f["vel"])
               for eng in (jeng, teng)]
        rows.append((res, jeng.get_body_state(), teng.get_body_state()))
        if init is None and res[0].status == Status.TRACKING.value:
            init = fi
        if init is not None and fi >= init + EXTRA:
            break
    return cfg, data, jeng, init, rows


def test_process_features_matches_reference(streams):
    _, _, _, init, rows = streams
    assert init is not None, "the reference engine never initialized"
    tracking = 0
    for fi, ((rj, rt), sj, st) in enumerate(rows):
        assert (rt.status.value, rt.ok, rt.is_keyframe, rt.num_features) == (
            rj.status.value, rj.ok, rj.is_keyframe, rj.num_features), fi
        if rj.status.value == Status.TRACKING.value:
            tracking += 1
            for a, b in zip(st, sj):
                np.testing.assert_allclose(a, np.asarray(b), atol=POSE_TOL, rtol=0)
    assert tracking == EXTRA + 1


def _frame_input(cfg, data, fi, t0):
    f = data.frames[fi]
    dt, acc, gyr = sim.imu_between(data, data.cam_ts[fi - 1], data.cam_ts[fi])
    k_pad, m_pad = cfg.tracker.max_points, cfg.estimator.max_imu_per_interval
    n, m = len(f["ids"]), min(len(dt), m_pad)

    def pad(a, n_p, sh):
        out = np.zeros((n_p,) + sh)
        out[:min(len(a), n_p)] = a[:n_p]
        return out

    ids = np.full(k_pad, -1, np.int32)
    ids[:n] = f["ids"][:k_pad]
    return dict(ts=np.float64(data.cam_ts[fi] - t0), ids=ids,
                obs=pad(f["rays"], k_pad, (3,)), uv=pad(f["uv"], k_pad, (2,)),
                vel=pad(f["vel"], k_pad, (2,)), valid=np.arange(k_pad) < n,
                imu_dt=pad(dt, m_pad, ()), imu_acc=pad(acc, m_pad, (3,)),
                imu_gyr=pad(gyr, m_pad, (3,)), imu_cnt=np.int32(m))


def test_chunked_step_matches_reference(streams):
    cfg, data, jeng, _, rows = streams
    fi0 = len(rows)
    assert fi0 + T <= len(data.cam_ts)
    frames = [_frame_input(cfg, data, fi, jeng._t0) for fi in range(fi0, fi0 + T)]
    n_it = cfg.estimator.num_iterations

    jinp = jchunked.stack_frame_inputs([jest.FrameInput(**{
        k: jnp.asarray(v) for k, v in f.items()}) for f in frames])
    jstate = jax.tree.map(jnp.array, jeng.state)     # the step donates its carry
    _, (p_j, q_j, ok_j, kf_j) = jchunked.make_chunked_step(jeng.params, n_it)(jstate, jinp)

    tstate = convert.estimator_state(tonp(jeng.state), dtype=F64, device="cpu")
    params = convert.static_params(tonp(jeng.params), dtype=F64, device="cpu")
    tinp = chunked.stack_frame_inputs([FrameInput(**{
        k: torch.as_tensor(v) if np.asarray(v).dtype != np.float64 else t64(v)
        for k, v in f.items()}) for f in frames])
    _, (p_t, q_t, ok_t, kf_t) = chunked.make_chunked_step(params, n_it)(tstate, tinp)

    assert p_t.shape == (T, 3) and q_t.shape == (T, 4)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=POSE_TOL, rtol=0)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(kf_t.numpy(), np.asarray(kf_j))
    assert bool(ok_t.all())
