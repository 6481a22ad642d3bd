"""The port's chunked frame processing (engine/chunked.py) against the JAX
package, on the CPU at tiny sizes.

1. ``scale_gate`` and ``growth_gate`` against the reference's on seeded
   random inputs, float64: bit-equal (the same elementwise arithmetic).
2. One ``make_image_frame_step`` frame against the reference's (jitted,
   Pallas kernels in interpret mode) from the same converted carry, with
   the reference's RANSAC draws injected: pose within 1e-5 (the bar of
   tests/test_torch_slice.py), identical ok / keyframe flags.
3. A T = 3 frame port chunk against 3 calls of the port's own frame step:
   bit-equal (the same torch ops in the same order).
4. The feature-path ``make_chunked_step`` against the port's streaming
   ``process_features`` from one warm start, with the tolerances of
   tests/test_cross_path_parity.py: the two paths build their IMU
   intervals differently (simulator slices vs the engine's interpolated
   drain), so they agree to centimetres, not bits. The feature path against
   the JAX package (``make_chunked_step`` at 1e-5, ``process_features``)
   is tests/test_torch_feature_path.py.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import (  # noqa: F401
    F64, example_state, ransac_draws, reference_compile_cache, t64, tonp)
from tests.test_torch_tracker import tracker_sequence

from mobile_slam_tpu.engine import chunked as jchunked
from mobile_slam_tpu.engine import estimator as jest
from mobile_slam_tpu.engine.example import tiny_config
from mobile_slam_tpu.frontend import tracker as jtrk
from mobile_slam_tpu.models.cameras.base import make_camera as jax_camera
from mobile_slam_tpu.ops import lk_pallas
from mobile_slam_tpu_torch import convert
from mobile_slam_tpu_torch.config import (EstimatorConfig, TrackerConfig,
                                          VIOConfig)
from mobile_slam_tpu_torch.engine import chunked
from mobile_slam_tpu_torch.engine.estimator import FrameInput
from mobile_slam_tpu_torch.engine import example as texample
from mobile_slam_tpu_torch.engine.vio_engine import Status, VIOEngine
from mobile_slam_tpu_torch.eval import simulation as sim
from mobile_slam_tpu_torch.frontend import tracker as trk
from mobile_slam_tpu_torch.models.cameras.base import make_camera

POSE_TOL = 1e-5
L = chunked.GROWTH_WINDOW


@pytest.fixture(autouse=True)
def interpret_mode():
    lk_pallas._INTERPRET = True
    yield
    lk_pallas._INTERPRET = False


@pytest.mark.parametrize("seed", [0, 1])
def test_scale_gate_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 256
    depth_ema = np.where(rng.random(n) < 0.3, 0.0, rng.uniform(0.5, 5.0, n))
    vel_ema = rng.uniform(0.0, 2.0, n)
    med_depth = np.where(rng.random(n) < 0.2, 0.0, depth_ema * rng.uniform(0.5, 4.0, n))
    vel = vel_ema * rng.uniform(0.0, 3.0, n)
    ref = jchunked.scale_gate(*map(jnp.asarray, (depth_ema, vel_ema, med_depth, vel)))
    out = chunked.scale_gate(*map(t64, (depth_ema, vel_ema, med_depth, vel)))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < int(out[2].sum()) < n          # both branches are exercised


@pytest.mark.parametrize("seed", [0, 1])
def test_growth_gate_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ring_d = rng.uniform(0.0, 4.0, L)
    ring_d[rng.random(L) < 0.2] = 0.0
    ring_v = rng.uniform(0.0, 1.5, L)
    jd, jv, ji = jnp.asarray(ring_d), jnp.asarray(ring_v), jnp.asarray(7, jnp.int32)
    td, tv, ti = t64(ring_d), t64(ring_v), torch.tensor(7, dtype=torch.int32)
    trips = 0
    for _ in range(2 * L):
        d = 0.0 if rng.random() < 0.1 else float(rng.uniform(0.0, 8.0))
        v = float(rng.uniform(0.0, 3.0))
        jd, jv, ji, jg = jchunked.growth_gate(jd, jv, ji, jnp.asarray(d), jnp.asarray(v))
        td, tv, ti, tg = chunked.growth_gate(td, tv, ti, t64(d), t64(v))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert int(ti) == int(ji) and bool(tg) == bool(jg)
        trips += bool(tg)
    assert trips > 0


@pytest.fixture(scope="module")
def frame_world():
    """A warm state in both structures: the port's tracker after three
    frames of a translating texture (converted to the reference's pytree)
    and the reference's example estimator state, float64."""
    cfg = tiny_config()
    tcfg = dataclasses.replace(cfg.tracker, use_pallas=True)
    cam = make_camera(cfg.camera, dtype=F64, device="cpu")
    tst = trk.init_tracker_state(cfg.tracker, cfg.camera.height, cfg.camera.width,
                                 dtype=F64, device="cpu")
    frames = tracker_sequence(7)
    for k, img in enumerate(frames[:3]):
        tst, _ = trk.detect_and_track(tst, t64(img), 0.05 * k, cam, cfg.tracker,
                                      cfg.camera.focal_length,
                                      generator=torch.Generator().manual_seed(k))
    tst_np = convert.to_numpy(tst)
    jtst = jtrk.TrackerState(tuple(map(jnp.asarray, tst_np.pyr)),
                             *map(jnp.asarray, tst_np[1:]))
    jp = jest.make_params(cfg, jnp.float64)
    est_j, inp_j = example_state(cfg, jp, jnp.float64)
    return cfg, tcfg, jax_camera(cfg.camera, dtype=jnp.float64), jp, est_j, inp_j, jtst, frames


def _carries(world):
    cfg, _, _, jp, est_j, _, tst, _ = world
    F = cfg.estimator.max_features
    jcarry = jchunked.ImageChunkCarry(
        est_state=est_j, tracker_state=tst, banned_ids=jnp.full((F,), -1, jnp.int32),
        key=jax.random.PRNGKey(3), depth_ema=jnp.asarray(0.0), vel_ema=jnp.asarray(0.05),
        lag_depth=jnp.zeros(L), lag_vel=jnp.zeros(L), lag_i=jnp.asarray(0, jnp.int32))
    tcarry = chunked.ImageChunkCarry(
        est_state=convert.estimator_state(tonp(est_j), dtype=F64, device="cpu"),
        tracker_state=convert.tracker_state(tonp(tst), dtype=F64, device="cpu"),
        banned_ids=torch.full((F,), -1, dtype=torch.int32), gen=torch.Generator(),
        depth_ema=t64(0.0), vel_ema=t64(0.05), lag_depth=torch.zeros(L, dtype=F64),
        lag_vel=torch.zeros(L, dtype=F64), lag_i=torch.tensor(0, dtype=torch.int32))
    params = convert.static_params(tonp(jp), dtype=F64, device="cpu")
    return jcarry, tcarry, params


def _inputs(world, k):
    """Frame k of the sequence with the example IMU interval."""
    _, _, _, _, _, inp_j, _, frames = world
    return chunked.ImageFrameInput(
        img=t64(frames[k]), ts=t64(0.05 * k), imu_dt=t64(inp_j.imu_dt),
        imu_acc=t64(inp_j.imu_acc), imu_gyr=t64(inp_j.imu_gyr),
        imu_cnt=torch.tensor(int(inp_j.imu_cnt), dtype=torch.int32))


def test_image_frame_step_matches_reference(frame_world):
    cfg, tcfg, jcam, jp, _, _, _, _ = frame_world
    jcarry, tcarry, params = _carries(frame_world)
    n_it = cfg.estimator.num_iterations
    jstep = jax.jit(jchunked.make_image_frame_step(jp, n_it, tcfg, jcam,
                                                   cfg.camera.focal_length))
    inp = _inputs(frame_world, 3)
    jinp = jchunked.ImageFrameInput(*[jnp.asarray(x.numpy()) for x in inp])
    jpre = jtrk.preprocess_frame(jinp.img, tcfg)
    jcarry1, (p_j, q_j, ok_j, kf_j) = jstep(jcarry, (jinp, jpre))

    # The reference splits the carry's key and draws from the second half.
    draws = torch.as_tensor(ransac_draws(jax.random.split(jcarry.key)[1],
                                         cfg.tracker.ransac_iters))
    step = chunked.make_image_frame_step(params, n_it, cfg.tracker,
                                         make_camera(cfg.camera, dtype=F64, device="cpu"),
                                         cfg.camera.focal_length)
    tcarry1, (p_t, q_t, ok_t, kf_t) = step(tcarry, inp, None, draws)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=POSE_TOL)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=POSE_TOL)
    assert bool(ok_t) == bool(ok_j) and bool(kf_t) == bool(kf_j)
    np.testing.assert_array_equal(tcarry1.tracker_state.ids.numpy(),
                                  np.asarray(jcarry1.tracker_state.ids))
    np.testing.assert_allclose(float(tcarry1.depth_ema), float(jcarry1.depth_ema),
                               rtol=1e-6)
    assert int(tcarry1.lag_i) == int(jcarry1.lag_i) == 1


def test_chunk_equals_frame_loop(frame_world):
    cfg = frame_world[0]
    _, carry, params = _carries(frame_world)
    cam = make_camera(cfg.camera, dtype=F64, device="cpu")
    args = (params, cfg.estimator.num_iterations, cfg.tracker, cam,
            cfg.camera.focal_length)
    frames = [_inputs(frame_world, k) for k in (3, 4, 5)]
    draws = torch.randint(0, 1 << 30, (3, cfg.tracker.ransac_iters, 8),
                          generator=torch.Generator().manual_seed(5))
    c_chunk, outs = chunked.make_chunked_image_step(*args)(
        carry, chunked.stack_image_inputs(frames, "cpu"), ransac_draws=draws)
    assert [o.shape for o in outs] == [(3, 3), (3, 4), (3,), (3,)]

    one = chunked.make_image_frame_step(*args)
    c_loop, rows = carry, []
    for t, inp in enumerate(frames):
        c_loop, out = one(c_loop, inp, None, draws[t])
        rows.append(out)
    for a, b in zip(outs, (torch.stack(x) for x in zip(*rows))):
        assert torch.equal(a, b)
    for a, b in zip(jax.tree.leaves(tuple(convert.to_numpy(c_chunk.est_state))),
                    jax.tree.leaves(tuple(convert.to_numpy(c_loop.est_state)))):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(c_chunk.tracker_state.pts, c_loop.tracker_state.pts)


def _feature_cfg():
    cam = texample.bench_config().camera
    return VIOConfig(
        camera=cam,
        tracker=TrackerConfig(max_cnt=60, max_points=64, fisheye=True),
        estimator=EstimatorConfig(max_features=96, max_imu_per_interval=16,
                                  num_iterations=2, acc_n=0.04, gyr_n=0.004,
                                  acc_w=4e-4, gyr_w=2e-5))


def test_chunked_step_matches_streaming():
    cfg = _feature_cfg()
    cam = make_camera(cfg.camera, dtype=F64, device="cpu")
    scfg = dataclasses.replace(texample.bench_sim_config(1.6), max_features=60,
                               num_landmarks=500)
    data = sim.simulate(scfg, cam, cfg.camera.r_ic_mat, cfg.camera.t_ic_vec)
    engine = VIOEngine(cfg, device="cpu", dtype=torch.float64)
    imu_i, fi0 = 0, None

    def feed(fi):
        nonlocal imu_i
        ts = data.cam_ts[fi]
        while imu_i < len(data.imu_ts) and data.imu_ts[imu_i] <= ts + 1e-9:
            engine.push_imu(data.imu_ts[imu_i], data.imu_acc[imu_i], data.imu_gyr[imu_i])
            imu_i += 1
        f = data.frames[fi]
        return engine.process_features(ts, f["ids"], f["rays"], uv=f["uv"], vel=f["vel"])

    init = None
    for fi in range(len(data.cam_ts)):
        res = feed(fi)
        if init is None and res.status == Status.TRACKING:
            init = fi
        if init is not None and fi >= init + 3:
            fi0 = fi + 1
            break
    assert fi0 is not None, "the engine never initialized"
    snapshot = copy.deepcopy(engine.state)
    t0 = engine._t0
    n = min(len(data.cam_ts), fi0 + 8)

    sa_p, sa_ok = [], []
    for fi in range(fi0, n):
        res = feed(fi)
        sa_p.append(engine.get_body_state()[0])
        sa_ok.append(res.ok)

    k_pad, m_pad = cfg.tracker.max_points, cfg.estimator.max_imu_per_interval

    def pad(a, n_p, sh):
        out = np.zeros((n_p,) + sh)
        out[:min(len(a), n_p)] = a[:n_p]
        return t64(out)

    inputs = []
    for fi in range(fi0, n):
        f = data.frames[fi]
        dt, acc, gyr = sim.imu_between(data, data.cam_ts[fi - 1], data.cam_ts[fi])
        ids = np.full(k_pad, -1, np.int32)
        ids[:len(f["ids"])] = f["ids"]
        inputs.append(FrameInput(
            ts=t64(data.cam_ts[fi] - t0), ids=torch.as_tensor(ids),
            obs=pad(f["rays"], k_pad, (3,)), uv=pad(f["uv"], k_pad, (2,)),
            vel=pad(f["vel"], k_pad, (2,)),
            valid=torch.as_tensor(np.arange(k_pad) < len(f["ids"])),
            imu_dt=pad(dt, m_pad, ()), imu_acc=pad(acc, m_pad, (3,)),
            imu_gyr=pad(gyr, m_pad, (3,)),
            imu_cnt=torch.tensor(min(len(dt), m_pad), dtype=torch.int32)))
    step = chunked.make_chunked_step(engine.params, cfg.estimator.num_iterations)
    _, (p_b, _, ok_b, kf_b) = step(snapshot, chunked.stack_frame_inputs(inputs))

    assert p_b.shape == (n - fi0, 3) and kf_b.dtype == torch.bool
    assert all(sa_ok) and bool(ok_b.all())
    dp = np.linalg.norm(np.asarray(sa_p) - p_b.numpy(), axis=-1)
    assert dp.max() < 0.02, dp
