"""The port's slice as a whole.

1. One TRACKING frame through both implementations from the same converted
   state: image + IMU -> detect_and_track -> FrameInput (built from the
   TrackerOutput as the engine's image path builds it) -> bookkeeping_step
   -> solve_and_slide -> pose, in float64 with the reference's RANSAC draws
   injected. Bar: pose within 1e-5 m.
2. The port's VIOEngine on the CPU over the port's simulation of the bench
   sequence (shortened) until TRACKING + 5 frames: the status is reached,
   the poses are finite and no CUDA kernel was launched (CPU tensors take
   the plain versions).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import (  # noqa: F401
    F64, example_state, ransac_draws, reference_compile_cache, t64, tonp)
from tests.test_torch_tracker import jax_tracker, tracker_sequence

from mobile_slam_tpu.engine import estimator as jest
from mobile_slam_tpu.engine.example import tiny_config
from mobile_slam_tpu.ops import lk_pallas
from mobile_slam_tpu_torch import convert
from mobile_slam_tpu_torch.engine import estimator as est
from mobile_slam_tpu_torch.engine import example
from mobile_slam_tpu_torch.engine.vio_engine import Status, VIOEngine
from mobile_slam_tpu_torch.eval import simulation as sim
from mobile_slam_tpu_torch.frontend import tracker as trk
from mobile_slam_tpu_torch.models.cameras.base import make_camera
from mobile_slam_tpu_torch.ops import lk

POSE_TOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    lk_pallas._INTERPRET = True
    yield
    lk_pallas._INTERPRET = False


def test_one_tracking_frame_matches_reference():
    cfg = tiny_config()
    step_j, tst_j = jax_tracker(cfg)
    frames = tracker_sequence(4)
    for k, img in enumerate(frames[:3]):
        tst_j, _ = step_j(tst_j, jnp.asarray(img), jnp.asarray(0.05 * k),
                          key=jax.random.PRNGKey(k))
    jp = jest.make_params(cfg, jnp.float64)
    est_j, inp_j = example_state(cfg, jp, jnp.float64)

    ps = convert.static_params(tonp(jp), dtype=F64, device="cpu")
    est_t = convert.estimator_state(tonp(est_j), dtype=F64, device="cpu")
    tst_t = convert.tracker_state(tonp(tst_j), dtype=F64, device="cpu")
    cam = make_camera(cfg.camera, dtype=F64, device="cpu")

    key, ts = jax.random.PRNGKey(3), 0.15
    tst_j, out_j = step_j(tst_j, jnp.asarray(frames[3]), jnp.asarray(ts), key=key)
    tst_t, out_t = trk.detect_and_track(
        tst_t, t64(frames[3]), ts, cam, cfg.tracker, cfg.camera.focal_length,
        ransac_draws=torch.as_tensor(ransac_draws(key, cfg.tracker.ransac_iters)))
    np.testing.assert_array_equal(out_t.ids.numpy(), np.asarray(out_j.ids))

    # FrameInput as the engine's TRACKING path builds it: tracker features
    # plus the frame's IMU batch.
    fin_j = inp_j._replace(ids=out_j.ids, obs=out_j.obs, uv=out_j.uv.astype(jnp.float64),
                           vel=out_j.vel, valid=out_j.valid)
    fin_t = convert.frame_input(tonp(inp_j), dtype=F64, device="cpu")._replace(
        ids=out_t.ids, obs=out_t.obs, uv=out_t.uv.to(F64), vel=out_t.vel, valid=out_t.valid)

    est_j, kf_j = jax.jit(jest.bookkeeping_step)(est_j, fin_j, jp)
    est_t, kf_t = est.bookkeeping_step(est_t, fin_t, ps)
    assert bool(kf_j) == bool(kf_t)
    n_it = cfg.estimator.num_iterations
    _, p_j, q_j, _ = jax.jit(jest.solve_and_slide, static_argnums=(3,))(
        est_j, kf_j, jp, n_it)
    _, p_t, q_t, _ = est.solve_and_slide(est_t, bool(kf_t), ps, n_it)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=POSE_TOL)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=POSE_TOL)
    assert np.isfinite(p_t.numpy()).all()


def test_engine_reaches_tracking_on_cpu():
    cfg = example.bench_config()
    cam = make_camera(cfg.camera, dtype=F64, device="cpu")
    data = sim.simulate(example.bench_sim_config(1.3), cam, cfg.camera.r_ic_mat,
                        cfg.camera.t_ic_vec)
    engine = VIOEngine(cfg, device="cpu", dtype=torch.float32)
    lk.reset_launch_counts()
    imu_i, init, poses = 0, None, []
    for fi in range(len(data.frames)):
        img = sim.render_frame(data, fi, cam, example.R_IC, cfg.camera.t_ic_vec)
        ts = data.cam_ts[fi]
        while imu_i < len(data.imu_ts) and data.imu_ts[imu_i] <= ts + 1e-9:
            engine.push_imu(data.imu_ts[imu_i], data.imu_acc[imu_i], data.imu_gyr[imu_i])
            imu_i += 1
        res = engine.process_frame(img, ts)
        if res.ok:
            poses.append(res.pose)
        if init is None and res.status == Status.TRACKING:
            init = fi
        if init is not None and fi >= init + 5:
            break
    assert init is not None, "never reached TRACKING"
    assert engine.get_status() == Status.TRACKING
    assert len(poses) >= 5 and np.isfinite(np.asarray(poses)).all()
    assert lk.launch_counts == {"track_pyramidal": 0, "refine_template": 0,
                                "extract_patches": 0}
