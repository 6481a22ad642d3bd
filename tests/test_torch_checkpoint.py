"""The port's checkpoint/resume (mobile_slam_tpu_torch/engine/checkpoint.py)
against the JAX package's, on the CPU.

1. A snapshot the JAX package's ``save_state`` wrote (its example
   estimator state and a filled tracker state, float64) loads through the
   port's ``load_state`` equal, leaf for leaf and bit for bit, to
   ``convert.estimator_state`` / ``convert.tracker_state`` of the same
   states; a JAX ``save_engine`` snapshot loads through ``load_engine``
   with every host field, and says that its PRNG key was not carried.
2. ``save_engine`` / ``load_engine`` keep every host field (mirrors
   tests/test_checkpoint_resume.py::test_snapshot_roundtrip_preserves_host_fields).
3. A resumed engine on the feature path continues bit-exactly: the same
   poses as the uninterrupted engine, ``assert_array_equal`` (mirrors
   tests/test_checkpoint_resume.py::test_resumed_engine_matches_uninterrupted:
   duration 4 s, 300 landmarks, 60 features, float32, the snapshot at the
   first TRACKING frame with 5 poses), over the ``RESUMED`` frames after the
   snapshot (the reference's test asks for at least 10). State that a
   snapshot drops shows at the first resumed frame: the engine is
   deterministic, so the two runs either agree bit for bit or part there.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import F64, example_state, reference_compile_cache, tonp  # noqa: F401
from tests.test_checkpoint_resume import make_cfg

from mobile_slam_tpu.engine import checkpoint as jckpt
from mobile_slam_tpu.engine import estimator as jest
from mobile_slam_tpu.engine import vio_engine as jvio
from mobile_slam_tpu.engine.example import tiny_config
from mobile_slam_tpu.frontend import tracker as jtrk
from mobile_slam_tpu_torch import convert
from mobile_slam_tpu_torch.engine import checkpoint as ckpt
from mobile_slam_tpu_torch.engine import estimator as est
from mobile_slam_tpu_torch.engine.vio_engine import Status, VIOEngine
from mobile_slam_tpu_torch.eval import simulation as sim
from mobile_slam_tpu_torch.frontend import tracker as trk
from mobile_slam_tpu_torch.models.cameras.base import make_camera


def _filled_tracker_state(cfg, seed=1):
    """The reference's tracker state with every leaf set from a seed."""
    rng = np.random.default_rng(seed)
    ts = jtrk.init_tracker_state(cfg.tracker, cfg.camera.height, cfg.camera.width,
                                 jnp.float64)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == bool:
            return jnp.asarray(rng.random(a.shape) < 0.5)
        if np.issubdtype(a.dtype, np.integer):
            return jnp.asarray(rng.integers(-1, 500, a.shape).astype(a.dtype))
        return jnp.asarray(rng.normal(size=a.shape) * 50.0)

    return jax.tree.map(fill, ts)


def _leaves(tree):
    return dict(ckpt._flatten_with_paths(tree))


def test_jax_snapshot_loads_field_for_field(tmp_path):
    cfg = tiny_config()
    jp = jest.make_params(cfg, jnp.float64)
    jstate, _ = example_state(cfg, jp, jnp.float64)
    jtracker = _filled_tracker_state(cfg)
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(path, jstate, jtracker)

    params = convert.static_params(tonp(jp), dtype=F64, device="cpu")
    template = est.init_state(cfg, params, F64)
    ttemplate = trk.init_tracker_state(cfg.tracker, cfg.camera.height, cfg.camera.width,
                                       dtype=F64, device="cpu")
    state, tracker = ckpt.load_state(path, template, ttemplate)
    for got, want in ((state, convert.estimator_state(tonp(jstate), dtype=F64, device="cpu")),
                      (tracker, convert.tracker_state(tonp(jtracker), dtype=F64, device="cpu"))):
        got, want = _leaves(got), _leaves(want)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    # The keys are the reference's, written as jax.tree_util renders them.
    with np.load(path) as data:
        assert {k for k in data.files} == (
            {f"est:{k}" for k in _leaves(state)} | {f"trk:{k}" for k in _leaves(tracker)})


def test_jax_engine_snapshot_loads_into_the_port(tmp_path):
    cfg = make_cfg()
    jeng = jvio.VIOEngine(cfg, jnp.float32)
    jeng.status = jvio.Status.TRACKING
    jeng._t0, jeng._last_frame_ts, jeng._depth_ema, jeng.frame_index = 12.5, 19.25, 2.5, 31
    jeng.window_ts = np.linspace(17.0, 19.25, 11)
    jeng.push_imu(19.3, np.array([0.1, 0.2, 9.8]), np.array([0.0, 0.01, 0.0]))
    jeng.params = jeng.params._replace(gravity=jnp.asarray([0.1, -0.2, 9.8], jnp.float32))
    path = str(tmp_path / "jax_engine.npz")
    jckpt.save_engine(path, jeng)

    eng = VIOEngine(cfg, device="cpu")
    with pytest.warns(UserWarning, match="JAX PRNG key"):
        ckpt.load_engine(path, eng)
    assert eng.status == Status.TRACKING
    assert (eng._t0, eng._last_frame_ts, eng._depth_ema, eng.frame_index) == (
        12.5, 19.25, 2.5, 31)
    np.testing.assert_array_equal(eng.window_ts, jeng.window_ts)
    np.testing.assert_array_equal(eng.params.gravity.numpy(), np.asarray(jeng.params.gravity))
    np.testing.assert_array_equal(eng._pending_imu[0], jeng._pending_imu[0])
    for k, v in _leaves(eng.state).items():
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(_jax_leaf(jeng.state, k)), err_msg=k)


def _jax_leaf(tree, key):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if "/".join(str(p) for p in path) == key:
            return leaf
    raise KeyError(key)


def test_snapshot_roundtrip_preserves_host_fields(tmp_path):
    cfg = make_cfg()
    eng = VIOEngine(cfg, device="cpu")
    eng.status = Status.TRACKING
    eng._t0 = 123.5
    eng._last_frame_ts = 130.25
    eng._depth_ema = 2.75
    eng._vel_ema = 0.4
    eng.frame_index = 77
    eng._consecutive_failures = 2
    eng._last_pose = np.arange(16.0).reshape(4, 4)
    eng._gen.manual_seed(99)
    torch.rand(3, generator=eng._gen)          # move it off its seed
    eng.push_imu(130.30, np.array([0.1, 0.2, 9.8]), np.array([0.0, 0.01, 0.0]))
    path = str(tmp_path / "c.npz")
    ckpt.save_engine(path, eng)

    fresh = VIOEngine(cfg, device="cpu")
    ckpt.load_engine(path, fresh)
    assert fresh.status == Status.TRACKING
    assert fresh._t0 == 123.5
    assert fresh._last_frame_ts == 130.25
    assert fresh._depth_ema == 2.75
    assert fresh._vel_ema == 0.4
    assert fresh.frame_index == 77
    assert fresh._consecutive_failures == 2
    np.testing.assert_array_equal(fresh._last_pose, eng._last_pose)
    assert len(fresh._pending_imu) == 1
    np.testing.assert_allclose(fresh._pending_imu[0],
                               [130.30, 0.1, 0.2, 9.8, 0.0, 0.01, 0.0])
    # The generator continues where the saved one stood.
    np.testing.assert_array_equal(torch.rand(4, generator=fresh._gen).numpy(),
                                  torch.rand(4, generator=eng._gen).numpy())
    host = json.loads(bytes(ckpt.load_extra(path)["host_json"]).decode())
    assert host["status"] == int(Status.TRACKING)


def _feed(engine, data, fi, imu_cursor):
    ts = data.cam_ts[fi]
    while imu_cursor < len(data.imu_ts) and data.imu_ts[imu_cursor] <= ts + 1e-9:
        engine.push_imu(data.imu_ts[imu_cursor], data.imu_acc[imu_cursor],
                        data.imu_gyr[imu_cursor])
        imu_cursor += 1
    f = data.frames[fi]
    return engine.process_features(ts, f["ids"], f["rays"], uv=f["uv"], vel=f["vel"]), imu_cursor


RESUMED = 20    # frames run after the snapshot, by both engines


def test_resumed_engine_matches_uninterrupted(tmp_path):
    cfg = make_cfg()
    cam = make_camera(cfg.camera, dtype=F64, device="cpu")
    scfg = sim.SimConfig(duration=4.0, cam_rate=20.0, imu_rate=200.0,
                         num_landmarks=300, max_features=60, acc_noise=0.02,
                         gyr_noise=0.002, pixel_noise=0.25, acc_bias=(0.01, -0.005, 0.015),
                         gyr_bias=(0.001, -0.0005, 0.0008), seed=3)
    data = sim.simulate(scfg, cam, cfg.camera.r_ic_mat, cfg.camera.t_ic_vec)
    n = len(data.frames)
    path = str(tmp_path / "ckpt.npz")

    eng_a = VIOEngine(cfg, device="cpu")
    imu_i, save_frame, poses_a = 0, None, {}
    for fi in range(n):
        res, imu_i = _feed(eng_a, data, fi, imu_i)
        if res.ok and res.pose is not None:
            poses_a[fi] = res.pose.copy()
        if save_frame is None and res.status == Status.TRACKING and len(poses_a) >= 5:
            save_frame = fi
            ckpt.save_engine(path, eng_a)
            imu_i_at_save = imu_i
        if save_frame is not None and fi == save_frame + RESUMED:
            break
    assert save_frame is not None, "never reached TRACKING"
    assert save_frame + RESUMED < n, "checkpoint too late to test resume"

    eng_b = VIOEngine(cfg, device="cpu")
    ckpt.load_engine(path, eng_b)
    assert eng_b.status == Status.TRACKING
    imu_j, poses_b = imu_i_at_save, {}
    for fi in range(save_frame + 1, save_frame + RESUMED + 1):
        res, imu_j = _feed(eng_b, data, fi, imu_j)
        if res.ok and res.pose is not None:
            poses_b[fi] = res.pose.copy()

    tail = [fi for fi in poses_a if fi > save_frame]
    assert len(tail) >= 10
    assert set(tail) == set(poses_b), sorted(set(tail) ^ set(poses_b))
    for fi in tail:
        np.testing.assert_array_equal(poses_a[fi], poses_b[fi],
                                      err_msg=f"resumed pose differs at frame {fi}")
