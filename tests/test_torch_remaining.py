"""The port's counterparts of the JAX package's smaller public functions,
float64 on the CPU:

* ``imu/preintegration``: the sequential ``preintegrate`` and
  ``propagate_state`` against the reference's scans (1e-12) and against
  the port's parallel forms (the existing bar between the two forms,
  1e-7; 1e-6 on the covariance).
* ``engine/example``: ``tiny_config`` / ``production_config`` equal to the
  reference's; ``make_example_state`` against the reference's state and
  frame input through ``convert.py`` (1e-12).
* ``ops/lk.track_level`` (the plain one-level KLT) on a textured pair,
  ``ops/image.downsample2x`` (odd sizes), ``equidistant.lift_unit_plane``
  and ``FeatureTable.slot_used``: 1e-12 / exact.
* ``eval/visualizer``: ``plot_imu_series`` and ``plot_run_dir`` write PNGs
  (matplotlib is present on the test host, not on the card's machine).

``EurocDataset.image_stream`` is held in tests/test_torch_io.py, beside
the sequence it reads."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import F64, example_state, reference_compile_cache, t64, texture, shifted, tonp  # noqa: F401

from mobile_slam_tpu.engine import estimator as jest, example as jex
from mobile_slam_tpu.imu import preintegration as jpre
from mobile_slam_tpu.models.cameras import equidistant as jeq
from mobile_slam_tpu.ops import image as jim, lk as jlk
from mobile_slam_tpu_torch import convert
from mobile_slam_tpu_torch.engine import estimator as est, example
from mobile_slam_tpu_torch.imu import preintegration as pre
from mobile_slam_tpu_torch.models.cameras import equidistant
from mobile_slam_tpu_torch.ops import image as im, lk

TOL = 1e-12
FORM_TOL = 1e-7

_jpreintegrate = jax.jit(jpre.preintegrate)
_jpropagate = jax.jit(jpre.propagate_state)
_jtrack_level = jax.jit(jlk.track_level, static_argnums=4)


def _interval(seed, n=12):
    rng = np.random.default_rng(seed)
    dt = np.full(n, 0.005) * rng.uniform(0.8, 1.2, n)
    acc = rng.normal(size=(n, 3)) * 0.5 + [0.1, -0.2, 9.81007]
    gyr = rng.normal(size=(n, 3)) * 0.3
    return (rng.normal(size=3) * 0.5 + [0, 0, 9.81007], rng.normal(size=3) * 0.3, dt, acc, gyr)


@pytest.mark.parametrize("cnt", [0, 5, 12])
def test_sequential_preintegration_matches_reference_and_parallel(cnt):
    acc0, gyr0, dt, acc, gyr = _interval(2)
    ba, bg = np.array([0.01, -0.02, 0.005]), np.array([0.002, 0.001, -0.003])
    noise_j = jpre.make_noise_cov(0.05, 0.004, 4e-5, 2e-6, dtype=jnp.float64)
    noise = pre.make_noise_cov(0.05, 0.004, 4e-5, 2e-6, dtype=F64, device="cpu")
    args = [t64(x) for x in (acc0, gyr0, dt, acc, gyr)]
    want = _jpreintegrate(*[jnp.asarray(x) for x in (acc0, gyr0, dt, acc, gyr)], jnp.asarray(cnt),
                          jnp.asarray(ba), jnp.asarray(bg), noise_j)
    got = pre.preintegrate(*args, cnt, t64(ba), t64(bg), noise)
    par = pre.preintegrate_parallel(*args, torch.tensor(cnt), t64(ba), t64(bg), noise)
    for name, w, g, p in zip(pre.Preintegration._fields, want, got, par):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=0,
                                   atol=FORM_TOL * (10 if name == "cov" else 1), err_msg=name)


@pytest.mark.parametrize("cnt", [0, 5, 12])
def test_sequential_propagation_matches_reference_and_parallel(cnt):
    acc0, gyr0, dt, acc, gyr = _interval(3)
    rng = np.random.default_rng(4)
    q = rng.normal(size=4)
    state = [rng.normal(size=3), q / np.linalg.norm(q), rng.normal(size=3),
             rng.normal(size=3) * 0.01, rng.normal(size=3) * 0.001, acc0, gyr0]
    g = np.array([0.0, 0.0, 9.81007])
    want = _jpropagate(*[jnp.asarray(x) for x in (*state, dt, acc, gyr)], jnp.asarray(cnt),
                       jnp.asarray(g))
    args = [t64(x) for x in (*state, dt, acc, gyr)]
    got = pre.propagate_state(*args, cnt, t64(g))
    par = pre.propagate_state_parallel(*args, torch.tensor(cnt), t64(g))
    for w, a, p in zip(want, got, par):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0, atol=TOL)
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=0, atol=FORM_TOL)


def _fields(cfg):
    """A configuration's values, as plain floats, ints and strings."""
    return jax.tree.map(lambda v: v.item() if hasattr(v, "item") else v,
                        jax.tree.leaves(dataclasses.astuple(cfg)))


@pytest.mark.parametrize("name", ["tiny_config", "production_config"])
def test_example_configs_equal_reference(name):
    assert _fields(getattr(example, name)()) == _fields(getattr(jex, name)())


@pytest.mark.parametrize("seed", [0, 3])
def test_make_example_state_matches_reference(seed):
    cfg = example.tiny_config()
    jp = jest.make_params(jex.tiny_config(), jnp.float64)
    want_state, want_inp = example_state(jex.tiny_config(), jp, jnp.float64, seed)
    params = est.make_params(cfg, dtype=F64, device="cpu")
    state, inp = example.make_example_state(cfg, params, F64, seed, device="cpu")
    for want, got in ((convert.estimator_state(tonp(want_state), dtype=F64, device="cpu"), state),
                      (convert.frame_input(tonp(want_inp), dtype=F64, device="cpu"), inp)):
        a, b = torch.utils._pytree.tree_leaves(want), torch.utils._pytree.tree_leaves(got)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0, atol=TOL)
    used = state.table.slot_used()
    np.testing.assert_array_equal(used.numpy(), np.asarray(want_state.table.slot_used()))
    assert int(used.sum()) == 48


def test_track_level_matches_reference():
    rs = np.random.RandomState(0)
    img = texture(rs, 64, 80).astype(np.float64)
    nxt = shifted(img, 1.3, -0.7)
    pts = np.array([[30.0, 30.0], [40.5, 20.25], [10.0, 50.0], [2.0, 2.0], [70.0, 60.0],
                    [78.5, 10.0]])
    active = np.array([True, True, True, True, False, True])
    for window, iters in ((11, 10), (21, 4)):
        want = _jtrack_level(jnp.asarray(img), jnp.asarray(nxt), jnp.asarray(pts),
                             jnp.asarray(pts), jlk.LKParams(window=window, iters=iters),
                             jnp.asarray(active))
        got = lk.track_level(t64(img), t64(nxt), t64(pts), t64(pts),
                             lk.LKParams(window=window, iters=iters), torch.as_tensor(active))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=TOL)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].numpy()[:3].all() and not got[1].numpy()[4]


@pytest.mark.parametrize("shape", [(64, 80), (63, 79)])
def test_downsample2x_matches_reference(shape):
    img = np.random.default_rng(1).uniform(0, 255, shape)
    np.testing.assert_array_equal(im.downsample2x(t64(img)).numpy(),
                                  np.asarray(jim.downsample2x(jnp.asarray(img))))


def test_lift_unit_plane_matches_reference():
    params = (190.97, 190.97, 254.9, 256.9, 0.0035, 0.0007, -0.002, 0.0002)
    uv = np.random.default_rng(2).uniform(40, 470, (64, 2))
    want = np.asarray(jeq.lift_unit_plane(jnp.asarray(params, jnp.float64), jnp.asarray(uv)))
    got = equidistant.lift_unit_plane(t64(params), t64(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=TOL)
    np.testing.assert_array_equal(got[:, 2], 1.0)


def test_plots_write_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    from mobile_slam_tpu_torch.eval import visualizer
    from mobile_slam_tpu_torch.io.trajectory import write_tum

    rng = np.random.default_rng(0)
    ts = np.arange(50) * 0.005
    fig = visualizer.plot_imu_series(ts, rng.normal(size=(50, 3)), rng.normal(size=(50, 3)),
                                     save=str(tmp_path / "imu.png"))
    assert len(fig.axes) == 2
    p = np.cumsum(rng.normal(size=(20, 3)) * 0.01, axis=0)
    write_tum(str(tmp_path / "trajectory_pose.txt"), 1.0 + np.arange(20) * 0.05, p,
              np.tile([1.0, 0, 0, 0], (20, 1)))
    gt = tmp_path / "gt.csv"
    gt.write_text("#ts,p,q\n" + "".join(f"{int(1e9 + i * 5e7)},{x},{y},{z},1,0,0,0\n"
                                         for i, (x, y, z) in enumerate(p)))
    visualizer.plot_run_dir(str(tmp_path), gt_csv=str(gt), save=str(tmp_path / "run.png"))
    for name in ("imu.png", "run.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
