"""The port's frontend against the JAX package: F-RANSAC with the
reference's own draws injected, and ``detect_and_track`` over a short
sequence at ``tiny_config()`` size (64x64 pinhole, 32 slots, 2 pyramid
levels), both sides starting from the same converted tracker state. The
reference runs its Pallas kernels in interpret mode, so both sides share
the replicate-border LK semantics.

Bars: inlier masks, ``ids``, ``valid`` and ``num_tracked`` identical;
``uv`` within 0.02 px and ``obs`` within 1e-5 on live slots.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import (  # noqa: F401
    F64, ransac_draws, reference_compile_cache, shifted, t64, texture, tonp)

from mobile_slam_tpu.engine.example import tiny_config
from mobile_slam_tpu.frontend import tracker as jtrk
from mobile_slam_tpu.models.cameras.base import make_camera as jax_camera
from mobile_slam_tpu.ops import lk_pallas, ransac as jransac
from mobile_slam_tpu_torch import convert
from mobile_slam_tpu_torch.frontend import tracker as trk
from mobile_slam_tpu_torch.models.cameras.base import make_camera
from mobile_slam_tpu_torch.ops import lk, ransac

UV_TOL, OBS_TOL = 0.02, 1e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    lk_pallas._INTERPRET = True
    yield
    lk_pallas._INTERPRET = False


def _epipolar_world(seed=4, n=60, n_out=8):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(3, 8, (n, 1))], -1)
    ang = 0.05
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    t = np.array([0.3, 0.05, 0.02])
    f, c = 300.0, 256.0
    x1 = f * X[:, :2] / X[:, 2:] + c
    X2 = X @ R.T + t
    x2 = f * X2[:, :2] / X2[:, 2:] + c
    x1 += rng.normal(0, 0.2, x1.shape)
    x2 += rng.normal(0, 0.2, x2.shape)
    x2[:n_out] += rng.uniform(-15, 15, (n_out, 2))
    valid = np.ones(n, bool)
    valid[-5:] = False
    return x1, x2, valid


@pytest.mark.parametrize("seed", [4, 9])
def test_ransac_with_injected_draws(seed):
    x1, x2, valid = _epipolar_world(seed)
    key = jax.random.PRNGKey(seed)
    F_j, st_j = jransac.find_fundamental_ransac(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), jnp.asarray(1.0), key,
        num_hypotheses=16)
    F_t, st_t = ransac.find_fundamental_ransac(
        t64(x1), t64(x2), torch.as_tensor(valid), 1.0, num_hypotheses=16,
        r=torch.as_tensor(ransac_draws(key, 16)))
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    assert st_t.sum() > 30
    a = np.asarray(F_j) / np.linalg.norm(np.asarray(F_j))
    b = F_t.numpy() / np.linalg.norm(F_t.numpy())
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) < 1e-6
    rec_j = jransac.edge_recovery(F_j, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(x2),
                                  st_j, jnp.asarray(valid), jnp.asarray(1.0),
                                  jnp.asarray(2.0), jnp.asarray(256.0), jnp.asarray(256.0))
    rec_t = ransac.edge_recovery(F_t, t64(x1), t64(x2), t64(x2), st_t,
                                 torch.as_tensor(valid), 1.0, 2.0, 256.0, 256.0)
    np.testing.assert_array_equal(rec_t.numpy(), np.asarray(rec_j))


def tracker_sequence(n_frames=5, step=(0.9, -0.6)):
    """A 64x64 texture translating by ``step`` px per frame."""
    base = texture(np.random.RandomState(11), 64, 64).astype(np.float64)
    return [shifted(base, k * step[0], k * step[1]) for k in range(n_frames)]


def jax_tracker(cfg):
    tcfg = dataclasses.replace(cfg.tracker, use_pallas=True)
    cam = jax_camera(cfg.camera, dtype=jnp.float64)
    step = jax.jit(functools.partial(jtrk.detect_and_track, camera=cam, cfg=tcfg,
                                     focal=cfg.camera.focal_length))
    state = jtrk.init_tracker_state(tcfg, cfg.camera.height, cfg.camera.width, jnp.float64)
    # Typed as the step returns it (points in float32, as its kernels
    # compute them; a weakly typed timestamp), so that the second frame does
    # not compile the step again. Both hold zeros here.
    return step, state._replace(pts=state.pts.astype(jnp.float32),
                                prev_ts=jnp.asarray(0.0))


def compare_outputs(out_j, out_t):
    out_j = tonp(out_j)
    np.testing.assert_array_equal(out_t.ids.numpy(), out_j.ids)
    np.testing.assert_array_equal(out_t.valid.numpy(), out_j.valid)
    assert int(out_t.num_tracked) == int(out_j.num_tracked)
    live = out_j.ids >= 0
    assert np.abs(out_t.uv.numpy()[live] - out_j.uv[live]).max() < UV_TOL
    assert np.abs(out_t.obs.numpy()[live] - out_j.obs[live]).max() < OBS_TOL


def test_detect_and_track_sequence():
    cfg = tiny_config()
    step_j, st_j = jax_tracker(cfg)
    st_t = convert.tracker_state(tonp(st_j), dtype=F64, device="cpu")
    cam = make_camera(cfg.camera, dtype=F64, device="cpu")
    before = dict(lk.launch_counts)
    n_valid = []
    for k, img in enumerate(tracker_sequence()):
        key = jax.random.PRNGKey(100 + k)
        ts = 0.05 * k
        st_j, out_j = step_j(st_j, jnp.asarray(img), jnp.asarray(ts), key=key)
        st_t, out_t = trk.detect_and_track(
            st_t, t64(img), ts, cam, cfg.tracker, cfg.camera.focal_length,
            ransac_draws=torch.as_tensor(ransac_draws(key, cfg.tracker.ransac_iters)))
        compare_outputs(out_j, out_t)
        n_valid.append(int(out_t.valid.sum()))
    assert n_valid[-1] >= 10, n_valid          # features really are tracked
    assert lk.launch_counts == before           # CPU tensors: plain versions only
