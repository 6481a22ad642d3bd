"""The port's plain LK versions (the CPU side of the three CUDA kernels)
against the Pallas kernels in interpret mode and against ops/lk.py, on the
world of tests/test_lk_pallas.py: a 64x96 band-limited texture with a known
sub-pixel shift, interior points, windows that reach the border and a dead
slot.

Bars (those of tests/test_lk_pallas.py): K1/K2 ok masks identical, positions
within 0.02 px, K2 residuals within 0.05; K3 patches within 1e-3 at every
point against lk_pallas (replicate borders) and at interior points against
ops/lk.py (reflect-101 gradients at the border).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests._torch_parity import reference_compile_cache, shifted, texture  # noqa: F401

from mobile_slam_tpu.ops import image as jim, lk as jlk, lk_pallas
from mobile_slam_tpu_torch.ops import lk

H, W = 64, 96
SHIFT = (1.7, -1.2)
POS_TOL, RES_TOL, PATCH_TOL = 0.02, 0.05, 1e-3


@pytest.fixture(autouse=True)
def interpret_mode():
    lk_pallas._INTERPRET = True
    yield
    lk_pallas._INTERPRET = False


@pytest.fixture(scope="module")
def world():
    img0 = texture(np.random.RandomState(3), H, W)
    img1 = shifted(img0, *SHIFT).astype(np.float32)
    return img0, img1


def _points():
    pts = np.array([[30.0, 30.0], [45.3, 22.7], [60.1, 40.6], [25.8, 44.2],
                    [70.0, 25.5], [40.0, 15.0], [12.5, 12.5], [83.0, 50.0],
                    [5.0, 30.0], [0.0, 0.0]], np.float32)
    act = np.ones(len(pts), bool)
    act[-1] = False
    return pts, act


def _pyr(img, levels):
    return [np.array(a) for a in jim.build_pyramid(jnp.asarray(img, jnp.float32), levels)]


@pytest.mark.parametrize("levels", [1, 2])
def test_track_matches_pallas(world, levels):
    img0, img1 = world
    pts, act = _points()
    p0, p1 = _pyr(img0, levels), _pyr(img1, levels)
    prm = jlk.LKParams(window=21, levels=levels, iters=12, eps=0.005)
    pos_j, ok_j = lk_pallas.track_pyramidal(tuple(map(jnp.asarray, p0)),
                                            tuple(map(jnp.asarray, p1)),
                                            jnp.asarray(pts), jnp.asarray(act), prm)
    pos_t, ok_t = lk.track_pyramidal([torch.from_numpy(a) for a in p0],
                                     [torch.from_numpy(a) for a in p1],
                                     torch.from_numpy(pts), torch.from_numpy(act),
                                     lk.LKParams(*prm))
    ok_j, pos_j = np.asarray(ok_j), np.asarray(pos_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    both = ok_j & ok_t.numpy()
    assert both.sum() >= 7
    d = np.linalg.norm(pos_t.numpy()[both] - pos_j[both], axis=-1)
    assert d.max() < POS_TOL, d
    # The known shift is recovered at interior points.
    flow = pos_t.numpy()[:6] - pts[:6]
    assert np.median(np.linalg.norm(flow + np.array(SHIFT), axis=-1)) < 0.1
    # Dead slot passes through untouched.
    assert not bool(ok_t[-1])
    np.testing.assert_array_equal(pos_t.numpy()[-1], pts[-1])


def test_track_matches_xla_reference_interior(world):
    img0, img1 = world
    pts, act = _points()
    p0, p1 = _pyr(img0, 1), _pyr(img1, 1)
    prm = jlk.LKParams(window=21, levels=1, iters=12, eps=0.005)
    pos_x, ok_x = jlk.track_pyramidal([jnp.asarray(a) for a in p0],
                                      [jnp.asarray(a) for a in p1],
                                      jnp.asarray(pts), jnp.asarray(act), prm)
    pos_t, ok_t = lk.track_pyramidal_ref([torch.from_numpy(a) for a in p0],
                                         [torch.from_numpy(a) for a in p1],
                                         torch.from_numpy(pts), torch.from_numpy(act),
                                         lk.LKParams(*prm))
    interior = slice(0, 6)
    np.testing.assert_array_equal(ok_t.numpy()[interior], np.asarray(ok_x)[interior])
    d = np.linalg.norm(pos_t.numpy()[interior] - np.asarray(pos_x)[interior], axis=-1)
    assert d.max() < POS_TOL, d


def test_extract_matches_pallas_everywhere_and_xla_inside(world):
    img0, _ = world
    pts, _ = _points()
    ref = lk_pallas.extract_patches(jnp.asarray(img0, jnp.float32), jnp.asarray(pts), 21)
    xla = jlk.extract_patches(jnp.asarray(img0, jnp.float32), jnp.asarray(pts), 21)
    got = lk.extract_patches(torch.from_numpy(img0.astype(np.float32)),
                             torch.from_numpy(pts), 21)
    for a, x, b in zip(ref, xla, got):
        assert np.abs(b.numpy() - np.asarray(a)).max() < PATCH_TOL
        assert np.abs(b.numpy()[:6] - np.asarray(x)[:6]).max() < PATCH_TOL


@pytest.mark.parametrize("iters,max_shift", [(8, 2.0), (30, 2.5), (4, 2.0)])
def test_refine_matches_pallas_and_xla(world, iters, max_shift):
    img0, img1 = world
    pts, act = _points()
    tmpl = lk_pallas.extract_patches(jnp.asarray(img0, jnp.float32), jnp.asarray(pts), 21)
    start = pts + np.array([0.9, -0.6], np.float32)
    args = (jnp.asarray(start), jnp.asarray(act), 21, iters, 0.005, max_shift)
    pos_j, ok_j, res_j = lk_pallas.refine_template(jnp.asarray(img1), *tmpl, *args)
    pos_x, ok_x, res_x = jlk.refine_template(jnp.asarray(img1), *tmpl, *args)
    pos_t, ok_t, res_t = lk.refine_template(
        torch.from_numpy(img1), *[torch.from_numpy(np.asarray(t)) for t in tmpl],
        torch.from_numpy(start), torch.from_numpy(act), 21, iters, 0.005, max_shift)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    both = np.asarray(ok_j) & ok_t.numpy()
    assert both.sum() >= 7
    assert np.linalg.norm(pos_t.numpy()[both] - np.asarray(pos_j)[both], axis=-1).max() < POS_TOL
    assert np.abs(res_t.numpy()[both] - np.asarray(res_j)[both]).max() < RES_TOL
    interior = slice(0, 6)
    assert np.linalg.norm(pos_t.numpy()[interior] - np.asarray(pos_x)[interior],
                          axis=-1).max() < POS_TOL
    # Dead slot: pos0, not ok, zero residual.
    assert not bool(ok_t[-1]) and float(res_t[-1]) == 0.0
    np.testing.assert_array_equal(pos_t.numpy()[-1], start[-1])
