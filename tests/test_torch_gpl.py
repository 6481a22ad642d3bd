"""The port's numpy copy of ``utils/gpl`` against the JAX package's: every
public function on seeded inputs (several cases each, the branches of the
piecewise ones included), results exactly equal."""

import inspect
import math

import numpy as np
import pytest

from mobile_slam_tpu.utils import gpl as ref
from mobile_slam_tpu_torch.utils import gpl

RNG = np.random.default_rng(0)


def _rot(rng):
    return ref.angle_axis_to_rotation(rng.normal(size=3))


def _cases():
    rng = RNG
    pts = rng.normal(size=(12, 3))
    R, t = _rot(rng), rng.normal(size=3)
    circ = np.stack([5 + 3 * np.cos(a) for a in np.linspace(0, 5, 9)]
                    + [2 + 3 * np.sin(a) for a in np.linspace(0, 5, 9)]).reshape(2, 9).T
    H = ref.homogeneous_transform(R, t)
    p1, p2 = np.append(rng.normal(size=2), 1.0), np.append(rng.normal(size=2), 1.0)
    return {
        "clamp": [(5, 0, 3), (-2, 0, 3), (1.5, 0, 3)],
        "hypot3": [(1.0, 2.0, 2.0), tuple(rng.normal(size=3))],
        "normalize_theta": [(7.0,), (-4.0,), (math.pi,)],
        "d2r": [(123.4,)],
        "r2d": [(2.1,)],
        "sinc": [(0.0,), (1e-11,), (0.7,)],
        "bres_line": [(0, 0, 7, 3), (5, 9, -2, 1), (3, 3, 3, 8), (0, 0, 0, 0)],
        "bres_circle": [(4, -2, 5), (0, 0, 1), (10, 10, 0)],
        "fit_circle": [(circ,), (circ + rng.normal(size=circ.shape) * 0.05,)],
        "intersect_circles": [(0.0, 0.0, 2.0, 3.0, 0.0, 2.0), (0.0, 0.0, 1.0, 2.0, 0.0, 1.0),
                              (0.0, 0.0, 1.0, 5.0, 0.0, 1.0), (0.0, 0.0, 1.0, 0.0, 0.0, 2.0)],
        "ll_to_utm": [(48.137, 11.575), (-33.9, 151.2), (60.0, 5.0), (78.0, 15.0),
                      (78.0, 25.0), (78.0, 35.0), (78.0, 5.0)],
        "utm_to_ll": [(5333000.0, 691000.0, "32U"), (6245000.0, 334000.0, "56H")],
        "skew": [(rng.normal(size=3),)],
        "sqrtm_psd": [(pts.T @ pts,)],
        "angle_axis_to_rotation": [(rng.normal(size=3),), (np.full(3, 1e-13),)],
        "rotation_to_angle_axis": [(R,), (ref.angle_axis_to_rotation([3.0, 0.1, 0.0]),),
                                   (np.eye(3),)],
        "angle_axis_to_quat": [(rng.normal(size=3),), (np.zeros(3),)],
        "quat_to_angle_axis": [(rng.normal(size=4),), (np.array([-0.5, 0.5, 0.5, 0.5]),),
                               (np.array([1.0, 0.0, 0.0, 0.0]),)],
        "rpy_to_mat": [tuple(rng.normal(size=3))],
        "mat_to_rpy": [(R,)],
        "homogeneous_transform": [(R, t)],
        "pose_with_spherical_translation": [(ref.angle_axis_to_quat(rng.normal(size=3)),
                                             rng.normal(size=2), 2.5)],
        "angle_axis_translation_to_screw": [(rng.normal(size=3), t), (np.zeros(3), t)],
        "sampson_error": [(rng.normal(size=(3, 3)), p1, p2)],
        "sampson_error_rt": [(R, t, p1, p2)],
        "sampson_error_h": [(H, p1, p2)],
        "transform_point": [(H, rng.normal(size=3))],
        "estimate_3d_rigid_transform": [(pts, pts @ R.T + t)],
        "estimate_3d_similarity_transform": [(pts, 1.7 * pts @ R.T + t)],
    }


CASES = _cases()
PUBLIC = sorted(n for n, f in inspect.getmembers(ref, inspect.isfunction)
                if not n.startswith("_") and f.__module__ == ref.__name__)


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def test_every_public_function_has_cases():
    assert sorted(CASES) == PUBLIC
    assert PUBLIC == sorted(n for n, f in inspect.getmembers(gpl, inspect.isfunction)
                            if not n.startswith("_") and f.__module__ == gpl.__name__)


@pytest.mark.parametrize("name", PUBLIC)
def test_function_equals_reference(name):
    for args in CASES[name]:
        assert _same(getattr(ref, name)(*args), getattr(gpl, name)(*args)), (name, args)
