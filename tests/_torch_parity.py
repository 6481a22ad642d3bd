"""Shared helpers for the tests that hold the PyTorch port against the JAX
package: seeded inputs, numpy conversion and a single torch thread per
worker (the suite runs several pytest-xdist workers side by side)."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.compilation_cache import compilation_cache

torch.set_num_threads(1)

F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Git-ignored (.gitignore: .xla_cache/).
COMPILE_CACHE = os.path.join(REPO, ".xla_cache", "torch_parity")


@pytest.fixture(scope="module", autouse=True)
def reference_compile_cache():
    """JAX's persistent compilation cache for the length of one test module
    that imports this fixture: the port's test files compile the same
    reference programs (the tiny configuration's estimator step, the
    feature-path engine, the example state, the trackers), and a program
    that one file compiled loads from the cache in another, also in
    another pytest-xdist worker. The executable is the same either way.
    Switched off again after the module, so that other tests run with
    JAX's defaults."""
    compilation_cache.set_cache_dir(COMPILE_CACHE)
    compilation_cache.reset_cache()
    yield
    compilation_cache.set_cache_dir(None)
    compilation_cache.reset_cache()


def tonp(tree):
    """JAX pytree -> the same structure with numpy leaves."""
    return jax.tree.map(np.asarray, tree)


def t64(a) -> torch.Tensor:
    """numpy/JAX array -> float64 CPU tensor."""
    return torch.as_tensor(np.array(a, dtype=np.float64))


def texture(rs: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """Band-limited random texture on a 0..255 scale (the world of
    tests/test_lk_pallas.py)."""
    base = rs.rand(h // 4 + 2, w // 4 + 2).astype(np.float32) * 255.0
    return np.asarray(jax.image.resize(jnp.asarray(base), (h, w), "cubic"))


def shifted(img: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """img resampled at (x + dx, y + dy) with the reference's bilinear."""
    from mobile_slam_tpu.ops import image as im

    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    coords = jnp.asarray(np.stack([xx + dx, yy + dy], -1))
    return np.asarray(im.bilinear_sample(jnp.asarray(img, jnp.float64), coords))


def _example_state(cfg, params, dtype, seed):
    from mobile_slam_tpu.engine.example import make_example_state

    return make_example_state(cfg, params, dtype, seed)


_example_state_jit = jax.jit(_example_state, static_argnums=(0, 2, 3))


def example_state(cfg, params, dtype, seed: int = 0):
    """The reference's ``make_example_state`` as one jitted program: the
    eager call compiles each of its operations on its own (~11 s per
    process, once per test worker), the jitted one ~2 s."""
    return _example_state_jit(cfg, params, dtype, seed)


def ransac_draws(key, num_hypotheses: int) -> np.ndarray:
    """The raw RANSAC draws the reference makes from ``key``
    (mobile_slam_tpu/ops/ransac.py:170)."""
    return np.array(jax.random.randint(key, (num_hypotheses, 8), 0, 1 << 30))
