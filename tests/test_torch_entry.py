"""The port's flagship step unit (``mobile_slam_tpu_torch/entry.py``) against
the repo's ``__graft_entry__.entry()``, on the CPU.

``entry(device="cpu")`` builds the tiny configuration's example state and
input in float32, as the reference's ``entry()`` does; the two states agree
within 1e-9 relative to each leaf's largest entry (measured 1.5e-11
absolute). Its step (bookkeeping, then ``solve_and_slide`` on the keyframe
flag as a tensor) is held against ``jax.jit`` of the reference's step on
``p``, ``q`` and the slid window: the two round float32 products in another
order through two LM iterations, so positions and rotations agree within
F32_TOL (measured 6.4e-7 m on ``p``, 2.2e-6 on ``q``, 1.1e-6 m and 2.2e-6 on
the window's) and the window's velocities within F32_V_TOL (measured
1.15e-5 m/s of 0.30). The reference's step compiles once in this file.
The same unit built at float64 through the same functions
(``make_params``, ``make_example_state``, ``bookkeeping_step``,
``solve_and_slide``) agrees with the reference's within 1e-9:
tests/test_torch_estimator.py holds that case, beside the float64
reference programs it compiles already.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from tests._torch_parity import reference_compile_cache, tonp  # noqa: F401

from mobile_slam_tpu.engine import example as jexample
from mobile_slam_tpu_torch import convert, entry

F32_TOL = 1e-5
F32_V_TOL = 5e-5
STATE_RTOL = 1e-9


def _leaves(tree):
    return jax.tree.leaves(tuple(tree))


@pytest.fixture(scope="module")
def reference():
    """The reference's (state, inp) and ``jax.jit`` of its step on them; its
    example state built as one jitted program instead of op by op (as
    tests/_torch_parity.py builds it), the same float32 numbers."""
    built = jax.jit(jexample.make_example_state, static_argnums=(0, 2, 3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jexample, "make_example_state",
                   lambda cfg, params, dtype, seed=0: built(cfg, params, dtype, seed))
        step, (st, inp) = graft.entry()
    return tonp((st, inp)), tonp(jax.jit(step)(st, inp))


@pytest.fixture(scope="module")
def port():
    return entry.entry(device="cpu")


def test_example_state_matches_reference(reference, port):
    (st_j, inp_j), _ = reference
    _, (st, inp) = port
    assert st.window.p.dtype == torch.float32 and st.window.p.device.type == "cpu"
    for got, want in zip(_leaves(convert.to_numpy(st)) + _leaves(convert.to_numpy(inp)),
                         jax.tree.leaves(st_j) + jax.tree.leaves(inp_j)):
        assert got.dtype == want.dtype and got.shape == want.shape
        if want.dtype.kind == "f" and want.size:
            assert np.abs(got - want).max() <= STATE_RTOL * max(np.abs(want).max(), 1.0)
        else:
            np.testing.assert_array_equal(got, want)


def test_step_matches_reference_float32(reference, port):
    _, (st_j, p_j, q_j) = reference
    step, (st, inp) = port
    st_t, p_t, q_t = step(st, inp)
    np.testing.assert_allclose(p_t.numpy(), p_j, atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(q_t.numpy(), q_j, atol=F32_TOL, rtol=0)
    for name, bar in (("p", F32_TOL), ("q", F32_TOL), ("v", F32_V_TOL)):
        np.testing.assert_allclose(getattr(st_t.window, name).numpy(),
                                   getattr(st_j.window, name), atol=bar, rtol=0, err_msg=name)
    np.testing.assert_array_equal(st_t.table.fid.numpy(), st_j.table.fid)
    assert int(st_t.frame_count) == int(st_j.frame_count)



def test_entry_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="cuda"):
        entry.entry()
