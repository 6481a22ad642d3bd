"""The port's estimator half against the JAX package, float64: the state
converter, IMU preintegration, the normal equations at
``make_example_state(tiny_config())``, and ``bookkeeping_step`` +
``solve_and_slide`` through a keyframe (margin-old) and then a non-keyframe
(margin-new) step; and the flagship step unit (``entry.entry``) built at
float64 against the same reference programs.

Bars: preintegration within 1e-7 (tests/test_preintegration_parallel.py);
normal equations rtol 1e-8; poses within 1e-6 m / 1e-6; the prior compared
as J0ᵀJ0 and J0ᵀr0 (QR and eigh row signs are not unique) within 1e-6
relative to its largest entry; the entry unit within 1e-9.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import F64, example_state, reference_compile_cache, t64, tonp  # noqa: F401

from mobile_slam_tpu.engine import estimator as jest
from mobile_slam_tpu.engine.example import tiny_config
from mobile_slam_tpu.factors.imu_factor import sqrt_info_from_cov as jsqrt_info
from mobile_slam_tpu.imu import preintegration as jpre
from mobile_slam_tpu.models.state import eligible_mask as jelig
from mobile_slam_tpu.solver import assembly as jasm
from mobile_slam_tpu_torch import convert, entry
from mobile_slam_tpu_torch.engine import estimator as est
from mobile_slam_tpu_torch.factors.imu_factor import sqrt_info_from_cov
from mobile_slam_tpu_torch.imu import preintegration as pre
from mobile_slam_tpu_torch.models.state import eligible_mask
from mobile_slam_tpu_torch.solver import assembly

POSE_TOL = 1e-6
ENTRY_TOL = 1e-9

# The reference's preintegration functions as one program each: eagerly,
# their scans compile op by op on every call; jitted, once per shape.
_jpreintegrate = jax.jit(jpre.preintegrate)
_jpreintegrate_parallel = jax.jit(jpre.preintegrate_parallel)
_jcontinue = jax.jit(jpre.continue_preintegration_parallel)
_jpropagate_parallel = jax.jit(jpre.propagate_state_parallel)


@pytest.fixture(scope="module")
def example():
    cfg = tiny_config()
    jp = jest.make_params(cfg, jnp.float64)
    st, inp = example_state(cfg, jp, jnp.float64)
    return cfg, jp, st, inp


def _port(example):
    _, jp, st, inp = example
    return (convert.static_params(tonp(jp), dtype=F64, device="cpu"),
            convert.estimator_state(tonp(st), dtype=F64, device="cpu"),
            convert.frame_input(tonp(inp), dtype=F64, device="cpu"))


def test_convert_round_trip(example):
    _, _, st, _ = example
    ref = tonp(st)
    back = convert.to_numpy(convert.estimator_state(ref, dtype=F64, device="cpu"))
    leaves_a, leaves_b = jax.tree.leaves(ref), jax.tree.leaves(tuple(back))
    assert len(leaves_a) == len(leaves_b)
    for a, b in zip(leaves_a, leaves_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert back.frame_count.dtype == np.int32 and back.table.fid.dtype == np.int32


def _interval(seed, n=16):
    rng = np.random.default_rng(seed)
    dt = np.full(n, 0.005) * rng.uniform(0.8, 1.2, n)
    acc = rng.normal(size=(n, 3)) * 0.5 + [0.1, -0.2, 9.81007]
    gyr = rng.normal(size=(n, 3)) * 0.3
    return (rng.normal(size=3) * 0.5 + [0, 0, 9.81007], rng.normal(size=3) * 0.3,
            dt, acc, gyr)


def _pre_close(a, b, tol=1e-7):
    for name, x, y in zip(jpre.Preintegration._fields, a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=tol * (10 if name == "cov" else 1),
                                   err_msg=name)


@pytest.mark.parametrize("cnt", [0, 1, 7, 16])
def test_preintegration_matches(cnt):
    acc0, gyr0, dt, acc, gyr = _interval(1)
    ba, bg = np.array([0.01, -0.02, 0.005]), np.array([0.002, 0.001, -0.003])
    noise_j = jpre.make_noise_cov(0.05, 0.004, 4e-5, 2e-6, dtype=jnp.float64)
    noise = pre.make_noise_cov(0.05, 0.004, 4e-5, 2e-6, dtype=F64, device="cpu")
    args_j = [jnp.asarray(x) for x in (acc0, gyr0, dt, acc, gyr)]
    seq = _jpreintegrate(*args_j, jnp.asarray(cnt), jnp.asarray(ba), jnp.asarray(bg), noise_j)
    par = _jpreintegrate_parallel(*args_j, jnp.asarray(cnt), jnp.asarray(ba),
                                  jnp.asarray(bg), noise_j)
    got = pre.preintegrate_parallel(*[t64(x) for x in (acc0, gyr0, dt, acc, gyr)],
                                    torch.tensor(cnt), t64(ba), t64(bg), noise)
    _pre_close(seq, got)
    _pre_close(par, got, tol=1e-12)
    # Continue a segment, and propagate the world state over it.
    k = max(cnt // 2, 1)
    seg = pre.preintegrate_parallel(t64(acc0), t64(gyr0), t64(dt[:k]), t64(acc[:k]),
                                    t64(gyr[:k]), torch.tensor(k), t64(ba), t64(bg), noise)
    seg_j = _jpreintegrate_parallel(*[jnp.asarray(x) for x in (acc0, gyr0, dt[:k], acc[:k], gyr[:k])],
                                    jnp.asarray(k), jnp.asarray(ba), jnp.asarray(bg), noise_j)
    cont_j = _jcontinue(
        seg_j, jnp.asarray(acc[k - 1]), jnp.asarray(gyr[k - 1]), jnp.asarray(dt),
        jnp.asarray(acc), jnp.asarray(gyr), jnp.asarray(cnt), noise_j)
    cont = pre.continue_preintegration_parallel(
        seg, t64(acc[k - 1]), t64(gyr[k - 1]), t64(dt), t64(acc), t64(gyr),
        torch.tensor(cnt), noise)
    _pre_close(cont_j, cont, tol=1e-9)
    q0 = np.array([0.9, 0.1, -0.2, 0.3]) / np.linalg.norm([0.9, 0.1, -0.2, 0.3])
    state = [np.array([1.0, -2.0, 0.5]), q0, np.array([0.3, 0.1, -0.2]), ba, bg, acc0, gyr0]
    g = np.array([0, 0, 9.81007])
    out_j = _jpropagate_parallel(*[jnp.asarray(x) for x in state], jnp.asarray(dt),
                                 jnp.asarray(acc), jnp.asarray(gyr), jnp.asarray(cnt),
                                 jnp.asarray(g))
    out = pre.propagate_state_parallel(*[t64(x) for x in state], t64(dt), t64(acc), t64(gyr),
                                       torch.tensor(cnt), t64(g))
    for a, b in zip(out_j, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-9)


def test_normal_equations_match(example):
    cfg, jp, st, _ = example
    ps, ts, _ = _port(example)
    sp_j, sp = jest.solver_params(jp), est.solver_params(ps)
    w, tab = st.window, st.table
    x_j = jasm.XState(p=w.p, q=w.q, v=w.v, ba=w.ba, bg=w.bg,
                      lam=jnp.full((tab.fid.shape[0],), 0.25), td=jnp.asarray(0.0))
    prior_j = jasm.zero_prior(jp.ex_t, jp.ex_q, jnp.float64)._replace(
        J0=jnp.asarray(np.random.default_rng(3).normal(size=(172, 172)) * 0.01))
    args_j = (x_j, tab, w.pre, jsqrt_info(w.pre.cov[1:]),
              (w.pre.sum_dt[1:] < 10.0) & (w.imu_cnt[1:] > 0), prior_j,
              prior_j.J0.T @ prior_j.J0, jp.ex_t, jp.ex_q, sp_j, jasm.proj_valid_mask(tab))
    eq_j = jax.jit(jasm.build_normal_eqs)(*args_j)
    wt, tt = ts.window, ts.table
    x_t = assembly.XState(p=wt.p, q=wt.q, v=wt.v, ba=wt.ba, bg=wt.bg,
                          lam=torch.full((tt.fid.shape[0],), 0.25, dtype=F64),
                          td=torch.tensor(0.0, dtype=F64))
    prior_t = convert.to_torch(tonp(prior_j), assembly.Prior, dtype=F64, device="cpu")
    eq_t = assembly.build_normal_eqs(
        x_t, tt, wt.pre, sqrt_info_from_cov(wt.pre.cov[1:]),
        (wt.pre.sum_dt[1:] < 10.0) & (wt.imu_cnt[1:] > 0), prior_t,
        prior_t.J0.T @ prior_t.J0, ps.ex_t, ps.ex_q, sp, assembly.proj_valid_mask(tt))
    assert bool(jnp.any(jelig(tab))) and bool(eligible_mask(tt).any())
    for name, a, b in zip(eq_j._fields, eq_j, eq_t):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-8, atol=1e-8 * np.abs(a).max(),
                                   err_msg=name)


def _prior_close(pj, pt, tol=1e-6):
    J, r = np.asarray(pj.J0), np.asarray(pj.r0)
    Jt, rt = pt.J0.numpy(), pt.r0.numpy()
    H, Ht = J.T @ J, Jt.T @ Jt
    assert np.abs(H - Ht).max() <= tol * max(np.abs(H).max(), 1e-30)
    g, gt = J.T @ r, Jt.T @ rt
    assert np.abs(g - gt).max() <= tol * max(np.abs(H).max(), 1e-30) ** 0.5 * max(np.abs(r).max(), 1.0)
    for name in ("p0", "q0", "v0", "ba0", "bg0"):
        np.testing.assert_allclose(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)),
                                   atol=POSE_TOL, err_msg=name)


def test_bookkeeping_and_solve_keyframe_then_general(example):
    cfg, jp, st, inp = example
    ps, ts, ti = _port(example)
    book_j = jax.jit(jest.bookkeeping_step)
    solve_j = jax.jit(jest.solve_and_slide, static_argnums=(3,))
    n_it = cfg.estimator.num_iterations
    for kf in (True, False):
        st, is_kf_j = book_j(st, inp, jp)
        ts, is_kf_t = est.bookkeeping_step(ts, ti, ps)
        assert bool(is_kf_j) == bool(is_kf_t)
        np.testing.assert_array_equal(ts.table.fid.numpy(), np.asarray(st.table.fid))
        st, p_j, q_j, diag_j = solve_j(st, jnp.asarray(kf), jp, n_it)
        ts, p_t, q_t, diag_t = est.solve_and_slide(ts, kf, ps, n_it)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=POSE_TOL)
        np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=POSE_TOL)
        np.testing.assert_allclose(ts.window.p.numpy(), np.asarray(st.window.p), atol=POSE_TOL)
        np.testing.assert_allclose(ts.table.depth.numpy(), np.asarray(st.table.depth),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(diag_t.culled_ids.numpy(), np.asarray(diag_j.culled_ids))
        assert int(diag_t.accepted_steps) == int(diag_j.accepted_steps)
        _prior_close(st.prior, ts.prior)
        inp = inp._replace(ts=inp.ts + 0.05)
        ti = ti._replace(ts=ti.ts + 0.05)
    assert np.abs(np.asarray(st.prior.J0)).max() > 0     # margin-new saw a live prior


def test_entry_unit_float64_matches_reference(example):
    """``entry.entry(dtype=float64)``'s unit (tests/test_torch_entry.py holds
    the float32 one against ``__graft_entry__.entry()``): its example state
    equals the reference's, and one step (bookkeeping, then solve_and_slide
    on the keyframe flag as a tensor; the reference's flag traced under
    jit) gives p, q and the slid window within ENTRY_TOL."""
    cfg, jp, st, inp = example
    step, (ts, ti) = entry.entry(device="cpu", dtype=F64)
    want = convert.to_numpy(convert.estimator_state(tonp(st), dtype=F64, device="cpu"))
    for a, b in zip(jax.tree.leaves(tuple(convert.to_numpy(ts))), jax.tree.leaves(tuple(want))):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    st, is_kf = jax.jit(jest.bookkeeping_step)(st, inp, jp)
    st, p_j, q_j, _ = jax.jit(jest.solve_and_slide, static_argnums=(3,))(
        st, is_kf, jp, cfg.estimator.num_iterations)
    ts, p_t, q_t = step(ts, ti)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=ENTRY_TOL, rtol=0)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=ENTRY_TOL, rtol=0)
    for name in ("p", "q", "v"):
        np.testing.assert_allclose(getattr(ts.window, name).numpy(),
                                   np.asarray(getattr(st.window, name)), atol=ENTRY_TOL,
                                   rtol=0, err_msg=name)
    np.testing.assert_array_equal(ts.table.fid.numpy(), np.asarray(st.table.fid))
