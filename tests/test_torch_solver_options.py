"""The estimator's options that are off by default, port against the JAX
package, float64 on the CPU at ``tiny_config(max_features=48,
num_iterations=8)`` (the example state of tests/test_solver_early_exit.py,
after one bookkeeping step).

1. ``lm.GREEDY_GN``, ``lm.BATCH_CANDIDATES`` and ``lm.EARLY_EXIT_FTOL``
   (1.5e-2: the example improves its cost by more than 1e-2 per iteration
   for its first 7 iterations, so a tighter tolerance never fires in 8;
   1.5e-2 stops after the 4th) through ``lm.optimize``, each against the
   reference's ``optimize`` traced with the same flag: poses within 1e-6,
   cost rtol 1e-7 (the default path already parts by 4e-9 there),
   accepted steps equal and depths within 1e-6.
   ``EARLY_EXIT_FTOL = 0`` is bit-equal to the default, 1e-6 accepts no
   more steps and lands within 1e-5 m.
2. The host and device forms of the options: ``solve_and_slide`` under
   ``torch.func.vmap`` at B = 2 (a tensor keyframe flag, as the fleet of
   parallel/batch.py runs it; one sequence a keyframe, one not) against
   each sequence's own single run with a python flag (the host form), for
   the LM options, the restricted dense prior and eigh triangulation:
   poses within 1e-9 m, accepted steps equal, J0ᵀJ0 within 1e-9 of its
   largest entry (1e-3 for the dense prior: its own float64 noise, see
   PRIOR_VMAP_TOL); LU RANSAC under vmap equal to its single calls.
3. The dense-eigh prior (``enable_sqrt_pipeline(False)``): ``marginalize_old``
   and ``marginalize_new`` against the reference's dense path, and
   ``RESTRICTED_SUPPORT`` through ``marginalize_new`` and through the
   factorization of the margin-old system, compared as J0ᵀJ0 and J0ᵀr0
   within 1e-6 relative (QR and eigh row signs are not unique).
4. ``ransac.USE_LU_HYPOTHESES`` with the reference's draws injected:
   inlier mask identical, F within 1e-6 (up to sign); its two helpers on
   random batches rtol 1e-9, a defective Gram matrix NaN on both sides.
5. ``feature_table.ADJUGATE_TRIANGULATION = False``: depths within rtol
   1e-9 on the rows it writes.

The reference reads its flags when it traces, so each reference arm is
traced after setting its flags (the three LM arms into one program), and
every flag is restored in ``finally``.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import (  # noqa: F401
    F64, example_state, ransac_draws, reference_compile_cache, t64, tonp)
from tests.test_torch_tracker import _epipolar_world

from mobile_slam_tpu.engine import estimator as jest
from mobile_slam_tpu.engine.example import tiny_config
from mobile_slam_tpu.factors import marginalization as jmarg
from mobile_slam_tpu.factors.imu_factor import sqrt_info_from_cov as jsqrt_info
from mobile_slam_tpu.frontend import feature_table as jft
from mobile_slam_tpu.models.state import eligible_mask as jelig
from mobile_slam_tpu.ops import ransac as jransac
from mobile_slam_tpu.solver import assembly as jasm, layout as jlayout, lm as jlm
from mobile_slam_tpu_torch import convert
from mobile_slam_tpu_torch.engine import estimator as est
from mobile_slam_tpu_torch.factors import marginalization as marg
from mobile_slam_tpu_torch.factors.imu_factor import sqrt_info_from_cov
from mobile_slam_tpu_torch.frontend import feature_table as ft
from mobile_slam_tpu_torch.models.state import eligible_mask
from mobile_slam_tpu_torch.ops import ransac
from mobile_slam_tpu_torch.parallel import batch
from mobile_slam_tpu_torch.solver import assembly, lm

N_IT = 8
FTOL_FIRES = 1.5e-2
POSE_TOL = 1e-6
VMAP_TOL = 1e-9


@contextlib.contextmanager
def flags(**kv):
    """Set module globals (``module__NAME=value``) and restore them."""
    mods = {"lm": lm, "jlm": jlm, "marg": marg, "jmarg": jmarg, "ft": ft,
            "jft": jft, "ransac": ransac, "jransac": jransac}
    old = []
    try:
        for key, val in kv.items():
            mod, name = key.split("__")
            old.append((mods[mod], name, getattr(mods[mod], name)))
            setattr(mods[mod], name, val)
        yield
    finally:
        for mod, name, val in reversed(old):
            setattr(mod, name, val)


@pytest.fixture(scope="module")
def example():
    cfg = tiny_config(max_features=48, num_iterations=N_IT)
    jp = jest.make_params(cfg, jnp.float64)
    st, inp = example_state(cfg, jp, jnp.float64)
    st, _ = jax.jit(jest.bookkeeping_step)(st, inp, jp)
    jtab = jax.jit(lambda s, p: jft.triangulate(
        s.table, s.window.p, s.window.q, p.ex_t, p.ex_q, p.init_depth, td=s.td))(st, jp)
    ps = convert.static_params(tonp(jp), dtype=F64, device="cpu")
    ts = convert.estimator_state(tonp(st), dtype=F64, device="cpu")
    return dict(jp=jp, st=st, jtab=jtab, ps=ps, ts=ts,
                ttab=convert.to_torch(tonp(jtab), type(ts.table), dtype=F64, device="cpu"))


def _port_optimize(ex):
    ts, ps = ex["ts"], ex["ps"]
    return lm.optimize(ts.window, ex["ttab"], ts.prior, ps.ex_t, ps.ex_q,
                       est.solver_params(ps), N_IT, td0=ts.td)


ARMS = {
    "greedy_gn": dict(GREEDY_GN=True),
    "batch_candidates": dict(BATCH_CANDIDATES=True),
    "early_exit_ftol": dict(EARLY_EXIT_FTOL=FTOL_FIRES),
}


@pytest.fixture(scope="module")
def reference_arms(example):
    """The reference's optimize under each arm of ARMS, traced into one
    program (each call traced with its flags set; one compile for all)."""
    def arms(s, t, p):
        out = {}
        for arm, kv in ARMS.items():
            with flags(**{f"jlm__{k}": v for k, v in kv.items()}):
                out[arm] = jlm.optimize(s.window, t, s.prior, p.ex_t, p.ex_q,
                                        jest.solver_params(p), N_IT, td0=s.td)
        return out

    return jax.jit(arms)(example["st"], example["jtab"], example["jp"])


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_lm_option_matches_reference(example, reference_arms, arm):
    jw, jtab, jres, _ = reference_arms[arm]
    with flags(**{f"lm__{k}": v for k, v in ARMS[arm].items()}):
        lm.reset_counts()
        tw, ttab, tres, _ = _port_optimize(example)
        counts = dict(lm.counts)
    np.testing.assert_allclose(tw.p.numpy(), np.asarray(jw.p), atol=POSE_TOL)
    np.testing.assert_allclose(tw.q.numpy(), np.asarray(jw.q), atol=POSE_TOL)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-7)
    assert int(tres.accepted) == int(jres.accepted)
    np.testing.assert_allclose(ttab.depth.numpy(), np.asarray(jtab.depth), rtol=1e-6,
                               atol=1e-6)
    if arm == "early_exit_ftol":
        # The exit fired: fewer iterations than the budget, one read each.
        assert int(jres.accepted) < N_IT
        assert counts == {"iterations": int(tres.accepted),
                          "host_reads": int(tres.accepted)}
    elif arm == "greedy_gn":
        assert counts == {"iterations": N_IT, "host_reads": N_IT}


def test_early_exit_tolerance_zero_is_the_fixed_loop(example):
    ts, ps = example["ts"], example["ps"]
    _, p0, q0, d0 = est.solve_and_slide(ts, True, ps, N_IT)
    with flags(lm__EARLY_EXIT_FTOL=0.0):
        _, p1, q1, d1 = est.solve_and_slide(ts, True, ps, N_IT)
    assert torch.equal(p0, p1) and torch.equal(q0, q1)
    assert torch.equal(d0.solver_cost, d1.solver_cost)
    assert int(d0.accepted_steps) == int(d1.accepted_steps)
    with flags(lm__EARLY_EXIT_FTOL=1e-6):
        _, p2, _, d2 = est.solve_and_slide(ts, True, ps, N_IT)
    assert int(d2.accepted_steps) <= int(d0.accepted_steps)
    np.testing.assert_allclose(p2.numpy(), p0.numpy(), atol=1e-5)


def _two_sequences(ex):
    """The example state and a copy whose observations are moved by seeded
    noise (numpy seed 3, 5e-3 on the normalized plane): under
    EARLY_EXIT_FTOL = 1.5e-2 the two stop after different iterations."""
    ts = ex["ts"]
    obs = ts.table.obs.clone()
    obs[..., :2] += t64(np.random.default_rng(3).normal(0, 5e-3, obs[..., :2].shape))
    return [ts, ts._replace(table=ts.table._replace(obs=obs))]


# The dense prior squares the prior (κ(J0)² conditioning): in float64 it
# carries ~1e-4 relative noise (tests/test_sqrt_marginalization.py:160-166);
# on this example a 1e-15 relative change of the window's positions moves
# its margin-old J0ᵀJ0 by 7e-5 (the square-root prior: 1e-11), and vmap's
# batched products round differently from single ones.
PRIOR_VMAP_TOL = {"dense_prior_restricted": 1e-3}

# Arms of the fleet test: module__NAME settings.
VMAP_ARMS = {
    **{arm: {f"lm__{k}": v for k, v in kv.items()} for arm, kv in ARMS.items()},
    "dense_prior_restricted": dict(marg__SQRT_MARGIN_OLD=False, marg__SQRT_MARGIN_NEW=False,
                                   marg__RESTRICTED_SUPPORT=True),
    "eigh_triangulation": dict(ft__ADJUGATE_TRIANGULATION=False),
}


@pytest.mark.parametrize("arm", sorted(VMAP_ARMS))
def test_device_form_under_vmap_equals_single_runs(example, arm):
    """Sequence 0 takes the keyframe branch (margin-old), sequence 1 the
    general one (margin-new), both selected on the device."""
    ps = example["ps"]
    seqs = _two_sequences(example)
    kf = torch.tensor([True, False])
    with flags(**VMAP_ARMS[arm]):
        singles = [est.solve_and_slide(s, bool(k), ps, N_IT) for s, k in zip(seqs, kf)]
        lm.reset_counts()
        fleet = torch.func.vmap(lambda s, k: est.solve_and_slide(s, k, ps, N_IT))(
            batch.batch_states(seqs), kf)
        assert lm.counts == {"iterations": N_IT, "host_reads": 0}
    steps = [int(s[3].accepted_steps) for s in singles]
    if arm == "early_exit_ftol":
        assert steps[0] != steps[1] and max(steps) < N_IT, steps
    for b, (st, p, q, d) in enumerate(singles):
        np.testing.assert_allclose(fleet[1][b].numpy(), p.numpy(), atol=VMAP_TOL)
        np.testing.assert_allclose(fleet[2][b].numpy(), q.numpy(), atol=VMAP_TOL)
        assert int(fleet[3].accepted_steps[b]) == int(d.accepted_steps)
        np.testing.assert_allclose(float(fleet[3].solver_cost[b]), float(d.solver_cost),
                                   rtol=1e-12)
        J, J_b = st.prior.J0, fleet[0].prior.J0[b]
        np.testing.assert_allclose((J_b.T @ J_b).numpy(), (J.T @ J).numpy(), rtol=0,
                                   atol=PRIOR_VMAP_TOL.get(arm, VMAP_TOL)
                                   * float((J.T @ J).abs().max()))


def _prior_close(jJ, jr, tJ, tr, tol=1e-6):
    J, r = np.asarray(jJ), np.asarray(jr)
    Jt, rt = tJ.numpy(), tr.numpy()
    H, Ht = J.T @ J, Jt.T @ Jt
    scale = max(np.abs(H).max(), 1e-30)
    assert np.abs(H - Ht).max() <= tol * scale
    g, gt = J.T @ r, Jt.T @ rt
    assert np.abs(g - gt).max() <= tol * scale ** 0.5 * max(np.abs(r).max(), 1.0)


@pytest.fixture(scope="module")
def margin_inputs(example):
    """A linearization point (the example window, depths from triangulation)
    and a prior whose rows touch only the reference's support."""
    st, jp, jtab = example["st"], example["jp"], example["jtab"]
    S = jlayout.S
    rng = np.random.default_rng(5)
    J0 = rng.normal(size=(S, S)) * 0.01
    J0[:, np.setdiff1d(np.arange(S), jmarg._SUPPORT)] = 0.0
    prior = jasm.zero_prior(jp.ex_t, jp.ex_q, jnp.float64)._replace(
        J0=jnp.asarray(J0), r0=jnp.asarray(rng.normal(size=S) * 0.1))
    w = st.window
    elig = jelig(jtab)
    lam = jnp.where(elig, 1.0 / jnp.where(jtab.depth > 0, jtab.depth, 1.0), 1.0)
    x = jasm.XState(p=w.p, q=w.q, v=w.v, ba=w.ba, bg=w.bg, lam=lam, td=jnp.asarray(0.0))
    conv = dict(dtype=F64, device="cpu")
    return dict(x=x, prior=prior,
                tx=convert.to_torch(tonp(x), assembly.XState, **conv),
                tprior=convert.to_torch(tonp(prior), assembly.Prior, **conv))


def test_dense_marginalize_old_matches_reference(example, margin_inputs):
    st, jp, jtab, ps = example["st"], example["jp"], example["jtab"], example["ps"]
    x, prior = margin_inputs["x"], margin_inputs["prior"]
    with flags(jmarg__SQRT_MARGIN_OLD=False):
        jpr = jax.jit(lambda x, t, w, pr, p: jmarg.marginalize_old(
            x, t, w, jsqrt_info(w.pre.cov[1:]), pr, p.ex_t, p.ex_q,
            jest.solver_params(p)))(x, jtab, st.window, prior, jp)
    tw = example["ts"].window
    marg.enable_sqrt_pipeline(False)
    try:
        assert not marg.SQRT_MARGIN_OLD and not marg.SQRT_MARGIN_NEW
        tpr = marg.marginalize_old(margin_inputs["tx"], example["ttab"], tw,
                                   sqrt_info_from_cov(tw.pre.cov[1:]),
                                   margin_inputs["tprior"], ps.ex_t, ps.ex_q,
                                   est.solver_params(ps))
    finally:
        marg.enable_sqrt_pipeline(True)
    assert bool(eligible_mask(example["ttab"]).any())
    _prior_close(jpr.J0, jpr.r0, tpr.J0, tpr.r0)
    for name in ("p0", "q0", "v0", "ba0", "bg0"):
        np.testing.assert_allclose(getattr(tpr, name).numpy(),
                                   np.asarray(getattr(jpr, name)), atol=1e-12)


@pytest.mark.parametrize("restricted", [False, True])
def test_dense_marginalize_new_matches_reference(example, margin_inputs, restricted):
    jp, ps = example["jp"], example["ps"]
    with flags(jmarg__SQRT_MARGIN_NEW=False, jmarg__RESTRICTED_SUPPORT=restricted):
        jpr = jax.jit(lambda x, pr, p: jmarg.marginalize_new(x, pr, p.ex_t, p.ex_q))(
            margin_inputs["x"], margin_inputs["prior"], jp)
    with flags(marg__SQRT_MARGIN_NEW=False, marg__RESTRICTED_SUPPORT=restricted):
        tpr = marg.marginalize_new(margin_inputs["tx"], margin_inputs["tprior"],
                                   ps.ex_t, ps.ex_q)
    _prior_close(jpr.J0, jpr.r0, tpr.J0, tpr.r0)
    # The restricted factorization writes only the support's columns.
    off = np.setdiff1d(np.arange(jlayout.S), jmarg._SUPPORT)
    if restricted:
        assert np.abs(tpr.J0.numpy()[:, off]).max() == 0.0


def test_restricted_factorization_of_the_margin_old_system(example, margin_inputs):
    """``RESTRICTED_SUPPORT`` on the dense margin-old system (prior, first
    IMU factor and frame-0 projections, depths and frame 0 eliminated,
    relabelled): the factorization the restricted margin-old runs."""
    tx, tprior, ps = margin_inputs["tx"], margin_inputs["tprior"], example["ps"]
    tw, ttab = example["ts"].window, example["ttab"]
    W = tw.p.shape[0]
    imu_valid = ((torch.arange(W - 1) == 0) & (tw.pre.sum_dt[1:] < 10.0)
                 & (tw.imu_cnt[1:] > 0))
    proj_valid = assembly.proj_valid_mask(ttab) & (ttab.start == 0)[:, None]
    eqs = assembly.build_normal_eqs(tx, ttab, tw.pre, sqrt_info_from_cov(tw.pre.cov[1:]),
                                    imu_valid, tprior, tprior.J0.T @ tprior.J0, ps.ex_t,
                                    ps.ex_q, est.solver_params(ps), proj_valid,
                                    include_td_rw=False)
    H, g = marg._eliminate_lambdas(eqs.H_ss, eqs.g_s, eqs.H_sl, eqs.H_ll, eqs.g_l,
                                   eligible_mask(ttab) & (ttab.start == 0))
    cols = tuple(int(i) for i in jlayout.frame_block_indices(0))
    H, g = marg._eliminate_frame_block(H, g, cols)
    jH, jg = jmarg._eliminate_frame_block(jnp.asarray(H.numpy()), jnp.asarray(g.numpy()),
                                          jnp.asarray(cols))
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(jH)).max())
    P = marg._perm("old", H)
    H, g = P @ H @ P.T, P @ g
    with flags(jmarg__RESTRICTED_SUPPORT=True):
        jJ, jr = jax.jit(lambda a, b: jmarg._sqrt_factorize(a, b))(
            jnp.asarray(H.numpy()), jnp.asarray(g.numpy()))
    with flags(marg__RESTRICTED_SUPPORT=True):
        tJ, tr = marg._sqrt_factorize(H, g)
    _prior_close(jJ, jr, tJ, tr)


def test_lu_hypotheses_ransac_matches_reference():
    x1, x2, valid = _epipolar_world(4)
    key = jax.random.PRNGKey(4)
    with flags(jransac__USE_LU_HYPOTHESES=True):
        F_j, st_j = jax.jit(lambda a, b, v, k: jransac.find_fundamental_ransac(
            a, b, v, jnp.asarray(1.0), k, num_hypotheses=16))(
            jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), key)
    with flags(ransac__USE_LU_HYPOTHESES=True):
        F_t, st_t = ransac.find_fundamental_ransac(
            t64(x1), t64(x2), torch.as_tensor(valid), 1.0, num_hypotheses=16,
            r=torch.as_tensor(ransac_draws(key, 16)))
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    assert st_t.sum() > 30
    a = np.asarray(F_j) / np.linalg.norm(np.asarray(F_j))
    b = F_t.numpy() / np.linalg.norm(F_t.numpy())
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) < 1e-6
    # Under the fleet's vmap (two point sets, their own draws) each member
    # equals its single call.
    x1b, x2b, vb = _epipolar_world(9)
    pts = [(t64(x1), t64(x2), torch.as_tensor(valid)), (t64(x1b), t64(x2b), torch.as_tensor(vb))]
    r = torch.stack([torch.as_tensor(ransac_draws(jax.random.PRNGKey(k), 16)) for k in (4, 9)])
    with flags(ransac__USE_LU_HYPOTHESES=True):
        singles = [ransac.find_fundamental_ransac(*p, 1.0, num_hypotheses=16, r=r[i])
                   for i, p in enumerate(pts)]
        fleet = torch.func.vmap(lambda a, b, v, rr: ransac.find_fundamental_ransac(
            a, b, v, 1.0, num_hypotheses=16, r=rr))(
            *[torch.stack(u) for u in zip(*pts)], r)
    for i, (F_i, st_i) in enumerate(singles):
        np.testing.assert_array_equal(fleet[1][i].numpy(), st_i.numpy())
        np.testing.assert_allclose(fleet[0][i].numpy(), F_i.numpy(), rtol=1e-9, atol=1e-12)


def test_lu_hypothesis_helpers_match_reference():
    rng = np.random.default_rng(6)
    A = rng.normal(size=(12, 8, 9))
    AtA = np.einsum("bri,brj->bij", A, A)
    AtA[0] = -np.eye(9)                # not positive definite: no factor
    got = ransac._min_eigvec_inv_power(t64(AtA)).numpy()
    want = np.asarray(jransac._min_eigvec_inv_power(jnp.asarray(AtA)))
    assert np.isnan(got[0]).all() and np.isnan(want[0]).all()
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-9, atol=1e-12)
    F = rng.normal(size=(12, 3, 3))
    np.testing.assert_allclose(ransac._rank2_project(t64(F)).numpy(),
                               np.asarray(jransac._rank2_project(jnp.asarray(F))),
                               rtol=1e-9, atol=1e-12)
    p1, p2 = rng.normal(size=(12, 8, 2)), rng.normal(size=(12, 8, 2))
    np.testing.assert_allclose(ransac._eight_point(t64(p1), t64(p2)).numpy(),
                               np.asarray(jransac._eight_point(jnp.asarray(p1),
                                                               jnp.asarray(p2))),
                               rtol=1e-8, atol=1e-10)


def test_eigh_triangulation_matches_reference(example):
    st, jp, ts, ps = example["st"], example["jp"], example["ts"], example["ps"]
    # Clear the depths so that every eligible row is triangulated.
    jt = st.table._replace(depth=jnp.full_like(st.table.depth, -1.0))
    tt = ts.table._replace(depth=torch.full_like(ts.table.depth, -1.0))
    with flags(jft__ADJUGATE_TRIANGULATION=False):
        jd = jax.jit(lambda t, s, p: jft.triangulate(
            t, s.window.p, s.window.q, p.ex_t, p.ex_q, p.init_depth, td=s.td))(jt, st, jp)
    with flags(ft__ADJUGATE_TRIANGULATION=False):
        td = ft.triangulate(tt, ts.window.p, ts.window.q, ps.ex_t, ps.ex_q,
                            ps.init_depth, td=ts.td)
    adj = ft.triangulate(tt, ts.window.p, ts.window.q, ps.ex_t, ps.ex_q,
                         ps.init_depth, td=ts.td)
    written = (tt.fid >= 0) & (tt.used_num >= 2) & (tt.start < tt.mask.shape[1] - 3)
    assert int(written.sum()) >= 10
    w = written.numpy()
    np.testing.assert_allclose(td.depth.numpy()[w], np.asarray(jd.depth)[w], rtol=1e-9)
    np.testing.assert_array_equal(td.depth.numpy()[~w], tt.depth.numpy()[~w])
    # The two solvers agree away from degeneracy (a sanity check of the data).
    assert np.median(np.abs(td.depth.numpy()[w] - adj.depth.numpy()[w])) < 1e-3
