"""The landmark-sharded damped step (parallel/tp_solver.py), float64 on the
CPU over ``gloo`` process groups, at ``tiny_config(max_features=48,
num_iterations=8)`` (the reference programs of tests/test_torch_solver_options.py,
shared through the compilation cache): the
reference's example state after one bookkeeping step, depths from its
triangulation, a prior whose rows touch the reference's support, td on
with a random-walk weight of 1e4 at td 4 ms (so that the td term, added by
rank 0 alone, shows) and mu 1e-4.

1. World 1 against the reference's ``tp_damped_step`` on a one-device CPU
   mesh: dx, dlam and cost rtol 1e-9.
2. World 2 (two processes spawned by parallel/launch.py over gloo; the
   ranks run tests/_torch_ranks.py, which imports no JAX) against the
   port's unsharded ``lm._solve_damped`` on the same equations: dx and each
   rank's dlam within 1e-9 relative, the cost rtol 1e-12, dx the same on
   both ranks.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from tests._torch_parity import F64, example_state, reference_compile_cache, tonp  # noqa: F401
from tests._torch_ranks import tp_local_step, tp_step

from mobile_slam_tpu.engine import estimator as jest
from mobile_slam_tpu.engine.example import tiny_config
from mobile_slam_tpu.factors import marginalization as jmarg
from mobile_slam_tpu.factors.imu_factor import sqrt_info_from_cov as jsqrt_info
from mobile_slam_tpu.frontend import feature_table as jft
from mobile_slam_tpu.models.state import eligible_mask as jelig
from mobile_slam_tpu.parallel import tp_solver as jtp
from mobile_slam_tpu.solver import assembly as jasm, layout as jlayout
from mobile_slam_tpu_torch import convert
from mobile_slam_tpu_torch.engine import estimator as est
from mobile_slam_tpu_torch.factors.imu_factor import sqrt_info_from_cov
from mobile_slam_tpu_torch.models.state import FeatureTable, eligible_mask
from mobile_slam_tpu_torch.parallel import launch, tp_solver
from mobile_slam_tpu_torch.solver import assembly, lm

MU = 1e-4
TD_RW_INFO = 1e4    # the td random-walk weight (0 in the default config)


@pytest.fixture(scope="module")
def problem():
    """The reference's inputs (JAX) and the same as port tensors."""
    cfg = tiny_config(max_features=48, num_iterations=8)
    jp = jest.make_params(cfg, jnp.float64)
    st, inp = example_state(cfg, jp, jnp.float64)
    st, _ = jax.jit(jest.bookkeeping_step)(st, inp, jp)
    tab = jax.jit(lambda s, p: jft.triangulate(
        s.table, s.window.p, s.window.q, p.ex_t, p.ex_q, p.init_depth, td=s.td))(st, jp)
    jp = jp._replace(td_enable=jnp.asarray(1.0), td_rw_info=jnp.asarray(TD_RW_INFO))
    w = st.window
    S = jlayout.S
    rng = np.random.default_rng(8)
    J0 = rng.normal(size=(S, S)) * 0.01
    J0[:, np.setdiff1d(np.arange(S), jmarg._SUPPORT)] = 0.0
    prior = jasm.zero_prior(jp.ex_t, jp.ex_q, jnp.float64)._replace(
        J0=jnp.asarray(J0), r0=jnp.asarray(rng.normal(size=S) * 0.1))
    elig = jelig(tab)
    lam = jnp.where(elig, 1.0 / jnp.where(tab.depth > 0, tab.depth, 1.0), 1.0)
    x = jasm.XState(p=w.p, q=w.q, v=w.v, ba=w.ba, bg=w.bg, lam=lam,
                    td=jnp.asarray(0.004))
    ref = dict(x=x, table=tab, pre=w.pre, sqrt=jsqrt_info(w.pre.cov[1:]),
               imu_valid=(w.pre.sum_dt[1:] < 10.0) & (w.imu_cnt[1:] > 0), prior=prior,
               prior_H0=prior.J0.T @ prior.J0, ex_t=jp.ex_t, ex_q=jp.ex_q,
               sp=jest.solver_params(jp), proj_valid=jasm.proj_valid_mask(tab),
               lam_mask=elig)
    conv = dict(dtype=F64, device="cpu")
    ts = convert.estimator_state(tonp(st), **conv)
    tp = convert.static_params(tonp(jp), **conv)
    tx = convert.to_torch(tonp(x), assembly.XState, **conv)
    ttab = convert.to_torch(tonp(tab), FeatureTable, **conv)
    tprior = convert.to_torch(tonp(prior), assembly.Prior, **conv)
    port = dict(x=tx, table=ttab, pre=ts.window.pre,
                sqrt=sqrt_info_from_cov(ts.window.pre.cov[1:]),
                imu_valid=(ts.window.pre.sum_dt[1:] < 10.0) & (ts.window.imu_cnt[1:] > 0),
                prior=tprior, prior_H0=tprior.J0.T @ tprior.J0, ex_t=tp.ex_t,
                ex_q=tp.ex_q,
                sp=est.solver_params(tp),
                proj_valid=assembly.proj_valid_mask(ttab), lam_mask=eligible_mask(ttab))
    assert bool(port["lam_mask"].any())
    return ref, port


def _unsharded(port):
    eqs = assembly.build_normal_eqs(
        port["x"], port["table"], port["pre"], port["sqrt"], port["imu_valid"],
        port["prior"], port["prior_H0"], port["ex_t"], port["ex_q"], port["sp"],
        port["proj_valid"])
    dx, dlam = lm._solve_damped(eqs, torch.tensor(MU, dtype=F64), port["lam_mask"])
    return dx, dlam, eqs.cost


def test_world_one_matches_reference(problem, tmp_path):
    ref, port = problem
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("lm",))
    jdx, jdlam, jcost = jax.jit(lambda r: jtp.tp_damped_step(
        r["x"], r["table"], r["pre"], r["sqrt"], r["imu_valid"], r["prior"],
        r["prior_H0"], r["ex_t"], r["ex_q"], r["sp"], r["proj_valid"], r["lam_mask"],
        jnp.asarray(MU), mesh))(ref)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0)
    try:
        dx, dlam, cost = tp_local_step(port, 0, 1, MU)
    finally:
        dist.destroy_process_group()
    for got, want in ((dx, jdx), (dlam, jdlam), (cost, jcost)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


def test_world_two_matches_unsharded_solve(problem, tmp_path):
    _, port = problem
    inputs = str(tmp_path / "inputs.pt")
    torch.save(port, inputs)
    outs = launch.run_ranks(tp_step, 2, inputs, MU, device="cpu")
    dx, dlam, cost = _unsharded(port)
    assert torch.equal(outs[0][0], outs[1][0])          # dx replicated
    np.testing.assert_allclose(outs[0][0].numpy(), dx.numpy(), rtol=0,
                               atol=1e-9 * float(dx.abs().max()))
    got_dlam = torch.cat([outs[0][1], outs[1][1]])
    np.testing.assert_allclose(got_dlam.numpy(), dlam.numpy(), rtol=0,
                               atol=1e-9 * float(dlam.abs().max()))
    for r in range(2):
        np.testing.assert_allclose(float(outs[r][2]), float(cost), rtol=1e-12)


def test_shard_landmarks_slices_and_refuses_uneven(problem):
    _, port = problem
    table = port["table"]
    halves = [tp_solver.shard_landmarks(table, r, 2) for r in range(2)]
    assert type(halves[0]) is FeatureTable
    for name in FeatureTable._fields:
        assert torch.equal(torch.cat([getattr(h, name) for h in halves]), getattr(table, name))
    with pytest.raises(ValueError):
        tp_solver.shard_landmarks(table, 0, 5)
