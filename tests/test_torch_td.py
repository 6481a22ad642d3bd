"""Online camera-IMU time-offset (td) estimation in the port against the JAX
package, float64 on the CPU.

At the reference's example state (``make_example_state(tiny_config())``)
with ``estimate_td`` on, td = 12 ms and per-observation feature
velocities (finite differences of the tracks, so that td is observable):

* ``assembly.td_grad_hess``: g, h and the weight sum within rtol 1e-8;
* ``lm.optimize``: the td innovation, information and weight sum within
  rtol 1e-6, poses within 1e-6 m;
* ``solve_and_slide`` through a keyframe step then a general step: td
  within 1e-8 s, poses within 1e-6 m, the prior as J0ᵀJ0 and J0ᵀr0 (td
  column included), the step's td information and gain within rtol 1e-6;
* ``torch.func.vmap`` of ``solve_and_slide`` at B = 2 (two td values, one
  keyframe and one general step) against each sequence's single run
  within 1e-10;
* the config plumbing, and one behavioural run on the port alone: an
  injected 10 ms offset recovered within 4 ms (the scenario of
  tests/test_td_estimation.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import F64, example_state, reference_compile_cache, t64, tonp  # noqa: F401
from tests.test_torch_estimator import _prior_close

from mobile_slam_tpu.engine import estimator as jest
from mobile_slam_tpu.engine.example import tiny_config
from mobile_slam_tpu.frontend import feature_table as jft
from mobile_slam_tpu.solver import assembly as jasm
from mobile_slam_tpu.solver import lm as jlm
from mobile_slam_tpu_torch import config as tconfig
from mobile_slam_tpu_torch import convert
from mobile_slam_tpu_torch.engine import estimator as est
from mobile_slam_tpu_torch.eval import simulation as sim
from mobile_slam_tpu_torch.frontend import feature_table as ft
from mobile_slam_tpu_torch.models.cameras.base import make_camera
from mobile_slam_tpu_torch.solver import assembly, lm

POSE_TOL = 1e-6
TD0 = 0.012       # s, the example state's td
TD_TRUE = 0.010   # s, the offset injected into the behavioural run
DT_F = 0.05       # the example window's frame spacing


def _cfg():
    """tiny_config with td on, the fusion's gate knee and information
    constant lowered so that the example's short tracks move td (at the
    defaults its gain is ~1e-8 and td stays put)."""
    cfg = tiny_config()
    return dataclasses.replace(cfg, estimator=dataclasses.replace(
        cfg.estimator, estimate_td=True, td_gate_curv=10.0, td_fuse_info=1.0))


def _with_velocities(st, inp):
    """The example state and input with td = TD0 and each observation's
    feature velocity (its track's finite difference over the frame
    spacing); the example leaves them zero, where td has no effect."""
    obs = np.asarray(st.table.obs)
    vel = np.zeros(obs.shape[:2] + (2,))
    vel[:, 1:] = (obs[:, 1:, :2] - obs[:, :-1, :2]) / DT_F
    vel[:, 0] = vel[:, 1]
    table = st.table._replace(vel=jnp.asarray(vel))
    rng = np.random.default_rng(5)
    in_vel = jnp.asarray(rng.normal(size=np.asarray(inp.vel).shape) * 0.2)
    return (st._replace(table=table, td=jnp.asarray(TD0, st.td.dtype)),
            inp._replace(vel=in_vel))


@pytest.fixture(scope="module")
def example():
    cfg = _cfg()
    jp = jest.make_params(cfg, jnp.float64)
    st, inp = example_state(cfg, jp, jnp.float64)
    st, inp = _with_velocities(st, inp)
    return cfg, jp, st, inp


def _port(example):
    _, jp, st, inp = example
    return (convert.static_params(tonp(jp), dtype=F64, device="cpu"),
            convert.estimator_state(tonp(st), dtype=F64, device="cpu"),
            convert.frame_input(tonp(inp), dtype=F64, device="cpu"))


def _rclose(got, want, rtol):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * max(abs(want), 1e-300), (got, want)


def test_params_plumbing(example):
    cfg, jp, _, _ = example
    ps = est.make_params(cfg, dtype=F64, device="cpu")
    assert float(ps.td_enable) == 1.0
    for name in jest.StaticParams._fields:
        np.testing.assert_allclose(getattr(ps, name).numpy(), np.asarray(getattr(jp, name)),
                                   rtol=1e-12, err_msg=name)
    sp = est.solver_params(ps)
    assert abs(float(sp.td_max) - 0.08) < 1e-12
    off = est.make_params(tiny_config(), dtype=F64, device="cpu")
    assert float(off.td_enable) == 0.0
    e = tconfig.EstimatorConfig(estimate_td=True, td_init=0.5)
    assert e.td_max == 0.08


def test_td_grad_hess_matches(example):
    _, jp, st, _ = example
    ps, ts, _ = _port(example)
    w, tab = st.window, st.table
    x_j = jasm.XState(p=w.p, q=w.q, v=w.v, ba=w.ba, bg=w.bg,
                      lam=jnp.full((tab.fid.shape[0],), 0.25), td=jnp.asarray(TD0))
    want = jax.jit(jasm.td_grad_hess)(x_j, tab, jp.ex_t, jp.ex_q, jest.solver_params(jp),
                                      jasm.proj_valid_mask(tab))
    wt, tt = ts.window, ts.table
    x_t = assembly.XState(p=wt.p, q=wt.q, v=wt.v, ba=wt.ba, bg=wt.bg,
                          lam=torch.full((tt.fid.shape[0],), 0.25, dtype=F64),
                          td=torch.tensor(TD0, dtype=F64))
    got = assembly.td_grad_hess(x_t, tt, ps.ex_t, ps.ex_q, est.solver_params(ps),
                                assembly.proj_valid_mask(tt))
    assert float(want[1]) > 0 and float(want[0]) != 0.0
    for g, w_ in zip(got, want):
        _rclose(g, w_, 1e-8)


def test_optimize_td_innovation_matches(example):
    cfg, jp, st, _ = example
    ps, ts, _ = _port(example)
    n_it = cfg.estimator.num_iterations
    jtab = jax.jit(lambda s, p: jft.triangulate(
        s.table, s.window.p, s.window.q, p.ex_t, p.ex_q, p.init_depth, td=s.td))(st, jp)
    ttab = ft.triangulate(ts.table, ts.window.p, ts.window.q, ps.ex_t, ps.ex_q,
                          ps.init_depth, td=ts.td)
    jw, _, jres, _ = jax.jit(jlm.optimize, static_argnums=(6,))(
        st.window, jtab, st.prior, jp.ex_t, jp.ex_q, jest.solver_params(jp), n_it, st.td)
    tw, _, tres, _ = lm.optimize(ts.window, ttab, ts.prior, ps.ex_t, ps.ex_q,
                                 est.solver_params(ps), n_it, td0=ts.td)
    assert float(jres.td_info) > 0 and float(jres.td_innov) != 0.0
    for name in ("td_innov", "td_info", "td_wsum"):
        _rclose(getattr(tres, name), getattr(jres, name), 1e-6)
    np.testing.assert_allclose(tw.p.numpy(), np.asarray(jw.p), atol=POSE_TOL)
    np.testing.assert_allclose(tw.q.numpy(), np.asarray(jw.q), atol=POSE_TOL)


@pytest.fixture(scope="module")
def reference_steps(example):
    """The reference's bookkeeping + solve_and_slide through a keyframe
    step then a general step: [(state, p, q, diag)] per step."""
    cfg, jp, st, inp = example
    book_j = jax.jit(jest.bookkeeping_step)
    solve_j = jax.jit(jest.solve_and_slide, static_argnums=(3,))
    out = []
    for kf in (True, False):
        st, _ = book_j(st, inp, jp)
        st, p, q, diag = solve_j(st, jnp.asarray(kf), jp, cfg.estimator.num_iterations)
        out.append((st, p, q, diag))
        inp = inp._replace(ts=inp.ts + DT_F)
    return out


def test_solve_and_slide_td_keyframe_then_general(example, reference_steps):
    cfg, _, _, _ = example
    ps, ts, ti = _port(example)
    n_it = cfg.estimator.num_iterations
    for kf, (st, p_j, q_j, diag_j) in zip((True, False), reference_steps):
        ts, _ = est.bookkeeping_step(ts, ti, ps)
        ts, p_t, q_t, diag_t = est.solve_and_slide(ts, kf, ps, n_it)
        assert abs(float(ts.td) - float(st.td)) <= 1e-8, (float(ts.td), float(st.td))
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=POSE_TOL)
        np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=POSE_TOL)
        np.testing.assert_allclose(ts.window.p.numpy(), np.asarray(st.window.p), atol=POSE_TOL)
        _prior_close(st.prior, ts.prior)
        assert abs(float(ts.prior.td0) - float(st.prior.td0)) <= 1e-8
        _rclose(diag_t.td_info, diag_j.td_info, 1e-6)
        _rclose(diag_t.td_gain, diag_j.td_gain, 1e-6)
        ti = ti._replace(ts=ti.ts + DT_F)
    assert abs(float(st.td) - TD0) > 1e-4           # the fusion moved td


def test_vmap_solve_and_slide_matches_single_runs(example):
    cfg, _, _, _ = example
    ps, ts, ti = _port(example)
    n_it = cfg.estimator.num_iterations
    ts, _ = est.bookkeeping_step(ts, ti, ps)
    states = [ts, ts._replace(td=torch.tensor(-0.008, dtype=F64))]
    flags = (True, False)
    singles = [est.solve_and_slide(s, kf, ps, n_it) for s, kf in zip(states, flags)]
    from mobile_slam_tpu_torch.parallel import batch

    bst, bp, bq, bdiag = torch.func.vmap(
        lambda s, k: est.solve_and_slide(s, k, ps, n_it))(
        batch.batch_states(states), torch.tensor(flags))
    for b, (s1, p1, q1, d1) in enumerate(singles):
        assert abs(float(bst.td[b]) - float(s1.td)) <= 1e-10
        np.testing.assert_allclose(bp[b].numpy(), p1.numpy(), atol=1e-10, rtol=0)
        np.testing.assert_allclose(bq[b].numpy(), q1.numpy(), atol=1e-10, rtol=0)
        np.testing.assert_allclose(bst.window.p[b].numpy(), s1.window.p.numpy(),
                                   atol=1e-10, rtol=0)
        np.testing.assert_allclose(float(bdiag.td_gain[b]), float(d1.td_gain),
                                   atol=1e-10, rtol=0)
    assert abs(float(singles[0][0].td) - float(singles[1][0].td)) > 1e-3


# ---------------------------------------------------------------------------
# Behaviour: the port alone recovers an injected offset
# ---------------------------------------------------------------------------

R_IC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
K_PAD, M_PAD = 144, 16


def _sim_cfg():
    """tests/test_backend_sim.py's make_cfg with td on and the production
    solver budget (2 LM iterations), as tests/test_td_estimation.py runs it."""
    cam = tconfig.CameraConfig(
        model_type="PINHOLE", width=640, height=480, focal_length=460.0,
        fx=460.0, fy=460.0, cx=320.0, cy=240.0, r_ic=tuple(R_IC.reshape(-1)),
        t_ic=(0.05, 0.02, -0.03))
    return tconfig.VIOConfig(
        camera=cam, tracker=tconfig.TrackerConfig(max_cnt=120, max_points=K_PAD),
        estimator=tconfig.EstimatorConfig(
            max_features=256, max_imu_per_interval=M_PAD, num_iterations=2,
            acc_n=0.05, gyr_n=0.004, acc_w=4e-5, gyr_w=2e-6, estimate_td=True))


def _frame_input(data, fi):
    f = data.frames[fi]
    t1 = data.cam_ts[fi]
    t0 = data.cam_ts[fi - 1] if fi > 0 else t1 - DT_F
    dt, acc, gyr = sim.imu_between(data, t0, t1)
    k, m = len(f["ids"]), len(dt)

    def pad(a, n, sh):
        out = np.zeros((n,) + sh)
        out[:len(a)] = a
        return t64(out)

    return est.FrameInput(
        ts=torch.tensor(t1, dtype=F64), ids=torch.as_tensor(
            np.pad(f["ids"], (0, K_PAD - k)).astype(np.int32)),
        obs=pad(f["rays"], K_PAD, (3,)), uv=pad(f["uv"], K_PAD, (2,)),
        vel=pad(f["vel"], K_PAD, (2,)), valid=torch.as_tensor(np.arange(K_PAD) < k),
        imu_dt=pad(dt, M_PAD, ()), imu_acc=pad(acc, M_PAD, (3,)),
        imu_gyr=pad(gyr, M_PAD, (3,)), imu_cnt=torch.tensor(m, dtype=torch.int32))


def test_recovers_injected_offset():
    """10 ms injected; ground-truth bootstrap of the window (the solver
    isolated from the initializer); the mean of the last third of the td
    estimates within 4 ms of the truth and the trajectory healthy."""
    cfg = _sim_cfg()
    cam = make_camera(cfg.camera, dtype=F64, device="cpu")
    scfg = sim.SimConfig(duration=3.0, num_landmarks=500, max_features=120,
                         cam_time_offset=TD_TRUE)
    data = sim.simulate(scfg, cam, cfg.camera.r_ic_mat, cfg.camera.t_ic_vec)
    params = est.make_params(cfg, dtype=F64, device="cpu")
    state = est.init_state(cfg, params, F64)
    W = est.W

    def put(a, i, v):
        a = a.clone()
        a[i] = t64(v)
        return a

    for fi in range(W):
        state, _ = est.bookkeeping_step(state, _frame_input(data, fi), params)
        fc = int(state.frame_count)
        w = state.window
        w = w._replace(p=put(w.p, fc, data.gt_p[fi]), q=put(w.q, fc, data.gt_q[fi]),
                       v=put(w.v, fc, data.gt_v[fi]))
        if fi < W - 1:
            w = w._replace(p=put(w.p, fi + 1, w.p[fi]), q=put(w.q, fi + 1, w.q[fi]),
                           v=put(w.v, fi + 1, w.v[fi]))
            state = state._replace(frame_count=torch.tensor(fi + 1, dtype=torch.int32))
        state = state._replace(window=w)

    errs, tds = [], []
    for fi in range(W - 1, min(60, len(data.frames))):
        if fi >= W:
            state, is_kf = est.bookkeeping_step(state, _frame_input(data, fi), params)
        else:
            is_kf = True
        state, p_out, _, diag = est.solve_and_slide(state, bool(is_kf), params,
                                                    cfg.estimator.num_iterations)
        assert bool(diag.state_finite), f"NaN state at frame {fi}"
        errs.append(np.linalg.norm(p_out.numpy() - data.gt_p[fi]))
        tds.append(float(state.td))
    td_final = np.mean(tds[-len(tds) // 3:])
    assert abs(td_final - TD_TRUE) < 0.004, (
        f"td estimate {td_final * 1e3:.2f} ms vs true {TD_TRUE * 1e3:.1f} ms")
    assert np.mean(errs) < 0.06, f"mean drift {np.mean(errs) * 100:.2f} cm"


# ---------------------------------------------------------------------------
# td on every entry point of the port
# ---------------------------------------------------------------------------

def test_td_reaches_the_entry_points(example, tmp_path):
    """With estimate_td on: the YAML switch, ``VIOEngine.process_features``
    (its packed result carries the fused td into ``FrameResult.td``),
    ``make_chunked_step`` and ``ChunkedImageServer``'s step parameters,
    and an engine snapshot, where td and the fusion constants round-trip."""
    from mobile_slam_tpu_torch.engine import checkpoint as ckpt
    from mobile_slam_tpu_torch.engine import chunked
    from mobile_slam_tpu_torch.engine.serving import ChunkedImageServer
    from mobile_slam_tpu_torch.engine.vio_engine import Status, VIOEngine

    cfg, _, _, _ = example
    ps, ts, ti = _port(example)
    n_it = cfg.estimator.num_iterations

    yaml_path = tmp_path / "td.yaml"
    yaml_path.write_text("estimate_td: 1\ntd: 0.004\n")
    ycfg = tconfig.load_config(str(yaml_path))
    assert ycfg.estimator.estimate_td and ycfg.estimator.td_init == 0.004
    assert float(est.make_params(ycfg, dtype=F64, device="cpu").td_enable) == 1.0

    # The engine's tracking frame against solve_and_slide on the same state.
    eng = VIOEngine(cfg, device="cpu", dtype=F64)
    assert float(eng.params.td_enable) == 1.0
    eng.params = ps
    eng.state, eng.status, eng._t0 = ts, Status.TRACKING, 0.0
    book, is_kf = est.bookkeeping_step(ts, ti, ps)
    want, _, _, _ = est.solve_and_slide(book, bool(is_kf), ps, n_it)
    k = int(ti.valid.sum())
    idx = torch.nonzero(ti.valid)[:, 0]
    eng._book_flat = lambda state, flat: est.bookkeeping_step(state, ti, ps)
    res = eng.process_features(float(ti.ts), ti.ids[idx].numpy(), ti.obs[idx].numpy())
    assert res.status == Status.TRACKING and k > 0
    assert abs(res.td - float(want.td)) < 1e-6        # float32 in the packed result
    assert abs(float(eng.state.td) - float(want.td)) < 1e-12

    # The chunk loop is the same step, td included.
    inputs = chunked.stack_frame_inputs([ti, ti._replace(ts=ti.ts + DT_F)])
    st_c, _ = chunked.make_chunked_step(ps, n_it)(ts, inputs)
    st_l = ts
    for t in range(2):
        st_l, kf = est.bookkeeping_step(st_l, chunked._unstack(inputs, t), ps)
        st_l, _, _, _ = est.solve_and_slide(st_l, bool(kf), ps, n_it)
    assert float(st_c.td) == float(st_l.td) and float(st_c.td) != TD0
    server = ChunkedImageServer(cfg, device="cpu", dtype=F64)
    assert float(server.engine.params.td_enable) == 1.0

    # A snapshot carries td and the fusion constants.
    path = str(tmp_path / "td.npz")
    ckpt.save_engine(path, eng)
    fresh = VIOEngine(cfg, device="cpu", dtype=F64)
    ckpt.load_engine(path, fresh)
    assert float(fresh.state.td) == float(eng.state.td)
    for name in ("td_enable", "td_fuse_info", "td_gate_curv"):
        assert float(getattr(fresh.params, name)) == float(getattr(ps, name)), name
