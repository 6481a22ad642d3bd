"""Sliding-window VIO estimator steps (torch twin of
mobile_slam_tpu.engine.estimator).

* ``bookkeeping_step``  — IMU ingestion + feature add + keyframe decision.
* ``solve_and_slide``   — triangulate, optimize, marginalize, slide.
* ``initial_advance_or_slide`` — the INITIAL-phase advance / slide.
* ``apply_initialization`` / ``repropagate_window`` — inject the host init.

The reference's ``lax.cond`` on the keyframe flag takes one of two forms in
``solve_and_slide``: a python ``bool`` is a host branch (the single-stream
engine reads the flag once per frame and runs one branch); a bool tensor
runs both branches and selects per element with ``torch.where``, as
``lax.cond`` does under ``jax.vmap`` (the fleet step, parallel/batch.py,
which has one flag per sequence and no host read). The same choice picks
the form of the solver's step options (solver/lm.py).

With ``estimate_td`` on, ``solve_and_slide`` also moves the camera-IMU time
offset td by the solver's scalar innovation, through the reference's
observability-gated fusion; td then enters the marginalization and the
slide at its fused value. Nothing reads td or its switch on the host.
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import torch

from mobile_slam_tpu_torch.config import NUM_SLOTS, VIOConfig
from mobile_slam_tpu_torch.solver import layout
from mobile_slam_tpu_torch.factors import marginalization
from mobile_slam_tpu_torch.factors.imu_factor import sqrt_info_from_cov
from mobile_slam_tpu_torch.frontend import feature_table as ft
from mobile_slam_tpu_torch.imu import preintegration as pre
from mobile_slam_tpu_torch.models.state import (FeatureTable, WindowState,
                                                eligible_mask,
                                                init_feature_table, init_window)
from mobile_slam_tpu_torch.solver import lm
from mobile_slam_tpu_torch.solver.assembly import (Prior, SolverParams, XState,
                                                   zero_prior)
from mobile_slam_tpu_torch.utils import logging as slog
from mobile_slam_tpu_torch.utils import rotations as rot
from mobile_slam_tpu_torch.utils.linalg import tree_where

W = NUM_SLOTS


class EstimatorState(NamedTuple):
    window: WindowState
    table: FeatureTable
    prior: Prior
    prev_acc: torch.Tensor      # (3,)
    prev_gyr: torch.Tensor      # (3,)
    frame_count: torch.Tensor   # () int32
    first_imu_seen: torch.Tensor  # () bool
    td: torch.Tensor            # ()


class FrameInput(NamedTuple):
    ts: torch.Tensor        # ()
    ids: torch.Tensor       # (K,) int32
    obs: torch.Tensor       # (K, 3)
    uv: torch.Tensor        # (K, 2)
    vel: torch.Tensor       # (K, 2)
    valid: torch.Tensor     # (K,) bool
    imu_dt: torch.Tensor    # (M,)
    imu_acc: torch.Tensor   # (M, 3)
    imu_gyr: torch.Tensor   # (M, 3)
    imu_cnt: torch.Tensor   # () int32


class StepDiag(NamedTuple):
    is_keyframe: torch.Tensor
    culled_ids: torch.Tensor
    last_track_num: torch.Tensor
    solver_cost0: torch.Tensor
    solver_cost: torch.Tensor
    accepted_steps: torch.Tensor
    vel_norm: torch.Tensor
    pos_norm: torch.Tensor
    state_finite: torch.Tensor
    med_depth: torch.Tensor
    td_info: torch.Tensor   # the window's td information (0 with td off)
    td_gain: torch.Tensor   # the gated-fusion gain applied this step


class StaticParams(NamedTuple):
    gravity: torch.Tensor
    ex_t: torch.Tensor
    ex_q: torch.Tensor
    sqrt_info_proj: torch.Tensor
    cauchy_scale: torch.Tensor
    init_depth: torch.Tensor
    min_parallax_norm: torch.Tensor
    noise: torch.Tensor
    td_enable: torch.Tensor
    td_max: torch.Tensor
    td_forget: torch.Tensor
    td_fuse_info: torch.Tensor   # gated-fusion information constant C
    td_gate_curv: torch.Tensor   # per-observation curvature knee of the gate
    td_rw_info: torch.Tensor


def make_params(cfg: VIOConfig, dtype=torch.float32, *, device) -> StaticParams:
    cam, est = cfg.camera, cfg.estimator

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    return StaticParams(
        gravity=t(est.gravity), ex_t=t(cam.t_ic_vec),
        ex_q=rot.rot_to_quat(t(cam.r_ic_mat)),
        sqrt_info_proj=t(cam.focal_length / 1.5), cauchy_scale=t(est.cauchy_scale),
        init_depth=t(est.init_depth),
        min_parallax_norm=t(est.min_parallax / cam.focal_length),
        noise=pre.make_noise_cov(est.acc_n, est.gyr_n, est.acc_w, est.gyr_w,
                                 dtype=dtype, device=device),
        td_enable=t(1.0 if est.estimate_td else 0.0), td_max=t(est.td_max),
        td_forget=t(est.td_prior_forget), td_fuse_info=t(est.td_fuse_info),
        td_gate_curv=t(est.td_gate_curv), td_rw_info=t(est.td_rw_info),
    )


def solver_params(p: StaticParams) -> SolverParams:
    return SolverParams(gravity=p.gravity, sqrt_info_proj=p.sqrt_info_proj,
                        cauchy_scale=p.cauchy_scale, init_depth=p.init_depth,
                        td_enable=p.td_enable, td_max=p.td_max,
                        td_rw_info=p.td_rw_info)


def init_state(cfg: VIOConfig, params: StaticParams,
               dtype=torch.float32) -> EstimatorState:
    """clearState() parity, in ``dtype`` on the device of ``params``."""
    dev = params.gravity.device
    td0 = cfg.estimator.td_init
    return EstimatorState(
        window=init_window(cfg.estimator.max_imu_per_interval, dtype=dtype, device=dev),
        table=init_feature_table(cfg.estimator.max_features, dtype=dtype, device=dev),
        prior=zero_prior(params.ex_t, params.ex_q, dtype, td=td0),
        prev_acc=torch.zeros(3, dtype=dtype, device=dev),
        prev_gyr=torch.zeros(3, dtype=dtype, device=dev),
        frame_count=torch.zeros((), dtype=torch.int32, device=dev),
        first_imu_seen=torch.zeros((), dtype=torch.bool, device=dev),
        td=torch.as_tensor(td0, dtype=dtype, device=dev),
    )


def _at(a: torch.Tensor, i) -> torch.Tensor:
    """a[i] for a python int or a 0-dim index tensor; a tensor index stays
    on the device (indexing with a 0-dim tensor would read it on the host)."""
    if isinstance(i, torch.Tensor):
        return a.index_select(0, i.reshape(1))[0]
    return a[i]


def _put(a: torch.Tensor, i, val) -> torch.Tensor:
    """A copy of ``a`` with row ``i`` (python int or 0-dim tensor) set to
    ``val``, without a host read of ``i``."""
    if isinstance(i, torch.Tensor):
        val = torch.as_tensor(val, dtype=a.dtype, device=a.device)
        return a.index_copy(0, i.reshape(1), val.expand(a.shape[1:])[None])
    a = a.clone()
    a[i] = val
    return a


def _row(pre_all: pre.Preintegration, i) -> pre.Preintegration:
    return pre.Preintegration(*[_at(leaf, i) for leaf in pre_all])


def _set_row(pre_all: pre.Preintegration, i, one: pre.Preintegration):
    return pre.Preintegration(*[_put(full, i, val) for full, val in zip(pre_all, one)])


def ingest_imu(state: EstimatorState, inp: FrameInput, params: StaticParams) -> EstimatorState:
    """processIMU + propagateIMUState for the current slot."""
    w = state.window
    fc = torch.clamp(state.frame_count, 0, W - 1).long()
    m = w.imu_dt.shape[1]
    has_any = inp.imu_cnt > 0
    prev_acc = torch.where(state.first_imu_seen, state.prev_acc, inp.imu_acc[0])
    prev_gyr = torch.where(state.first_imu_seen, state.prev_gyr, inp.imu_gyr[0])

    slot_pre = _row(w.pre, fc)
    cnt = _at(w.imu_cnt, fc)
    ba, bg = _at(w.ba, fc), _at(w.bg, fc)
    has_prev = cnt > 0
    fresh = pre.identity_preintegration(ba, bg)
    carry_pre = tree_where(has_prev, slot_pre, fresh)
    acc0 = torch.where(has_prev, _at(w.imu_acc0, fc), prev_acc)
    gyr0 = torch.where(has_prev, _at(w.imu_gyr0, fc), prev_gyr)
    last_idx = torch.clamp(cnt.long() - 1, 0, m - 1)
    stream_acc = torch.where(has_prev, _at(_at(w.imu_acc, fc), last_idx), acc0)
    stream_gyr = torch.where(has_prev, _at(_at(w.imu_gyr, fc), last_idx), gyr0)

    new_pre = pre.continue_preintegration_parallel(
        carry_pre, stream_acc, stream_gyr, inp.imu_dt, inp.imu_acc,
        inp.imu_gyr, inp.imu_cnt, params.noise)
    skip = state.frame_count == 0
    new_pre = tree_where(skip, slot_pre, new_pre)

    ar = torch.arange(m, device=fc.device)
    idx = cnt.long() + ar
    ok = (ar < inp.imu_cnt) & (idx < m) & ~skip
    widx = torch.where(ok, idx, m)

    def append(buf, vals):
        cur = _at(buf, fc)
        row = torch.cat([cur, torch.zeros_like(cur[:1])], dim=0)
        row[widx] = vals
        return _put(buf, fc, row[:m])

    imu_dt = append(w.imu_dt, inp.imu_dt)
    imu_acc = append(w.imu_acc, inp.imu_acc)
    imu_gyr = append(w.imu_gyr, inp.imu_gyr)
    new_cnt = torch.where(skip, cnt, torch.clamp(cnt + inp.imu_cnt, max=m))
    imu_cnt = _put(w.imu_cnt, fc, new_cnt)
    imu_acc0 = _put(w.imu_acc0, fc, acc0)
    imu_gyr0 = _put(w.imu_gyr0, fc, gyr0)

    p_fc, q_fc, v_fc = _at(w.p, fc), _at(w.q, fc), _at(w.v, fc)
    p_new, q_new, v_new, _, _ = pre.propagate_state_parallel(
        p_fc, q_fc, v_fc, ba, bg, prev_acc, prev_gyr,
        inp.imu_dt, inp.imu_acc, inp.imu_gyr, inp.imu_cnt, params.gravity)
    good = (torch.all(torch.isfinite(p_new)) & torch.all(torch.isfinite(q_new))
            & torch.all(torch.isfinite(v_new)) & ~skip)
    p_w = _put(w.p, fc, torch.where(good, p_new, p_fc))
    q_w = _put(w.q, fc, torch.where(good, q_new, q_fc))
    v_w = _put(w.v, fc, torch.where(good, v_new, v_fc))

    last_i = torch.clamp(inp.imu_cnt.long() - 1, 0, m - 1)
    prev_acc = torch.where(has_any, _at(inp.imu_acc, last_i), prev_acc)
    prev_gyr = torch.where(has_any, _at(inp.imu_gyr, last_i), prev_gyr)
    window = w._replace(p=p_w, q=q_w, v=v_w, pre=_set_row(w.pre, fc, new_pre),
                        imu_dt=imu_dt, imu_acc=imu_acc, imu_gyr=imu_gyr,
                        imu_cnt=imu_cnt, imu_acc0=imu_acc0, imu_gyr0=imu_gyr0)
    return state._replace(window=window, prev_acc=prev_acc, prev_gyr=prev_gyr,
                          first_imu_seen=state.first_imu_seen | has_any)


@slog.traced("bookkeeping")
def bookkeeping_step(state: EstimatorState, inp: FrameInput,
                     params: StaticParams):
    """IMU ingestion + feature add + keyframe decision -> (state, is_kf)."""
    state = ingest_imu(state, inp, params)
    fc = torch.clamp(state.frame_count, 0, W - 1).long()
    ts = _put(state.window.ts, fc, inp.ts)
    add = ft.add_and_check_parallax(state.table, inp.ids, inp.obs, inp.uv,
                                    inp.vel, inp.valid, fc,
                                    params.min_parallax_norm)
    return (state._replace(window=state.window._replace(ts=ts), table=add.table),
            add.is_keyframe)


def _shl(a):
    return torch.cat([a[1:], a[-1:]], dim=0)


def _slide_window_old(w: WindowState, prev_acc, prev_gyr) -> WindowState:
    """Shift left; open a fresh interval at slot W-1."""
    new = WindowState(*[_shl(a) if not isinstance(a, pre.Preintegration)
                        else pre.Preintegration(*[_shl(x) for x in a]) for a in w])
    fresh = pre.identity_preintegration(new.ba[W - 1], new.bg[W - 1])
    imu_dt, imu_acc, imu_gyr = new.imu_dt.clone(), new.imu_acc.clone(), new.imu_gyr.clone()
    imu_cnt, imu_acc0, imu_gyr0 = new.imu_cnt.clone(), new.imu_acc0.clone(), new.imu_gyr0.clone()
    imu_dt[W - 1] = 0.0
    imu_acc[W - 1] = 0.0
    imu_gyr[W - 1] = 0.0
    imu_cnt[W - 1].zero_()
    imu_acc0[W - 1] = prev_acc
    imu_gyr0[W - 1] = prev_gyr
    return new._replace(pre=_set_row(new.pre, W - 1, fresh), imu_dt=imu_dt,
                        imu_acc=imu_acc, imu_gyr=imu_gyr, imu_cnt=imu_cnt,
                        imu_acc0=imu_acc0, imu_gyr0=imu_gyr0)


def _slide_window_new(w: WindowState, prev_acc, prev_gyr, noise) -> WindowState:
    """Merge the newest general frame into the previous interval."""
    m = w.imu_dt.shape[1]
    pre9 = _row(w.pre, W - 2)
    cnt9 = w.imu_cnt[W - 2].long()
    last9 = torch.clamp(cnt9 - 1, 0, m - 1)
    stream_acc = torch.where(cnt9 > 0, w.imu_acc[W - 2, last9], w.imu_acc0[W - 2])
    stream_gyr = torch.where(cnt9 > 0, w.imu_gyr[W - 2, last9], w.imu_gyr0[W - 2])
    merged = pre.continue_preintegration_parallel(
        pre9, stream_acc, stream_gyr, w.imu_dt[W - 1], w.imu_acc[W - 1],
        w.imu_gyr[W - 1], w.imu_cnt[W - 1], noise)
    ar = torch.arange(m, device=cnt9.device)
    idx = cnt9 + ar
    ok = (ar < w.imu_cnt[W - 1]) & (idx < m)
    widx = torch.where(ok, idx, m)

    def merge(buf):
        row = torch.cat([buf[W - 2], torch.zeros_like(buf[W - 2][:1])], dim=0)
        row[widx] = buf[W - 1]
        out = buf.clone()
        out[W - 2] = row[:m]
        out[W - 1] = 0.0
        return out

    def move(a):
        a = a.clone()
        a[W - 2] = a[W - 1]
        return a

    imu_cnt = w.imu_cnt.clone()
    imu_cnt[W - 2] = torch.clamp(cnt9 + w.imu_cnt[W - 1], max=m).to(torch.int32)
    imu_cnt[W - 1].zero_()
    imu_acc0, imu_gyr0 = w.imu_acc0.clone(), w.imu_gyr0.clone()
    imu_acc0[W - 1] = prev_acc
    imu_gyr0[W - 1] = prev_gyr
    new = w._replace(ts=move(w.ts), p=move(w.p), q=move(w.q), v=move(w.v),
                     ba=move(w.ba), bg=move(w.bg),
                     pre=_set_row(w.pre, W - 2, merged),
                     imu_dt=merge(w.imu_dt), imu_acc=merge(w.imu_acc),
                     imu_gyr=merge(w.imu_gyr), imu_cnt=imu_cnt,
                     imu_acc0=imu_acc0, imu_gyr0=imu_gyr0)
    fresh = pre.identity_preintegration(new.ba[W - 1], new.bg[W - 1])
    return new._replace(pre=_set_row(new.pre, W - 1, fresh))


def _cam_pose(p, q, ex_t, ex_q):
    r_wb = rot.quat_to_rot(q)
    return r_wb @ rot.quat_to_rot(ex_q), p + r_wb @ ex_t


def _fuse_td(td, res: lm.SolveResult, params: StaticParams):
    """Observability-gated td fusion -> (fused td, gain). The window's td
    information I_w moves td by the gain I_w / (I_w + C), times an
    excitation gate s^2 / (1 + s^2) on the mean per-observation curvature
    (s = I_w / sum_w / knee): under locally constant velocity the time
    shift is indistinguishable from along-track pose drift, and the gate
    holds td there. Clamped to +-td_max; td unchanged when it is off."""
    i_w = torch.clamp(res.td_info, min=0.0)
    curv = i_w / torch.clamp(res.td_wsum, min=1.0)
    sgate = curv / torch.clamp(params.td_gate_curv, min=1e-6)
    gate = sgate * sgate / (1.0 + sgate * sgate)
    denom = i_w + params.td_fuse_info
    gain = gate * torch.where(denom > 0, i_w / torch.where(denom > 0, denom, 1.0),
                              torch.zeros_like(i_w))
    fused = torch.where(params.td_enable > 0,
                        torch.clamp(td + gain * res.td_innov, -params.td_max,
                                    params.td_max), td)
    return fused, gain


def _one_thread_at_a_time(fn):
    """torch.func's forward mode (``jacfwd``, ``jvp``: the solver's
    Jacobians) keeps its levels process-wide, so two threads inside it at
    once corrupt each other's ("a forward AD level with an invalid index").
    The gateway serves each session in a thread, and the solve is the
    engine's only forward-mode stage: it runs in one thread at a time."""
    lock = threading.Lock()

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with lock:
            return fn(*args, **kwargs)
    return inner


@slog.traced("solve")
@_one_thread_at_a_time
def solve_and_slide(state: EstimatorState, is_kf, params: StaticParams,
                    num_iterations: int):
    """Triangulate, optimize, marginalize, slide. Returns (state, body_p,
    body_q, diag); the pose is the newest window frame. ``is_kf`` a python
    bool picks the keyframe branch on the host; a () bool tensor computes
    both branches and selects on the device (module docstring)."""
    on_device = isinstance(is_kf, torch.Tensor)
    w = state.window
    with slog.span("triangulate"):
        table = ft.triangulate(state.table, w.p, w.q, params.ex_t, params.ex_q,
                               params.init_depth, td=state.td)
    sp = solver_params(params)
    with slog.span("optimize") as span:
        w, table, res, culled_ids = lm.optimize(w, table, state.prior, params.ex_t,
                                                params.ex_q, sp, num_iterations,
                                                td0=state.td, host_branch=not on_device)
        span.attrs["graph"] = lm.last_form()
    td, gain = _fuse_td(state.td, res, params)
    x_post = XState(p=w.p, q=w.q, v=w.v, ba=w.ba, bg=w.bg, lam=res.x.lam, td=td)

    def margin_old():
        return marginalization.marginalize_old(
            x_post, table, w, sqrt_info_from_cov(w.pre.cov[1:]), state.prior,
            params.ex_t, params.ex_q, sp)

    def margin_new():
        return marginalization.marginalize_new(x_post, state.prior,
                                               params.ex_t, params.ex_q)

    r0_wc, t0_wc = _cam_pose(w.p[0], w.q[0], params.ex_t, params.ex_q)
    r1_wc, t1_wc = _cam_pose(w.p[1], w.q[1], params.ex_t, params.ex_q)

    def slide_old():
        return (_slide_window_old(w, state.prev_acc, state.prev_gyr),
                ft.slide_old(table, True, r0_wc, t0_wc, r1_wc, t1_wc,
                             params.init_depth, td=td))

    def slide_new():
        return (_slide_window_new(w, state.prev_acc, state.prev_gyr, params.noise),
                ft.slide_new(table))

    with slog.span("marginalize"):
        if on_device:
            prior = tree_where(is_kf, margin_old(), margin_new())
        else:
            prior = margin_old() if is_kf else margin_new()
    with slog.span("slide"):
        if on_device:
            (w_old, t_old), (w_new, t_new) = slide_old(), slide_new()
            w2, table2 = tree_where(is_kf, w_old, w_new), tree_where(is_kf, t_old, t_new)
        else:
            w2, table2 = slide_old() if is_kf else slide_new()
    # No-op with td disabled (its prior column is identically zero).
    J0 = prior.J0.clone()
    J0[:, layout.TD_COL] = J0[:, layout.TD_COL] * params.td_forget
    prior = prior._replace(J0=J0)
    table2 = ft.remove_failures(table2)

    solved = (table.fid >= 0) & (table.solve_flag == 1) & (table.depth > 0)
    dep_sorted, _ = torch.sort(torch.where(solved, table.depth,
                                           torch.full_like(table.depth, float("inf"))))
    n_solved = torch.sum(solved)
    med_depth = torch.where(
        n_solved > 0,
        _at(dep_sorted, torch.clamp(torch.div(n_solved, 2, rounding_mode="floor"), 0,
                                    table.depth.shape[0] - 1)),
        torch.zeros_like(dep_sorted[0]))

    fc_cur = torch.clamp(state.frame_count, 0, W - 1).long()
    cur_mask = state.table.mask.index_select(1, fc_cur.reshape(1))[:, 0]
    n_tracked = torch.sum((state.table.fid >= 0) & cur_mask
                          & (state.table.used_num >= 2)).to(torch.int32)
    diag = StepDiag(
        is_keyframe=(is_kf if on_device
                     else torch.full((), is_kf, dtype=torch.bool, device=w.p.device)),
        culled_ids=culled_ids, last_track_num=n_tracked,
        solver_cost0=res.cost0, solver_cost=res.cost,
        accepted_steps=res.accepted,
        vel_norm=torch.linalg.vector_norm(w.v[W - 1]),
        pos_norm=torch.linalg.vector_norm(w.p[W - 1]),
        state_finite=(torch.all(torch.isfinite(w.p)) & torch.all(torch.isfinite(w.v))
                      & torch.all(torch.isfinite(w.q))),
        med_depth=med_depth,
        td_info=res.td_info,
        td_gain=gain * params.td_enable,
    )
    new_state = state._replace(window=w2, table=table2, prior=prior, td=td)
    return new_state, w.p[W - 1], w.q[W - 1], diag


def repropagate_window(window: WindowState, ba, bg, noise) -> WindowState:
    """Re-run every slot's preintegration with new linearization biases."""
    n = window.imu_acc0.shape[0]
    new_pre = pre.preintegrate_parallel(
        window.imu_acc0, window.imu_gyr0, window.imu_dt, window.imu_acc,
        window.imu_gyr, window.imu_cnt, ba.expand(n, 3), bg.expand(n, 3), noise)
    return window._replace(pre=new_pre)


def apply_initialization(state: EstimatorState, p_cam, q_body, v_world, bg,
                         gravity_l, scale, params: StaticParams):
    """Write the SfM/VI-alignment solution into the window and landmark
    bank, then rotate into the gravity-aligned, yaw-zeroed world frame.
    Returns (state, world gravity)."""
    dtype, dev = state.window.p.dtype, state.window.p.device
    w = state.window._replace(p=p_cam.to(dtype), q=q_body.to(dtype),
                              ba=torch.zeros((W, 3), dtype=dtype, device=dev),
                              bg=bg.to(dtype).repeat(W, 1))
    table = state.table
    used = table.fid >= 0
    table = table._replace(
        depth=torch.where(used, torch.full_like(table.depth, -1.0), table.depth),
        solve_flag=torch.where(used, torch.zeros_like(table.solve_flag), table.solve_flag))
    zero3 = torch.zeros(3, dtype=dtype, device=dev)
    table = ft.triangulate(table, w.p, w.q, zero3, params.ex_q, params.init_depth)
    w = repropagate_window(w, zero3, bg.to(dtype), params.noise)

    r_wb = rot.quat_to_rot(w.q)
    p_metric = scale * w.p - torch.einsum("wij,j->wi", r_wb, params.ex_t)
    p_metric = p_metric - p_metric[0:1]
    w = w._replace(p=p_metric.to(dtype), v=v_world.to(dtype))
    elig = eligible_mask(table)
    table = table._replace(depth=torch.where(elig, table.depth * scale, table.depth))

    g_l = gravity_l.to(dtype)
    r0 = rot.g2r(g_l)
    yaw = rot.r2ypr(r0 @ rot.quat_to_rot(w.q[0]))[0]
    zero = torch.zeros_like(yaw)
    r0 = rot.ypr2r(torch.stack([-yaw, zero, zero])) @ r0
    g_world = r0 @ g_l
    q_r0 = rot.rot_to_quat(r0)
    w = w._replace(p=w.p @ r0.T,
                   q=rot.quat_normalize(rot.quat_mul(q_r0[None, :], w.q)),
                   v=w.v @ r0.T)
    return state._replace(window=w, table=table), g_world


def initial_advance_or_slide(state: EstimatorState, is_kf: bool,
                             params: StaticParams) -> EstimatorState:
    """Advance frame_count while the window fills; once full (init attempt
    failed), slide by parallax without marginalization."""
    w = state.window
    fc = int(state.frame_count)
    if fc < W - 1:
        nfc = fc + 1

        def seed(a):
            a = a.clone()
            a[nfc] = a[fc]
            return a

        w2 = w._replace(p=seed(w.p), q=seed(w.q), v=seed(w.v), ba=seed(w.ba),
                        bg=seed(w.bg))
        return state._replace(window=w2, frame_count=state.frame_count + 1)
    if bool(is_kf):
        r0_wc, t0_wc = _cam_pose(w.p[0], w.q[0], params.ex_t, params.ex_q)
        r1_wc, t1_wc = _cam_pose(w.p[1], w.q[1], params.ex_t, params.ex_q)
        w2 = _slide_window_old(w, state.prev_acc, state.prev_gyr)
        t2 = ft.slide_old(state.table, False, r0_wc, t0_wc, r1_wc, t1_wc,
                          params.init_depth, td=state.td)
    else:
        w2 = _slide_window_new(w, state.prev_acc, state.prev_gyr, params.noise)
        t2 = ft.slide_new(state.table)
    return state._replace(window=w2, table=t2)
