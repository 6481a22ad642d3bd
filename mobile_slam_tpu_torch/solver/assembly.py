"""Residual/Jacobian assembly for the sliding-window problem (torch twin of
mobile_slam_tpu.solver.assembly).

Jacobians are forward-mode derivatives of each residual with respect to its
manifold perturbation (``torch.func.jacfwd`` under ``torch.func.vmap`` over
the 10 IMU factors and the flattened (F x 11) projection grid); the normal
equations are einsums. The tangent layout comes from ``solver/layout.py``
(the port's copy of the reference's).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, jvp, vmap

from mobile_slam_tpu_torch.config import NUM_SLOTS
from mobile_slam_tpu_torch.solver import layout
from mobile_slam_tpu_torch.factors import imu_factor, projection
from mobile_slam_tpu_torch.imu.preintegration import Preintegration
from mobile_slam_tpu_torch.models.state import FeatureTable, eligible_mask
from mobile_slam_tpu_torch.utils import rotations as rot

W = NUM_SLOTS
S = layout.S
TD_JOINT_GATE = 0.0
_PROJ_COLS = np.concatenate([np.arange(layout.POSE_COLS), np.arange(layout.TD_COL, S)])
_IMU_EMBED = layout.imu_embed_matrices(np.float64)


@functools.lru_cache(maxsize=None)
def _constants(dtype: torch.dtype, device: torch.device):
    """(_IMU_EMBED, _PROJ_COLS) on ``device``, copied there once."""
    return (torch.as_tensor(_IMU_EMBED, dtype=dtype, device=device),
            torch.as_tensor(_PROJ_COLS, device=device))


class SolverParams(NamedTuple):
    gravity: torch.Tensor
    sqrt_info_proj: torch.Tensor
    cauchy_scale: torch.Tensor
    init_depth: torch.Tensor
    td_enable: torch.Tensor
    td_max: torch.Tensor
    td_rw_info: torch.Tensor


class XState(NamedTuple):
    p: torch.Tensor    # (11, 3)
    q: torch.Tensor    # (11, 4)
    v: torch.Tensor    # (11, 3)
    ba: torch.Tensor   # (11, 3)
    bg: torch.Tensor   # (11, 3)
    lam: torch.Tensor  # (F,) inverse depths
    td: torch.Tensor   # ()


class Prior(NamedTuple):
    """Linearized marginalization prior r(x) = r0 + J0 (x ⊟ x0)."""
    J0: torch.Tensor
    r0: torch.Tensor
    p0: torch.Tensor
    q0: torch.Tensor
    v0: torch.Tensor
    ba0: torch.Tensor
    bg0: torch.Tensor
    ex_t0: torch.Tensor
    ex_q0: torch.Tensor
    td0: torch.Tensor


def zero_prior(ex_t, ex_q, dtype=torch.float32, td=0.0) -> Prior:
    kw = dict(dtype=dtype, device=ex_t.device)
    return Prior(
        J0=torch.zeros((S, S), **kw), r0=torch.zeros((S,), **kw),
        p0=torch.zeros((W, 3), **kw),
        q0=torch.tensor([1.0, 0.0, 0.0, 0.0], **kw).repeat(W, 1),
        v0=torch.zeros((W, 3), **kw), ba0=torch.zeros((W, 3), **kw),
        bg0=torch.zeros((W, 3), **kw), ex_t0=ex_t.to(dtype, copy=True),
        ex_q0=ex_q.to(dtype, copy=True),
        td0=torch.as_tensor(td, **kw).clone(),
    )


def prior_dx(prior: Prior, x: XState, ex_t, ex_q) -> torch.Tensor:
    """Full-state tangent difference x ⊟ x0, shape (S,)."""
    dpose = torch.cat([x.p - prior.p0, rot.quat_boxminus(x.q, prior.q0)], dim=-1).reshape(-1)
    dsb = torch.cat([x.v - prior.v0, x.ba - prior.ba0, x.bg - prior.bg0], dim=-1).reshape(-1)
    dtd = (x.td - prior.td0).reshape(1)
    dex = torch.cat([ex_t - prior.ex_t0, rot.quat_boxminus(ex_q, prior.ex_q0)], dim=-1)
    return torch.cat([dpose, dsb, dtd, dex])


def _with_aux(f):
    def g(d):
        r = f(d)
        return r, r
    return g


def _imu_residual_pert(delta, pre, x_i, x_j, sqrt_info, gravity):
    p_i = x_i[0] + delta[0:3]
    q_i = rot.quat_boxplus(x_i[1], delta[3:6])
    v_i = x_i[2] + delta[6:9]
    ba_i = x_i[3] + delta[9:12]
    bg_i = x_i[4] + delta[12:15]
    p_j = x_j[0] + delta[15:18]
    q_j = rot.quat_boxplus(x_j[1], delta[18:21])
    v_j = x_j[2] + delta[21:24]
    ba_j = x_j[3] + delta[24:27]
    bg_j = x_j[4] + delta[27:30]
    return imu_factor.whitened_residual(pre, p_i, q_i, v_i, ba_i, bg_i, p_j,
                                        q_j, v_j, ba_j, bg_j, gravity, sqrt_info)


def _interval_inputs(x: XState, pre: Preintegration):
    pre_j = Preintegration(*[leaf[1:] for leaf in pre])
    x_i = (x.p[:-1], x.q[:-1], x.v[:-1], x.ba[:-1], x.bg[:-1])
    x_j = (x.p[1:], x.q[1:], x.v[1:], x.ba[1:], x.bg[1:])
    return pre_j, x_i, x_j


def imu_res_jac(x: XState, pre: Preintegration, imu_sqrt_info, gravity):
    """Residuals (10, 15) and Jacobians (10, 15, 30)."""
    pre_j, x_i, x_j = _interval_inputs(x, pre)
    zero = x.p.new_zeros(30)

    def one(pre_leaf, xi, xj, si):
        f = _with_aux(lambda d: _imu_residual_pert(d, pre_leaf, xi, xj, si, gravity))
        jac, r = jacfwd(f, has_aux=True)(zero)
        return r, jac

    return vmap(one)(pre_j, x_i, x_j, imu_sqrt_info)


def _proj_residual_pert(delta, ray_a, ray_j, lam_f, p_a, q_a, p_t, q_t, ex_t,
                        ex_q, sqrt_info, vel_a, vel_j, td0, td_enable):
    """Projection residual vs [δpose_a(6), δpose_t(6), δex(6), δλ, δtd]."""
    p_i = p_a + delta[0:3]
    q_i = rot.quat_boxplus(q_a, delta[3:6])
    p_j = p_t + delta[6:9]
    q_j = rot.quat_boxplus(q_t, delta[9:12])
    t_ic = ex_t + delta[12:15]
    q_ic = rot.quat_boxplus(ex_q, delta[15:18])
    lam = lam_f + delta[18]
    td = td0 + td_enable * TD_JOINT_GATE * delta[19]
    return projection.residual(ray_a, ray_j, lam, p_i, q_i, p_j, q_j, t_ic,
                               q_ic, sqrt_info, vel_i=vel_a, vel_j=vel_j, td=td)


def _anchor(table: FeatureTable):
    start = torch.clamp(table.start, 0, W - 1).long()
    ar = torch.arange(table.obs.shape[0], device=start.device)
    return start, table.obs[ar, start], table.vel[ar, start]


def proj_res_jac(x: XState, table: FeatureTable, ex_t, ex_q, sqrt_info, td_enable):
    """Residuals (F, W, 2) and Jacobians (F, W, 2, 20) over the grid."""
    F = table.fid.shape[0]
    start, ray_a, vel_a = _anchor(table)
    n = F * W

    def grid(a):                      # per-feature (F, ...) -> (F*W, ...)
        return a[:, None].expand((F, W) + a.shape[1:]).reshape((n,) + a.shape[1:])

    def frames(a):                    # per-frame (W, ...) -> (F*W, ...)
        return a[None].expand((F, W) + a.shape[1:]).reshape((n,) + a.shape[1:])

    zero = x.p.new_zeros(20)

    def one(ra, rj, lam, pa, qa, pt, qt, va, vj):
        f = _with_aux(lambda d: _proj_residual_pert(
            d, ra, rj, lam, pa, qa, pt, qt, ex_t, ex_q, sqrt_info, va, vj,
            x.td, td_enable))
        jac, r = jacfwd(f, has_aux=True)(zero)
        return r, jac

    r, J = vmap(one)(grid(ray_a), table.obs.reshape(n, 3), grid(x.lam),
                     grid(x.p[start]), grid(x.q[start]), frames(x.p),
                     frames(x.q), grid(vel_a), table.vel.reshape(n, 2))
    return r.reshape(F, W, 2), J.reshape(F, W, 2, 20)


def proj_valid_mask(table: FeatureTable) -> torch.Tensor:
    """(F, W): eligible feature, observed frame, not the anchor itself."""
    elig = eligible_mask(table)
    j_idx = torch.arange(W, device=table.start.device)[None, :]
    return table.mask & elig[:, None] & (j_idx != table.start[:, None])


class NormalEqs(NamedTuple):
    H_ss: torch.Tensor   # (S, S)
    g_s: torch.Tensor    # (S,)
    H_sl: torch.Tensor   # (S, F)
    H_ll: torch.Tensor   # (F,)
    g_l: torch.Tensor    # (F,)
    cost: torch.Tensor   # ()


def _all_residuals(x: XState, table: FeatureTable, ex_t, ex_q, params):
    start, ray_a, vel_a = _anchor(table)
    return projection.residual(
        ray_a[:, None, :], table.obs, x.lam[:, None],
        x.p[start][:, None, :], x.q[start][:, None, :],
        x.p[None, :, :], x.q[None, :, :], ex_t, ex_q, params.sqrt_info_proj,
        vel_i=vel_a[:, None, :], vel_j=table.vel, td=x.td)


def build_normal_eqs(x: XState, table: FeatureTable, pre: Preintegration,
                     imu_sqrt_info, imu_valid, prior: Prior, prior_H0, ex_t,
                     ex_q, params: SolverParams, proj_valid, use_prior=True,
                     include_td_rw: bool = True) -> NormalEqs:
    dtype, dev = x.p.dtype, x.p.device
    F = table.fid.shape[0]

    r_imu, J_imu = imu_res_jac(x, pre, imu_sqrt_info, params.gravity)
    w_imu = imu_valid.to(dtype)[:, None]
    r_imu_w = r_imu * w_imu
    E, cols = _constants(dtype, dev)
    J_imu_s = torch.einsum("aru,aus->ars", J_imu, E) * w_imu[..., None]
    H_imu = torch.einsum("ari,arj->ij", J_imu_s, J_imu_s)
    g_imu = torch.einsum("ari,ar->i", J_imu_s, r_imu_w)
    cost_imu = 0.5 * torch.sum(r_imu_w * r_imu_w)

    r_p, J_p = proj_res_jac(x, table, ex_t, ex_q, params.sqrt_info_proj,
                            params.td_enable)
    w_cauchy = projection.cauchy_weight(r_p, params.cauchy_scale)
    wv = (proj_valid.to(dtype) * w_cauchy)[..., None]
    r_pw = r_p * wv
    J_a, J_t, J_ex, J_l, J_td = (J_p[..., 0:6], J_p[..., 6:12], J_p[..., 12:18],
                                 J_p[..., 18], J_p[..., 19:20])
    oh_a = torch.nn.functional.one_hot(table.start.long(), W).to(dtype)
    eye_w = torch.eye(W, dtype=dtype, device=dev)
    J_pose = (J_a[:, :, :, None, :] * oh_a[:, None, None, :, None]
              + J_t[:, :, :, None, :] * eye_w[None, :, None, :, None])
    J72 = torch.cat([J_pose.reshape(F, W, 2, layout.POSE_COLS), J_td, J_ex],
                    dim=-1) * wv[..., None]
    J_lw = J_l * wv

    H72 = torch.einsum("fwri,fwrj->ij", J72, J72)
    g72 = torch.einsum("fwri,fwr->i", J72, r_pw)
    H_sl72 = torch.einsum("fwri,fwr->if", J72, J_lw)
    H_ll = torch.einsum("fwr,fwr->f", J_lw, J_lw)
    g_l = torch.einsum("fwr,fwr->f", J_lw, r_pw)
    s_proj = torch.sum(r_p * r_p, dim=-1)
    c2 = params.cauchy_scale * params.cauchy_scale
    cost_proj = 0.5 * torch.sum(c2 * torch.log1p(s_proj / c2) * proj_valid.to(dtype))

    H_ss = H_imu.clone()
    H_ss[cols[:, None], cols[None, :]] += H72
    g_s = g_imu.clone()
    g_s[cols] += g72
    H_sl = torch.zeros((S, F), dtype=dtype, device=dev).index_put((cols,), H_sl72)

    dx0 = prior_dx(prior, x, ex_t, ex_q)
    r_prior = prior.r0 + prior.J0 @ dx0
    on = 1.0 if use_prior else 0.0
    H_ss = H_ss + on * prior_H0
    g_s = g_s + on * (prior.J0.T @ r_prior)
    cost_prior = 0.5 * on * torch.sum(r_prior * r_prior)

    w_rw = params.td_rw_info * params.td_enable * (1.0 if include_td_rw else 0.0)
    tdc = layout.TD_COL
    r_td = x.td - prior.td0
    H_ss[tdc, tdc] += w_rw
    g_s[tdc] += w_rw * r_td
    cost_td = 0.5 * w_rw * r_td * r_td
    return NormalEqs(H_ss=H_ss, g_s=g_s, H_sl=H_sl, H_ll=H_ll, g_l=g_l,
                     cost=cost_imu + cost_proj + cost_prior + cost_td)


def td_grad_hess(x: XState, table: FeatureTable, ex_t, ex_q,
                 params: SolverParams, proj_valid):
    """Gradient and Gauss-Newton curvature of the Cauchy-weighted projection
    cost with respect to td alone, everything else held at ``x``: (g, h,
    sum of the weights). The residual's derivative in td is a forward-mode
    product (``torch.func.jvp``), so the function runs under ``vmap``."""
    def res_of_td(td):
        return _all_residuals(x._replace(td=td), table, ex_t, ex_q, params)

    r, dr = jvp(res_of_td, (x.td,), (torch.ones_like(x.td),))
    w = projection.cauchy_weight(r, params.cauchy_scale) * proj_valid.to(x.p.dtype)
    g = torch.sum(w * torch.sum(r * dr, dim=-1))
    h = torch.sum(w * torch.sum(dr * dr, dim=-1))
    return g, h, torch.sum(w)


def total_cost(x: XState, table: FeatureTable, pre: Preintegration,
               imu_sqrt_info, imu_valid, prior: Prior, ex_t, ex_q,
               params: SolverParams, proj_valid) -> torch.Tensor:
    """Robustified cost only, for LM accept/reject."""
    dtype = x.p.dtype
    pre_j, x_i, x_j = _interval_inputs(x, pre)
    r_imu = _imu_residual_pert(x.p.new_zeros(30), pre_j, x_i, x_j,
                               imu_sqrt_info, params.gravity)
    cost_imu = 0.5 * torch.sum((r_imu * imu_valid.to(dtype)[:, None]) ** 2)
    r_p = _all_residuals(x, table, ex_t, ex_q, params)
    s = torch.sum(r_p * r_p, dim=-1)
    c2 = params.cauchy_scale * params.cauchy_scale
    cost_proj = 0.5 * torch.sum(c2 * torch.log1p(s / c2) * proj_valid.to(dtype))
    r_prior = prior.r0 + prior.J0 @ prior_dx(prior, x, ex_t, ex_q)
    cost_prior = 0.5 * torch.sum(r_prior * r_prior)
    r_td = x.td - prior.td0
    cost_td = 0.5 * params.td_rw_info * params.td_enable * r_td * r_td
    return cost_imu + cost_proj + cost_prior + cost_td
