"""IMU preintegration (torch twin of mobile_slam_tpu.imu.preintegration).

Midpoint integration of (Δp, Δq, Δv), the 15x15 bias Jacobian and the 15x15
covariance through the 18x18 noise model (IntegrationBase).
``preintegrate`` / ``propagate_state`` are the reference's sequential scans
as Python loops over one interval's samples. The reference's
parallel-prefix form is kept — per-step quantities batched over the M
samples — with its two ``lax.associative_scan``s (the rotation chain and the
(F, W) affine composition) written as sequential loops over the at most
``max_imu_per_interval`` samples. The parallel forms take leading batch
dims (window slots): dt (..., M), acc/gyr (..., M, 3), count (...).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mobile_slam_tpu_torch.config import O_BA, O_BG, O_P, O_R, O_V
from mobile_slam_tpu_torch.utils import rotations as rot


class Preintegration(NamedTuple):
    dp: torch.Tensor      # (..., 3)
    dq: torch.Tensor      # (..., 4)
    dv: torch.Tensor      # (..., 3)
    jac: torch.Tensor     # (..., 15, 15)
    cov: torch.Tensor     # (..., 15, 15)
    sum_dt: torch.Tensor  # (...,)
    lin_ba: torch.Tensor  # (..., 3)
    lin_bg: torch.Tensor  # (..., 3)


def make_noise_cov(acc_n: float, gyr_n: float, acc_w: float, gyr_w: float,
                   dtype=torch.float32, *, device) -> torch.Tensor:
    """18x18 diagonal noise covariance."""
    d = ([acc_n * acc_n] * 3 + [gyr_n * gyr_n] * 3 + [acc_n * acc_n] * 3
         + [gyr_n * gyr_n] * 3 + [acc_w * acc_w] * 3 + [gyr_w * gyr_w] * 3)
    return torch.diag(torch.tensor(d, dtype=dtype, device=device))


def _identity_quat(like: torch.Tensor) -> torch.Tensor:
    """(1, 0, 0, 0) in ``like``'s dtype, made on its device (no host copy)."""
    return torch.eye(1, 4, dtype=like.dtype, device=like.device)[0]


def identity_preintegration(ba: torch.Tensor, bg: torch.Tensor) -> Preintegration:
    """Empty interval(s) with the given linearization biases (..., 3)."""
    batch = ba.shape[:-1]
    kw = dict(dtype=ba.dtype, device=ba.device)
    return Preintegration(
        dp=torch.zeros(batch + (3,), **kw),
        dq=_identity_quat(ba).expand(batch + (4,)).clone(),
        dv=torch.zeros(batch + (3,), **kw),
        jac=torch.eye(15, **kw).expand(batch + (15, 15)).clone(),
        cov=torch.zeros(batch + (15, 15), **kw),
        sum_dt=torch.zeros(batch, **kw),
        lin_ba=ba, lin_bg=bg,
    )


def _midpoint_step(carry, dt, acc_1, gyr_1, active, lin_ba, lin_bg, noise):
    """One midpoint-integration step of one interval (IntegrationBase::
    midPointIntegration); an inactive sample leaves the carry as it is."""
    dp, dq, dv, jac, cov, sum_dt, acc_0, gyr_0 = carry
    un_acc_0 = rot.quat_rotate(dq, acc_0 - lin_ba)
    un_gyr = 0.5 * (gyr_0 + gyr_1) - lin_bg
    r_dq = rot.quat_mul(dq, rot.delta_q(un_gyr * dt))
    un_acc_1 = rot.quat_rotate(r_dq, acc_1 - lin_ba)
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    r_dp = dp + dv * dt + 0.5 * un_acc * dt * dt
    r_dv = dv + un_acc * dt

    r_w = rot.skew(un_gyr)
    r_a0 = rot.skew(acc_0 - lin_ba)
    r_a1 = rot.skew(acc_1 - lin_ba)
    R0 = rot.quat_to_rot(dq)
    R1 = rot.quat_to_rot(r_dq)
    eye3 = torch.eye(3, dtype=dp.dtype, device=dp.device)
    dt2 = dt * dt
    I_left = eye3 - r_w * dt
    R1_ra1 = R1 @ r_a1
    Z = None    # a zero block
    Fm = _block_matrix((3, 3), [     # block rows and columns P, R, V, BA, BG
        [eye3, -0.25 * R0 @ r_a0 * dt2 - 0.25 * R1_ra1 @ I_left * dt2, eye3 * dt,
         -0.25 * (R0 + R1) * dt2, 0.25 * R1_ra1 * dt2 * dt],
        [Z, I_left, Z, Z, -eye3 * dt],
        [Z, -0.5 * R0 @ r_a0 * dt - 0.5 * R1_ra1 @ I_left * dt, eye3,
         -0.5 * (R0 + R1) * dt, 0.5 * R1_ra1 * dt * dt],
        [Z, Z, Z, eye3, Z],
        [Z, Z, Z, Z, eye3]])
    v03 = -0.125 * R1_ra1 * dt2 * dt
    v63 = -0.25 * R1_ra1 * dt * dt
    V = _block_matrix((3, 3), [      # noise columns a0, g0, a1, g1, ba, bg
        [0.25 * R0 * dt2, v03, 0.25 * R1 * dt2, v03, Z, Z],
        [Z, 0.5 * eye3 * dt, Z, 0.5 * eye3 * dt, Z, Z],
        [0.5 * R0 * dt, v63, 0.5 * R1 * dt, v63, Z, Z],
        [Z, Z, Z, Z, eye3 * dt, Z],
        [Z, Z, Z, Z, Z, eye3 * dt]])
    new = (r_dp, rot.quat_normalize(r_dq), r_dv, Fm @ jac,
           Fm @ cov @ Fm.T + V @ noise @ V.T, sum_dt + dt, acc_1, gyr_1)
    return tuple(torch.where(active, n, o) for n, o in zip(new, carry))


def preintegrate(acc0, gyr0, dt, acc, gyr, count, lin_ba, lin_bg,
                 noise) -> Preintegration:
    """Preintegrate one interval sample by sample (the reference's
    sequential scan; ``preintegrate_parallel`` is the batched form):
    IntegrationBase(acc0, gyr0, ba, bg) then push_back of the ``count``
    valid readings of dt (M,), acc / gyr (M, 3)."""
    kw = dict(dtype=acc0.dtype, device=acc0.device)
    count = torch.as_tensor(count, device=acc0.device)
    carry = (torch.zeros(3, **kw), _identity_quat(acc0), torch.zeros(3, **kw),
             torch.eye(15, **kw), torch.zeros((15, 15), **kw),
             torch.zeros((), **kw), acc0, gyr0)
    for i in range(dt.shape[0]):
        carry = _midpoint_step(carry, dt[i], acc[i], gyr[i], i < count,
                               lin_ba, lin_bg, noise)
    dp, dq, dv, jac, cov, sum_dt, _, _ = carry
    return Preintegration(dp, dq, dv, jac, cov, sum_dt, lin_ba, lin_bg)


def _prefix_quat(dq_step: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along the sample axis (..., M, 4)."""
    out = [dq_step[..., 0, :]]
    for i in range(1, dq_step.shape[-2]):
        out.append(rot.quat_mul(out[-1], dq_step[..., i, :]))
    return torch.stack(out, dim=-2)


def _step_quantities(acc0, gyr0, dt, acc, gyr, count, lin_bg):
    m = dt.shape[-1]
    ar = torch.arange(m, device=dt.device)
    active = ar < count[..., None]                            # (..., M)
    acc_prev = torch.cat([acc0[..., None, :], acc[..., :-1, :]], dim=-2)
    gyr_prev = torch.cat([gyr0[..., None, :], gyr[..., :-1, :]], dim=-2)
    un_gyr = 0.5 * (gyr_prev + gyr) - lin_bg[..., None, :]
    dq_step = rot.delta_q(un_gyr * dt[..., None])
    ident = _identity_quat(dt)
    dq_step = torch.where(active[..., None], dq_step, ident)
    return active, acc_prev, un_gyr, dq_step


def _select_last(arr, count, ident):
    """arr[..., count-1, ...] (leading batch dims), or ``ident`` when
    count <= 0."""
    m = arr.shape[len(count.shape)]
    last = torch.clamp(count.long() - 1, 0, m - 1)
    idx = last.reshape(count.shape + (1,) * (arr.dim() - count.dim()))
    idx = idx.expand(count.shape + (1,) + arr.shape[count.dim() + 1:])
    val = torch.gather(arr, count.dim(), idx).squeeze(count.dim())
    empty = (count <= 0).reshape(count.shape + (1,) * (val.dim() - count.dim()))
    return torch.where(empty, ident, val)


def _block_matrix(bshape, rows) -> torch.Tensor:
    """A matrix of 3x3 blocks in the state order P, R, V, BA, BG: ``rows``
    lists each block row, a block a tensor broadcast to ``bshape`` (..., 3,
    3) or None for zeros. Built out of place (a write into a fresh buffer
    cannot take a value that ``torch.func.vmap`` batches)."""
    like = next(b for row in rows for b in row if b is not None)
    zero = torch.zeros(bshape, dtype=like.dtype, device=like.device)
    return torch.cat([torch.cat([zero if b is None else b.expand(bshape) for b in row],
                                dim=-1) for row in rows], dim=-2)


def preintegrate_parallel(acc0, gyr0, dt, acc, gyr, count, lin_ba, lin_bg,
                          noise) -> Preintegration:
    """Preintegrate (batched) intervals of up to M readings."""
    dtype, dev = acc0.dtype, acc0.device
    count = torch.as_tensor(count, device=dev)
    active, acc_prev, un_gyr, dq_step = _step_quantities(
        acc0, gyr0, dt, acc, gyr, count, lin_bg)
    dt_m = torch.where(active, dt, torch.zeros_like(dt))

    q_prefix = rot.quat_normalize(_prefix_quat(dq_step))     # (..., M, 4)
    R = rot.quat_to_rot(q_prefix)
    ident_q = _identity_quat(dt)
    q_prev = torch.cat([ident_q.expand(q_prefix[..., :1, :].shape),
                        q_prefix[..., :-1, :]], dim=-2)
    R_prev = rot.quat_to_rot(q_prev)

    ba = lin_ba[..., None, :]
    a_prev_b = torch.einsum("...mij,...mj->...mi", R_prev, acc_prev - ba)
    a_cur_b = torch.einsum("...mij,...mj->...mi", R, acc - ba)
    un_acc = torch.where(active[..., None], 0.5 * (a_prev_b + a_cur_b),
                         torch.zeros_like(a_cur_b))
    dv_all = torch.cumsum(un_acc * dt_m[..., None], dim=-2)
    dv_prev = torch.cat([torch.zeros_like(dv_all[..., :1, :]), dv_all[..., :-1, :]], dim=-2)
    dp_all = torch.cumsum(dv_prev * dt_m[..., None]
                          + 0.5 * un_acc * dt_m[..., None] ** 2, dim=-2)

    w_x = torch.where(active[..., None], un_gyr, torch.zeros_like(un_gyr))
    r_w = rot.skew(w_x)
    r_a0 = rot.skew(acc_prev - ba)
    r_a1 = rot.skew(acc - ba)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    dtc = dt_m[..., None, None]
    dt2 = dtc * dtc
    I_left = eye3 - r_w * dtc
    bshape = dt.shape + (3, 3)
    eyeb = eye3.expand(bshape)
    R_ra1 = R @ r_a1

    Z = None    # a zero block
    f_pr = -0.25 * (R_prev @ r_a0) * dt2 - 0.25 * (R_ra1 @ I_left) * dt2
    f_vr = -0.5 * (R_prev @ r_a0) * dtc - 0.5 * (R_ra1 @ I_left) * dtc
    Fm = _block_matrix(bshape, [     # block rows and columns P, R, V, BA, BG
        [eyeb, f_pr, eye3 * dtc, -0.25 * (R_prev + R) * dt2, 0.25 * R_ra1 * dt2 * dtc],
        [Z, I_left, Z, Z, -eye3 * dtc],
        [Z, f_vr, eyeb, -0.5 * (R_prev + R) * dtc, 0.5 * R_ra1 * dtc * dtc],
        [Z, Z, Z, eyeb, Z],
        [Z, Z, Z, Z, eyeb]])
    v03 = -0.125 * R_ra1 * dt2 * dtc
    v63 = -0.25 * R_ra1 * dtc * dtc
    V = _block_matrix(bshape, [      # noise columns a0, g0, a1, g1, ba, bg
        [0.25 * R_prev * dt2, v03, 0.25 * R * dt2, v03, Z, Z],
        [Z, 0.5 * eye3 * dtc, Z, 0.5 * eye3 * dtc, Z, Z],
        [0.5 * R_prev * dtc, v63, 0.5 * R * dtc, v63, Z, Z],
        [Z, Z, Z, Z, eye3 * dtc, Z],
        [Z, Z, Z, Z, Z, eye3 * dtc]])
    W_step = V @ noise @ V.transpose(-1, -2)

    # Affine-pair composition (F, W) -> (F_i J, F_i C F_iᵀ + W_i), in order.
    jac = Fm[..., 0, :, :]
    cov = W_step[..., 0, :, :]
    jacs, covs = [jac], [cov]
    for i in range(1, dt.shape[-1]):
        Fi = Fm[..., i, :, :]
        jac = Fi @ jac
        cov = Fi @ cov @ Fi.transpose(-1, -2) + W_step[..., i, :, :]
        jacs.append(jac)
        covs.append(cov)
    jac_prefix = torch.stack(jacs, dim=-3)
    cov_prefix = torch.stack(covs, dim=-3)

    return Preintegration(
        dp=_select_last(dp_all, count, torch.zeros(3, dtype=dtype, device=dev)),
        dq=_select_last(q_prefix, count, ident_q),
        dv=_select_last(dv_all, count, torch.zeros(3, dtype=dtype, device=dev)),
        jac=_select_last(jac_prefix, count, torch.eye(15, dtype=dtype, device=dev)),
        cov=_select_last(cov_prefix, count, torch.zeros((15, 15), dtype=dtype, device=dev)),
        sum_dt=torch.sum(dt_m, dim=-1),
        lin_ba=lin_ba, lin_bg=lin_bg,
    )


def continue_preintegration_parallel(carry: Preintegration, stream_acc,
                                     stream_gyr, dt, acc, gyr, count,
                                     noise) -> Preintegration:
    """push_back() a batch onto an existing preintegration by segment
    composition (see the reference's docstring for the algebra)."""
    dtype, dev = carry.dp.dtype, carry.dp.device
    inc = preintegrate_parallel(stream_acc, stream_gyr, dt, acc, gyr, count,
                                carry.lin_ba, carry.lin_bg, noise)
    R_c = rot.quat_to_rot(carry.dq)
    dq = rot.quat_normalize(rot.quat_mul(carry.dq, inc.dq))
    dv = carry.dv + torch.einsum("...ij,...j->...i", R_c, inc.dv)
    dp = (carry.dp + carry.dv * inc.sum_dt[..., None]
          + torch.einsum("...ij,...j->...i", R_c, inc.dp))
    eye3, Z = torch.eye(3, dtype=dtype, device=dev), None
    T = _block_matrix(R_c.shape, [[R_c, Z, Z, Z, Z], [Z, eye3, Z, Z, Z],
                                  [Z, Z, R_c, Z, Z], [Z, Z, Z, eye3, Z],
                                  [Z, Z, Z, Z, eye3]])
    Tt = T.transpose(-1, -2)
    J_B = T @ inc.jac @ Tt
    jac = J_B @ carry.jac
    cov = J_B @ carry.cov @ J_B.transpose(-1, -2) + T @ inc.cov @ Tt
    return Preintegration(dp=dp, dq=dq, dv=dv, jac=jac, cov=cov,
                          sum_dt=carry.sum_dt + inc.sum_dt,
                          lin_ba=carry.lin_ba, lin_bg=carry.lin_bg)


def propagate_state_parallel(p, q, v, ba, bg, prev_acc, prev_gyr, dt, acc,
                             gyr, count, gravity):
    """World-frame forward propagation across new readings (trapezoidal
    acceleration, midpoint gyro). Returns (p, q, v, last_acc, last_gyr)."""
    dev = p.device
    count = torch.as_tensor(count, device=dev)
    active, acc_prev, _, dq_step = _step_quantities(
        prev_acc, prev_gyr, dt, acc, gyr, count, bg)
    dt_m = torch.where(active, dt, torch.zeros_like(dt))
    q_prefix = _prefix_quat(dq_step)
    q_all = rot.quat_normalize(rot.quat_mul(q[..., None, :], q_prefix))
    q_prev_all = torch.cat([q[..., None, :], q_all[..., :-1, :]], dim=-2)
    a_prev = rot.quat_rotate(q_prev_all, acc_prev - ba[..., None, :]) - gravity
    a_cur = rot.quat_rotate(q_all, acc - ba[..., None, :]) - gravity
    un_acc = torch.where(active[..., None], 0.5 * (a_prev + a_cur),
                         torch.zeros_like(a_cur))
    v_all = v[..., None, :] + torch.cumsum(un_acc * dt_m[..., None], dim=-2)
    v_prev_all = torch.cat([v[..., None, :], v_all[..., :-1, :]], dim=-2)
    p_all = p[..., None, :] + torch.cumsum(
        v_prev_all * dt_m[..., None] + 0.5 * un_acc * dt_m[..., None] ** 2, dim=-2)
    return (_select_last(p_all, count, p), _select_last(q_all, count, q),
            _select_last(v_all, count, v), _select_last(acc, count, prev_acc),
            _select_last(gyr, count, prev_gyr))


def propagate_state(p, q, v, ba, bg, prev_acc, prev_gyr, dt, acc, gyr,
                    count, gravity):
    """World-frame forward propagation of the window tip across new
    readings, sample by sample (Estimator::propagateIMUState: trapezoidal
    acceleration, midpoint gyro; ``propagate_state_parallel`` is the
    batched form). Returns (p, q, v, last_acc, last_gyr)."""
    count = torch.as_tensor(count, device=p.device)
    acc_0, gyr_0 = prev_acc, prev_gyr
    for i in range(dt.shape[0]):
        dt_i, acc_1, gyr_1 = dt[i], acc[i], gyr[i]
        un_acc_0 = rot.quat_rotate(q, acc_0 - ba) - gravity
        un_gyr = 0.5 * (gyr_0 + gyr_1) - bg
        q_new = rot.quat_normalize(rot.quat_mul(q, rot.delta_q(un_gyr * dt_i)))
        un_acc_1 = rot.quat_rotate(q_new, acc_1 - ba) - gravity
        un_acc = 0.5 * (un_acc_0 + un_acc_1)
        new = (p + dt_i * v + 0.5 * dt_i * dt_i * un_acc, q_new,
               v + dt_i * un_acc, acc_1, gyr_1)
        p, q, v, acc_0, gyr_0 = (torch.where(i < count, n, o) for n, o in
                                 zip(new, (p, q, v, acc_0, gyr_0)))
    return p, q, v, acc_0, gyr_0


def evaluate(pre: Preintegration, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j,
             ba_j, bg_j, gravity) -> torch.Tensor:
    """15-d residual with first-order bias correction (IntegrationBase::evaluate)."""
    jac = pre.jac
    dp_dba = jac[..., O_P:O_P + 3, O_BA:O_BA + 3]
    dp_dbg = jac[..., O_P:O_P + 3, O_BG:O_BG + 3]
    dq_dbg = jac[..., O_R:O_R + 3, O_BG:O_BG + 3]
    dv_dba = jac[..., O_V:O_V + 3, O_BA:O_BA + 3]
    dv_dbg = jac[..., O_V:O_V + 3, O_BG:O_BG + 3]
    dba = ba_i - pre.lin_ba
    dbg = bg_i - pre.lin_bg

    def mv(m, x):
        return torch.einsum("...ij,...j->...i", m, x)

    corrected_dq = rot.quat_mul(pre.dq, rot.delta_q(mv(dq_dbg, dbg)))
    corrected_dv = pre.dv + mv(dv_dba, dba) + mv(dv_dbg, dbg)
    corrected_dp = pre.dp + mv(dp_dba, dba) + mv(dp_dbg, dbg)
    sdt = pre.sum_dt[..., None]
    q_i_inv = rot.quat_conjugate(q_i)
    r_p = rot.quat_rotate(q_i_inv, 0.5 * gravity * sdt * sdt + p_j - p_i - v_i * sdt) - corrected_dp
    r_q = 2.0 * rot.quat_mul(rot.quat_conjugate(corrected_dq),
                             rot.quat_mul(q_i_inv, q_j))[..., 1:4]
    r_v = rot.quat_rotate(q_i_inv, gravity * sdt + v_j - v_i) - corrected_dv
    return torch.cat([r_p, r_q, r_v, ba_j - ba_i, bg_j - bg_i], dim=-1)
