"""FEJ marginalization into a square-root prior (J0, r0) (torch twin of
mobile_slam_tpu.factors.marginalization).

The square-root pipeline (``SQRT_MARGIN_OLD`` / ``SQRT_MARGIN_NEW`` True,
the default):

* margin-old: fresh factors (first IMU + frame-0-anchored projections) are
  squared once, their dropped depths Schur-eliminated and the result
  eigen-factorized into rows; the prior's raw rows [J0 | r0 + J0 dx] are
  stacked under them, the frame-0 block is removed by Householder
  reflections and the stack recompressed by one QR.
* margin-new: the pose of slot W-2 is removed from (J0, r) by six
  Householder reflections, unless the prior does not involve it.

The dense-eigh path (``enable_sqrt_pipeline(False)``): the prior is squared
into H = J0ᵀJ0 with the fresh factors, the dropped block Schur-eliminated
through a thresholded eigen pseudo-inverse (``_eliminate_frame_block``) and
H re-factorized by a thresholded eigendecomposition; ``RESTRICTED_SUPPORT``
runs that factorization on the prior's static 76-dim support (``_SUPPORT``)
only. The flags are module globals with the reference's names and defaults,
read at call time. Every eigendecomposition runs in float64 (eigh64).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mobile_slam_tpu_torch.config import NUM_SLOTS
from mobile_slam_tpu_torch.solver import layout
from mobile_slam_tpu_torch.models.state import FeatureTable, WindowState, eligible_mask
from mobile_slam_tpu_torch.solver import assembly
from mobile_slam_tpu_torch.solver.assembly import Prior, SolverParams, XState
from mobile_slam_tpu_torch.utils.linalg import eigh64, tree_where

W = NUM_SLOTS
S = layout.S
REL_EIG_EPS = 1e-4

# The prior's support: {poses 0..9, speedbias 0, td, extrinsic}
# (mobile_slam_tpu/factors/marginalization.py:44-48).
_SUPPORT = tuple(int(i) for i in np.concatenate([
    np.arange(0, layout.pose_col(W - 1)),
    np.arange(layout.sb_col(0), layout.sb_col(0) + 9),
    np.arange(layout.TD_COL, S),
]))
_SUP_N = len(_SUPPORT)

RESTRICTED_SUPPORT = False
SQRT_MARGIN_NEW = True
SQRT_MARGIN_OLD = True


def enable_sqrt_pipeline(on: bool = True) -> None:
    """Switch the full square-root prior pipeline (margin-old and margin-new
    together) on or off; off is the dense-eigh path."""
    global SQRT_MARGIN_OLD, SQRT_MARGIN_NEW
    SQRT_MARGIN_OLD = on
    SQRT_MARGIN_NEW = on


def _perm(kind: str, like: torch.Tensor) -> torch.Tensor:
    return _perm_on(kind, like.dtype, like.device)


@functools.lru_cache(maxsize=None)
def _perm_on(kind: str, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The slide permutation on ``device``, copied there once."""
    return torch.as_tensor(layout.shift_permutation(kind, "float64"),
                           dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _frame0_cols(device: torch.device) -> torch.Tensor:
    """The tangent columns of window frame 0 on ``device``, copied there once."""
    return torch.as_tensor(layout.frame_block_indices(0), device=device).long()


@functools.lru_cache(maxsize=None)
def _index(cols: tuple, device: torch.device) -> torch.Tensor:
    """A static index set on ``device``, copied there once."""
    return torch.as_tensor(cols, dtype=torch.long, device=device)


@functools.lru_cache(maxsize=None)
def _slide_index(kind: str, device: torch.device) -> torch.Tensor:
    """Window slot each slot's linearization point comes from after the
    slide, on ``device``, copied there once."""
    if kind == "old":
        sl = [min(k + 1, W - 1) for k in range(W)]
    else:
        sl = list(range(W - 2)) + [W - 1, W - 1]
    return torch.as_tensor(sl, device=device)


def _eliminate_lambdas(H, g, H_sl, H_ll, g_l, drop_mask):
    w = drop_mask.to(H.dtype)
    inv = torch.where(H_ll > 1e-10, 1.0 / torch.clamp(H_ll, min=1e-10),
                      torch.zeros_like(H_ll)) * w
    return H - (H_sl * inv[None, :]) @ H_sl.T, g - H_sl @ (inv * g_l)


def _eliminate_frame_block(H, g, cols: tuple):
    """Schur-eliminate the static index set ``cols`` through a thresholded
    eigen pseudo-inverse of the equilibrated dropped block; the eliminated
    rows and columns come out zero."""
    idx = _index(cols, H.device)
    H_mm = H.index_select(0, idx).index_select(1, idx)
    H_mm = 0.5 * (H_mm + H_mm.T)
    d = torch.sqrt(torch.clamp(torch.diagonal(H_mm), min=1e-20))
    Hn = H_mm / (d[:, None] * d[None, :])
    evals, evecs = eigh64(Hn)
    emax = torch.clamp(torch.max(evals), min=1e-20)
    keep = evals > REL_EIG_EPS * emax
    inv_evals = torch.where(keep, 1.0 / torch.clamp(evals, min=1e-20),
                            torch.zeros_like(evals))
    H_mm_inv = ((evecs * inv_evals[None, :]) @ evecs.T) / (d[:, None] * d[None, :])
    H_rm = H.index_select(1, idx)
    H2 = H - H_rm @ H_mm_inv @ H_rm.T
    g2 = g - H_rm @ (H_mm_inv @ g.index_select(0, idx))
    zmask = torch.ones(S, dtype=H.dtype, device=H.device).index_fill(0, idx, 0.0)
    return H2 * zmask[:, None] * zmask[None, :], g2 * zmask


def _sqrt_factorize_dense(H, g):
    """H = J0ᵀJ0, g = J0ᵀr0 by a thresholded eigendecomposition of the
    diagonally equilibrated H."""
    H = 0.5 * (H + H.T)
    diag = torch.diagonal(H)
    d = torch.sqrt(torch.where(diag <= 1e-18, torch.ones_like(diag), diag))
    Hn = H / (d[:, None] * d[None, :])
    evals, evecs = eigh64(Hn)
    emax = torch.clamp(torch.max(evals), min=1e-20)
    keep = evals > REL_EIG_EPS * emax
    sqrt_e = torch.where(keep, torch.sqrt(torch.clamp(evals, min=1e-20)),
                         torch.zeros_like(evals))
    inv_sqrt_e = torch.where(keep, 1.0 / torch.clamp(sqrt_e, min=1e-30),
                             torch.zeros_like(evals))
    J0 = sqrt_e[:, None] * (evecs.T * d[None, :])
    r0 = inv_sqrt_e * (evecs.T @ (g / d))
    return J0, r0


def _sqrt_factorize(H, g):
    """The dense path's factorization: on the full tangent, or with
    RESTRICTED_SUPPORT on the support's submatrix, scattered back."""
    if not RESTRICTED_SUPPORT:
        return _sqrt_factorize_dense(H, g)
    sup = _index(_SUPPORT, H.device)
    J0s, r0s = _sqrt_factorize_dense(H.index_select(0, sup).index_select(1, sup),
                                     g.index_select(0, sup))
    J0 = torch.cat([J0s, torch.zeros((S - _SUP_N, _SUP_N), dtype=H.dtype,
                                     device=H.device)], dim=0)
    J0 = torch.zeros((S, S), dtype=H.dtype, device=H.device).index_copy(1, sup, J0)
    r0 = torch.cat([r0s, torch.zeros(S - _SUP_N, dtype=H.dtype, device=H.device)])
    return J0, r0


def _householder_eliminate(M: torch.Tensor, cols) -> torch.Tensor:
    """Triangularize ``cols`` of M = [J | r] with one Householder reflection
    each, drop the first len(cols) rows and append as many zero rows."""
    n = len(cols)
    rows = torch.arange(M.shape[0], device=M.device)
    for k, c in enumerate(cols):
        x = torch.where(rows < k, torch.zeros_like(M[:, c]), M[:, c])
        sigma = torch.sqrt(torch.sum(x * x))
        sgn = torch.where(x[k] >= 0, 1.0, -1.0).to(M.dtype)
        v = x.clone()
        v[k] = v[k] + sgn * sigma
        vtv = torch.sum(v * v)
        beta = torch.where(sigma > 1e-20, 2.0 / torch.clamp(vtv, min=1e-38),
                           torch.zeros_like(vtv))
        M = M - beta * torch.outer(v, v @ M)
    out = M[n:]
    return torch.cat([out, torch.zeros((n,) + out.shape[1:], dtype=M.dtype,
                                       device=M.device)], dim=0)


def _permuted_linearization(kind: str, x: XState, ex_t, ex_q) -> dict:
    sl = _slide_index(kind, x.p.device)
    return dict(p0=x.p[sl], q0=x.q[sl], v0=x.v[sl], ba0=x.ba[sl],
                bg0=x.bg[sl], ex_t0=ex_t, ex_q0=ex_q, td0=x.td)


def marginalize_old(x: XState, table: FeatureTable, window: WindowState,
                    imu_sqrt_info, prior: Prior, ex_t, ex_q,
                    params: SolverParams) -> Prior:
    """MARGIN_OLD_KEYFRAME: drop frame 0 and its anchored depths."""
    dtype, dev = x.p.dtype, x.p.device
    elig = eligible_mask(table)
    imu_valid = ((torch.arange(W - 1, device=dev) == 0) & (window.pre.sum_dt[1:] < 10.0)
                 & (window.imu_cnt[1:] > 0))
    proj_valid = assembly.proj_valid_mask(table) & (table.start == 0)[:, None]
    drop_lam = elig & (table.start == 0)
    idx0 = tuple(int(i) for i in layout.frame_block_indices(0))
    P = _perm("old", x.p)

    if not SQRT_MARGIN_OLD:
        eqs = assembly.build_normal_eqs(
            x, table, window.pre, imu_sqrt_info, imu_valid, prior,
            prior.J0.T @ prior.J0, ex_t, ex_q, params, proj_valid,
            include_td_rw=False)
        H, g = _eliminate_lambdas(eqs.H_ss, eqs.g_s, eqs.H_sl, eqs.H_ll,
                                  eqs.g_l, drop_lam)
        H, g = _eliminate_frame_block(H, g, idx0)
        J0, r0 = _sqrt_factorize(P @ H @ P.T, P @ g)
        return Prior(J0=J0, r0=r0, **_permuted_linearization("old", x, ex_t, ex_q))

    eqs = assembly.build_normal_eqs(
        x, table, window.pre, imu_sqrt_info, imu_valid, prior,
        torch.zeros((S, S), dtype=dtype, device=dev), ex_t, ex_q, params,
        proj_valid, use_prior=False, include_td_rw=False)
    H_f, g_f = _eliminate_lambdas(eqs.H_ss, eqs.g_s, eqs.H_sl, eqs.H_ll,
                                  eqs.g_l, drop_lam)
    R_f, r_f = _sqrt_factorize_dense(H_f, g_f)
    r_pr = prior.r0 + prior.J0 @ assembly.prior_dx(prior, x, ex_t, ex_q)
    M = torch.cat([torch.cat([R_f, r_f[:, None]], dim=1),
                   torch.cat([prior.J0, r_pr[:, None]], dim=1)], dim=0)
    M = _householder_eliminate(M, idx0)
    M = M.index_fill(1, _frame0_cols(dev), 0.0)        # clear roundoff
    R = torch.linalg.qr(M, mode="r")[1]                # (S+1, S+1)
    J0 = R[:S, :S] @ P.T
    return Prior(J0=J0, r0=R[:S, S].clone(),
                 **_permuted_linearization("old", x, ex_t, ex_q))


def marginalize_new(x: XState, prior: Prior, ex_t, ex_q) -> Prior:
    """MARGIN_NEW_GENERAL_FRAME: drop pose W-2 from the prior alone."""
    c0 = layout.pose_col(W - 2)
    coupled = torch.sum(torch.abs(prior.J0[:, c0:c0 + 6])) > 0
    r = prior.r0 + prior.J0 @ assembly.prior_dx(prior, x, ex_t, ex_q)
    P = _perm("new", x.p)
    if SQRT_MARGIN_NEW:
        M = torch.cat([prior.J0, r[:, None]], dim=1)
        M = _householder_eliminate(M, list(range(c0, c0 + 6)))
        J2 = M[:, :S].clone()
        J2[:, c0:c0 + 6] = 0.0
        J0, r0 = J2 @ P.T, M[:, S].clone()
    else:
        H2, g2 = _eliminate_frame_block(prior.J0.T @ prior.J0, prior.J0.T @ r,
                                        tuple(range(c0, c0 + 6)))
        J0, r0 = _sqrt_factorize(P @ H2 @ P.T, P @ g2)
    new_prior = Prior(J0=J0, r0=r0, **_permuted_linearization("new", x, ex_t, ex_q))
    return tree_where(coupled, new_prior, prior)
