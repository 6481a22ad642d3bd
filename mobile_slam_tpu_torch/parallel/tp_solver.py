"""Landmark-sharded damped solve step (torch twin of
mobile_slam_tpu.parallel.tp_solver).

The projection factors, the landmark (Schur) elimination and the
per-landmark back-substitution are sums or maps over the landmark axis F,
so they shard across the ranks of a ``torch.distributed`` process group:
each rank holds F / world landmarks (``shard_landmarks``), assembles their
normal-equation contributions, and the small dense camera-state system is
reduced and solved replicated on every rank; the landmark updates stay
local. The collectives are one ``all_reduce`` of (H_ss, g_s, cost), one
``all_gather_into_tensor`` of the landmark diagonal H_ll (for its global
median) and one ``all_reduce`` of the Schur corrections.

Rank 0 (the lead) contributes the replicated factors once: the IMU
factors, the prior and the td random-walk term. (The reference adds the
td term on every shard, so with td on its sharded step counts it once per
device; the two agree at one device and whenever td is off.)
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mobile_slam_tpu_torch.solver import assembly, layout
from mobile_slam_tpu_torch.utils.linalg import cholesky_or_nan, median

NSOLVE = layout.EX_COL


def tp_damped_step(x: assembly.XState, table, pre, imu_sqrt_info, imu_valid,
                   prior, prior_H0, ex_t, ex_q, sp, proj_valid, lam_mask, mu,
                   group=None):
    """One damped Schur-complement solve with the landmark axis sharded over
    ``group``. ``table``, ``x.lam``, ``proj_valid`` and ``lam_mask`` are this
    rank's slice (``shard_landmarks``); everything else is replicated.
    Returns (dx (NSOLVE,) replicated, dlam (F / world,) local, cost ()
    replicated), with lm._solve_damped's damping floors and equilibration."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    lead = rank == 0
    eqs = assembly.build_normal_eqs(
        x, table, pre, imu_sqrt_info, imu_valid & lead, prior, prior_H0, ex_t,
        ex_q, sp, proj_valid, use_prior=lead, include_td_rw=lead)
    S = eqs.H_ss.shape[0]
    red = torch.cat([eqs.H_ss.reshape(-1), eqs.g_s, eqs.cost.reshape(1)])
    dist.all_reduce(red, group=group)
    H = red[:S * S].reshape(S, S)[:NSOLVE, :NSOLVE]
    g = red[S * S:S * S + NSOLVE]
    cost = red[-1]
    H_sl = eqs.H_sl[:NSOLVE]                   # (NSOLVE, F_local), stays local

    diag = torch.diagonal(H)
    H_d = H + torch.diag(mu * diag + 1e-7 * median(diag) + 1e-10)
    # The landmark damping floor takes the global median of H_ll.
    hll_all = torch.empty(world * eqs.H_ll.shape[0], dtype=eqs.H_ll.dtype,
                          device=eqs.H_ll.device)
    dist.all_gather_into_tensor(hll_all, eqs.H_ll.contiguous(), group=group)
    hll = eqs.H_ll * (1.0 + mu) + 1e-6 * median(hll_all) + 1e-12
    hll = torch.where(lam_mask, hll, torch.ones_like(hll))
    inv_hll = 1.0 / hll
    lm = lam_mask.to(H.dtype)
    corr = torch.cat([((H_sl * (inv_hll * lm)[None, :]) @ H_sl.T).reshape(-1),
                      H_sl @ (inv_hll * eqs.g_l * lm)])
    dist.all_reduce(corr, group=group)
    H_red = H_d - corr[:NSOLVE * NSOLVE].reshape(NSOLVE, NSOLVE)
    g_red = g - corr[NSOLVE * NSOLVE:]

    d = torch.sqrt(torch.clamp(torch.diagonal(H_red), min=1e-12))
    L = cholesky_or_nan(H_red / (d[:, None] * d[None, :]))
    dx = -torch.cholesky_solve((g_red / d)[:, None], L)[:, 0] / d
    dlam = -(eqs.g_l + H_sl.T @ dx) * inv_hll
    return dx, dlam, cost


def shard_landmarks(tree, rank: int, world: int):
    """This rank's slice of a leading-F structure (a FeatureTable, lam, the
    masks): rows rank * F / world to (rank + 1) * F / world. F must divide
    by ``world``."""
    if isinstance(tree, torch.Tensor):
        f = tree.shape[0]
        if f % world:
            raise ValueError(f"{f} landmarks do not split over {world} ranks")
        n = f // world
        return tree[rank * n:(rank + 1) * n]
    return type(tree)(*[shard_landmarks(t, rank, world) for t in tree])
