"""Vectorized fundamental-matrix RANSAC (torch twin of
mobile_slam_tpu.ops.ransac).

A fixed batch of 8-point hypotheses is solved and scored in parallel, the
best model is refit on its inliers, and the refit is kept only if it does
not lose inliers. ``USE_LU_HYPOTHESES`` (a module global with the
reference's name and default, read at call time) picks the hypothesis
solver: False, a batched 9x9 eigh and a 3x3 SVD rank-2 projection; True,
shifted inverse power iteration on a Cholesky factor and the closed-form
epipole projection, which needs no iterative eigensolver and no host
check (a failed factorization gives NaN and scores no inlier). The raw
sample draws ``r`` (N, 8) in [0, 2^30) may be passed in (tests inject the
reference's draws); otherwise they come from ``generator``.
"""

from __future__ import annotations

import math

import torch

from mobile_slam_tpu_torch.utils.linalg import cholesky_or_nan, eigh64

USE_LU_HYPOTHESES = False


def _hartley_normalize(pts, valid):
    w = valid.to(pts.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(pts * w[:, None], dim=0) / n
    d = torch.sqrt(torch.sum((pts - mean) ** 2, dim=-1)) * w
    scale = math.sqrt(2.0) / torch.clamp(torch.sum(d) / n, min=1e-8)
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[0]]),
        torch.stack([zero, scale, -scale * mean[1]]),
        torch.stack([zero, zero, one]),
    ])
    return (pts - mean) * scale, T


def _design(p1, p2):
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)


def _rank2(F):
    u, s, vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return u @ (s[..., :, None] * vt)


def _eight_point_eigh(p1, p2):
    """F from 8 correspondences via the nullspace of A (batched eigh)."""
    A = _design(p1, p2)
    AtA = torch.einsum("...ri,...rj->...ij", A, A)
    _, vecs = eigh64(AtA)
    f = vecs[..., 0]
    return _rank2(f.reshape(f.shape[:-1] + (3, 3)))


def _min_eigvec_inv_power(AtA, iters: int = 3):
    """Smallest eigenvector of batched SPD (..., 9, 9) Gram matrices by
    shifted inverse power iteration: one Cholesky of AtA + eps I, then
    ``iters`` triangular solves. A non-finite result (a defective Gram
    matrix from repeated sample points) comes back as NaN."""
    n = AtA.shape[-1]
    eps = 1e-7 * (torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[..., None, None] / n
                  + 1e-30)
    L = cholesky_or_nan(AtA + eps * torch.eye(n, dtype=AtA.dtype, device=AtA.device))
    x = torch.ones(AtA.shape[:-1], dtype=AtA.dtype, device=AtA.device)
    for _ in range(iters):
        x = torch.cholesky_solve(x[..., None], L)[..., 0]
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-30)
    ok = torch.all(torch.isfinite(x), dim=-1, keepdim=True)
    return torch.where(ok, x, torch.full_like(x, float("nan")))


def _rank2_project(F):
    """Batched rank-2 enforcement without an SVD: the right epipole e (the
    null direction of FᵀF from the closed-form symmetric 3x3 eigenvalue
    and the largest cross product of two rows), then F <- F (I - e eᵀ)."""
    M = torch.einsum("...ji,...jk->...ik", F, F)
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    q = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None] / 3.0
    B0 = M - q * eye
    p = torch.sqrt(torch.clamp(torch.sum(B0 * B0, dim=(-2, -1)) / 6.0,
                               min=1e-30))[..., None, None]
    r = torch.clamp(torch.linalg.det(B0 / p) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r)[..., None, None] / 3.0
    C = M - (q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)) * eye
    cands = torch.stack([torch.linalg.cross(C[..., 0, :], C[..., 1, :], dim=-1),
                         torch.linalg.cross(C[..., 0, :], C[..., 2, :], dim=-1),
                         torch.linalg.cross(C[..., 1, :], C[..., 2, :], dim=-1)],
                        dim=-2)
    pick = torch.argmax(torch.sum(cands * cands, dim=-1), dim=-1)
    e = torch.gather(cands, -2, pick[..., None, None].expand(
        pick.shape + (1, 3)))[..., 0, :]
    e = e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-30)
    return F - torch.einsum("...ij,...j,...k->...ik", F, e, e)


def _eight_point(p1, p2):
    """F from 8 correspondences (..., 8, 2) by inverse power iteration on
    the 9x9 Gram matrix, rank 2 by the epipole projection."""
    A = _design(p1, p2)
    f = _min_eigvec_inv_power(torch.einsum("...ri,...rj->...ij", A, A))
    return _rank2_project(f.reshape(f.shape[:-1] + (3, 3)))


def _epipolar_dist(F, p1, p2):
    """Max point-to-epipolar-line distance over both images. F (..., 3, 3),
    p1/p2 (K, 2) -> (..., K)."""
    ones = torch.ones_like(p1[:, :1])
    h1 = torch.cat([p1, ones], dim=-1)
    h2 = torch.cat([p2, ones], dim=-1)
    l2 = torch.einsum("kj,...ij->...ki", h1, F)     # h1 @ F.T
    l1 = torch.einsum("kj,...ji->...ki", h2, F)     # h2 @ F
    d2 = torch.abs(torch.sum(l2 * h2, dim=-1)) / torch.clamp(
        torch.linalg.vector_norm(l2[..., :2], dim=-1), min=1e-12)
    d1 = torch.abs(torch.sum(l1 * h1, dim=-1)) / torch.clamp(
        torch.linalg.vector_norm(l1[..., :2], dim=-1), min=1e-12)
    return torch.maximum(d1, d2)


def find_fundamental_ransac(pts1, pts2, valid, threshold: float, *,
                            num_hypotheses: int = 64, r=None,
                            generator: torch.Generator | None = None):
    """Returns (F (3, 3), inlier mask (K,))."""
    lu = USE_LU_HYPOTHESES
    dtype = pts1.dtype
    # Invalid slots never score; zeroing them keeps a non-finite dead slot
    # from poisoning the normalization (identical result for finite input).
    pts1 = torch.where(valid[:, None], pts1, torch.zeros_like(pts1))
    pts2 = torch.where(valid[:, None], pts2, torch.zeros_like(pts2))
    p1n, T1 = _hartley_normalize(pts1, valid)
    p2n, T2 = _hartley_normalize(pts2, valid)

    order = torch.argsort((~valid).to(torch.int32), stable=True)
    n_valid = torch.sum(valid)
    if r is None:
        r = torch.randint(0, 1 << 30, (num_hypotheses, 8),
                          generator=generator, device=pts1.device)
    idx = order[r.to(pts1.device).long() % torch.clamp(n_valid, min=1)]

    eight_pt = _eight_point if lu else _eight_point_eigh
    Fn = eight_pt(p1n[idx], p2n[idx])                        # (N, 3, 3)
    Fh = T2.T[None] @ Fn @ T1[None]

    d = _epipolar_dist(Fh, pts1, pts2)                       # (N, K)
    inl = (d < threshold) & valid[None, :]
    scores = torch.sum(inl, dim=1)
    best = torch.argmax(scores).reshape(1)     # stays on the device
    inl_best = inl.index_select(0, best)[0]
    score_best = scores.index_select(0, best)[0]
    F_best = Fh.index_select(0, best)[0]

    w = inl_best.to(dtype)
    A = _design(p1n, p2n)
    AtA = torch.einsum("ri,r,rj->ij", A, w, A)
    if lu:
        Fr = _rank2(_min_eigvec_inv_power(AtA).reshape(3, 3))
    else:
        Fr = _rank2(eigh64(AtA)[1][:, 0].reshape(3, 3))
    Fr = T2.T @ Fr @ T1
    Fr = torch.where(torch.all(torch.isfinite(Fr)), Fr,
                     torch.eye(3, dtype=dtype, device=Fr.device))
    d_refit = _epipolar_dist(Fr, pts1, pts2)
    inl_refit = (d_refit < threshold) & valid
    better = torch.sum(inl_refit) >= score_best
    F_out = torch.where(better, Fr, F_best)
    status = torch.where(better, inl_refit, inl_best)
    return F_out, status


def edge_recovery(F, und1, und2, raw2, status, valid, threshold: float,
                  edge_factor: float, cx: float, cy: float):
    """Distance-aware edge-feature recovery (feature_tracker.cpp:236-285)."""
    r_max = math.sqrt(cx * cx + cy * cy)
    dx = raw2[:, 0] - cx
    dy = raw2[:, 1] - cy
    r_ratio = torch.sqrt(dx * dx + dy * dy) / max(r_max, 1e-6)
    ones = torch.ones_like(und1[:, :1])
    h1 = torch.cat([und1, ones], dim=-1)
    h2 = torch.cat([und2, ones], dim=-1)
    l = h1 @ F.T
    norm_ab = torch.linalg.vector_norm(l[:, :2], dim=-1)
    dist = torch.abs(torch.sum(l * h2, dim=-1)) / torch.clamp(norm_ab, min=1e-12)
    adaptive = threshold * (1.0 + edge_factor * r_ratio * r_ratio)
    restore = (valid & ~status & (edge_factor > 0) & (r_ratio >= 0.3)
               & (norm_ab >= 1e-12) & (dist < adaptive))
    return status | restore
