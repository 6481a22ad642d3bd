"""Vectorized fundamental-matrix RANSAC (torch twin of
mobile_slam_tpu.ops.ransac, production batched-eigh 8-point path).

A fixed batch of 8-point hypotheses is solved (batched 9x9 eigh + 3x3 SVD
rank-2 projection) and scored in parallel, the best model is refit on its
inliers, and the refit is kept only if it does not lose inliers. The raw
sample draws ``r`` (N, 8) in [0, 2^30) may be passed in (tests inject the
reference's draws); otherwise they come from ``generator``.
"""

from __future__ import annotations

import math

import torch

from mobile_slam_tpu_torch.utils.linalg import eigh64


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

    Fn = _eight_point_eigh(p1n[idx], p2n[idx])               # (N, 3, 3)
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
    _, vecs = eigh64(AtA)
    Fr = _rank2(vecs[:, 0].reshape(3, 3))
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
