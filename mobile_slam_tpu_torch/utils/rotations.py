"""Quaternion / rotation utilities (torch twin of mobile_slam_tpu.utils.rotations).

Quaternions are ``(w, x, y, z)`` (Hamilton, scalar first). Every function
broadcasts over leading batch dims and is safe under ``torch.func.vmap`` /
``jacfwd`` (no in-place ops, no host reads).
"""

from __future__ import annotations

import math

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) @ v."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def rot_to_quat(r: torch.Tensor) -> torch.Tensor:
    """3x3 rotation -> unit quaternion (branchless Shepperd, w >= 0)."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)        # (..., 4, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0).to(q.dtype)


def delta_q(theta: torch.Tensor) -> torch.Tensor:
    """Small-angle quaternion (1, θ/2), deliberately unnormalized."""
    one = torch.ones(theta.shape[:-1] + (1,), dtype=theta.dtype,
                     device=theta.device)
    return torch.cat([one, 0.5 * theta], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(v[..., 0])
    row = torch.stack([
        zero, -v[..., 2], v[..., 1],
        v[..., 2], zero, -v[..., 0],
        -v[..., 1], v[..., 0], zero,
    ], dim=-1)
    return row.reshape(v.shape[:-1] + (3, 3))


def _q_mult_matrix(q: torch.Tensor, sign: float) -> torch.Tensor:
    w = q[..., 0]
    v = q[..., 1:4]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    top = torch.cat([w[..., None, None], -v[..., None, :]], dim=-1)
    bottom = torch.cat([v[..., :, None],
                        w[..., None, None] * eye + sign * skew(v)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def q_left(q: torch.Tensor) -> torch.Tensor:
    """q_left(q) @ p == quat_mul(q, p)."""
    return _q_mult_matrix(q, 1.0)


def q_right(q: torch.Tensor) -> torch.Tensor:
    """q_right(p) @ q == quat_mul(q, p)."""
    return _q_mult_matrix(q, -1.0)


def r2ypr(r: torch.Tensor) -> torch.Tensor:
    """Rotation -> (yaw, pitch, roll) in DEGREES, ZYX."""
    n = r[..., :, 0]
    o = r[..., :, 1]
    a = r[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    rr = torch.atan2(a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
                     -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y))
    return torch.stack([y, p, rr], dim=-1) * (180.0 / math.pi)


def ypr2r(ypr: torch.Tensor) -> torch.Tensor:
    """(yaw, pitch, roll) DEGREES -> Rz(y) Ry(p) Rx(r)."""
    rad = ypr * (math.pi / 180.0)
    y, p, r = rad[..., 0], rad[..., 1], rad[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    m = torch.stack([
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    ], dim=-1)
    return m.reshape(ypr.shape[:-1] + (3, 3))


def quat_from_two_vectors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Shortest-arc unit quaternion rotating a onto b."""
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    c = _cross(a, b)
    d = torch.sum(a * b, dim=-1)
    w = 1.0 + d
    ex = a.new_tensor([1.0, 0.0, 0.0]) * torch.ones_like(a)
    ey = a.new_tensor([0.0, 1.0, 0.0]) * torch.ones_like(a)
    ortho = torch.where(torch.abs(a[..., 0:1]) < 0.9, _cross(a, ex), _cross(a, ey))
    ortho = ortho / torch.linalg.vector_norm(ortho, dim=-1, keepdim=True)
    near_pi = w[..., None] < 1e-8
    q = torch.cat([w[..., None], c], dim=-1)
    q = torch.where(near_pi, torch.cat([torch.zeros_like(w[..., None]), ortho], dim=-1), q)
    return quat_normalize(q)


def g2r(g: torch.Tensor) -> torch.Tensor:
    """Rotation taking measured gravity to +z with zero yaw."""
    ng1 = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    ng2 = g.new_tensor([0.0, 0.0, 1.0]).expand(ng1.shape)
    r0 = quat_to_rot(quat_from_two_vectors(ng1, ng2))
    yaw = r2ypr(r0)[..., 0]
    zero = torch.zeros_like(yaw)
    fix = ypr2r(torch.stack([-yaw, zero, zero], dim=-1))
    return fix @ r0


def quat_boxplus(q: torch.Tensor, dtheta: torch.Tensor) -> torch.Tensor:
    """Manifold ⊞: normalize(q ⊗ deltaQ(dθ))."""
    return quat_normalize(quat_mul(q, delta_q(dtheta)))


def quat_boxminus(q1: torch.Tensor, q0: torch.Tensor) -> torch.Tensor:
    """Manifold ⊟: 2 vec(q0⁻¹ ⊗ q1), short geodesic."""
    dq = quat_mul(quat_conjugate(q0), q1)
    dq = dq * torch.where(dq[..., 0:1] < 0, -1.0, 1.0).to(dq.dtype)
    return 2.0 * dq[..., 1:4]
