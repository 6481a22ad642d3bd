"""Feature bank operations on the fixed (F, 11) observation grid (torch twin
of mobile_slam_tpu.frontend.feature_table): id matching and slot
allocation with the keyframe parallax decision, multi-view triangulation
(closed-form adjugate solve, or with ``ADJUGATE_TRIANGULATION`` False the
reference's batched 4x4 eigh), the two window slides and failure removal.
Scatters that the reference writes with ``mode="drop"`` go through one
extra dump row."""

from __future__ import annotations

from typing import NamedTuple

import torch

from mobile_slam_tpu_torch.config import NUM_SLOTS
from mobile_slam_tpu_torch.models.state import FeatureTable
from mobile_slam_tpu_torch.utils import rotations as rot
from mobile_slam_tpu_torch.utils.linalg import eigh64

W = NUM_SLOTS


class AddResult(NamedTuple):
    table: FeatureTable
    is_keyframe: torch.Tensor
    last_track_num: torch.Tensor
    parallax: torch.Tensor


def _set_rows(base: torch.Tensor, idx: torch.Tensor, vals, col=None) -> torch.Tensor:
    """base.at[idx(, col)].set(vals, mode="drop") with idx == len(base) as
    the dropped index. A python ``vals`` and a 0-dim tensor ``col`` are made
    device tensors first (as python and 0-dim indices they are host reads)."""
    ext = torch.cat([base, torch.zeros_like(base[:1])], dim=0)
    if not isinstance(vals, torch.Tensor):
        vals = torch.full((), vals, dtype=base.dtype, device=base.device)
    index = (idx,) if col is None else (
        idx, torch.as_tensor(col, device=idx.device).expand(idx.shape))
    # Out of place: torch.func.vmap cannot write a batched value into a
    # buffer that is not batched.
    return ext.index_put(index, vals)[:base.shape[0]]


def add_and_check_parallax(table: FeatureTable, ids, obs, uv, vel, valid,
                           frame_count, min_parallax_norm) -> AddResult:
    F = table.fid.shape[0]
    dev = table.fid.device
    used = table.fid >= 0
    match = (table.fid[:, None] == ids[None, :]) & used[:, None] & valid[None, :]
    tracked = torch.any(match, dim=0)
    matched_slot = torch.argmax(match.to(torch.int32), dim=0)
    last_track_num = torch.sum(tracked & valid)

    is_new = valid & ~tracked
    free_slots_first = torch.argsort(used.to(torch.int32), stable=True)
    num_free = F - torch.sum(used)
    new_rank = torch.cumsum(is_new.to(torch.int64), dim=0) - 1
    can_alloc = is_new & (new_rank < num_free)
    new_slot = free_slots_first[torch.clamp(new_rank, 0, F - 1)]

    tslot = torch.where(tracked, matched_slot, torch.where(can_alloc, new_slot, F))
    write = valid & (tracked | can_alloc)
    tslot = torch.where(write, tslot, F)

    clear = _set_rows(torch.zeros(F, dtype=torch.bool, device=dev),
                      torch.where(can_alloc, new_slot, F), True)

    def clr(a, fill):
        c = clear.reshape((F,) + (1,) * (a.dim() - 1))
        return torch.where(c, torch.full_like(a, fill), a)

    fid = clr(table.fid, -1)
    start = clr(table.start, 0)
    obs_g = clr(table.obs, 0.0)
    uv_g = clr(table.uv, 0.0)
    vel_g = clr(table.vel, 0.0)
    mask_g = clr(table.mask, False)
    depth = clr(table.depth, -1.0)
    solve_flag = clr(table.solve_flag, 0)

    fc = torch.as_tensor(frame_count, device=dev).long()
    fid = _set_rows(fid, tslot, ids.to(fid.dtype))
    start = _set_rows(start, tslot, torch.where(
        tracked, start[torch.clamp(tslot, 0, F - 1)], fc.to(start.dtype)))
    obs_g = _set_rows(obs_g, tslot, obs.to(obs_g.dtype), fc)
    uv_g = _set_rows(uv_g, tslot, uv.to(uv_g.dtype), fc)
    vel_g = _set_rows(vel_g, tslot, vel.to(vel_g.dtype), fc)
    mask_g = _set_rows(mask_g, tslot, True, fc)

    new_table = FeatureTable(fid=fid, start=start, obs=obs_g, uv=uv_g,
                             vel=vel_g, mask=mask_g, depth=depth,
                             solve_flag=solve_flag)

    used_num = new_table.used_num
    end = new_table.start + used_num - 1
    c1 = torch.clamp(fc - 2, 0, W - 1)
    c2 = torch.clamp(fc - 1, 0, W - 1)
    cond = (new_table.fid >= 0) & (new_table.start <= fc - 2) & (end >= fc - 1)
    p_i = new_table.obs.index_select(1, c1.reshape(1))[:, 0]
    p_j = new_table.obs.index_select(1, c2.reshape(1))[:, 0]
    u_i = p_i[:, 0] / torch.clamp(p_i[:, 2], min=1e-6)
    v_i = p_i[:, 1] / torch.clamp(p_i[:, 2], min=1e-6)
    du = u_i - p_j[:, 0]
    dv = v_i - p_j[:, 1]
    par = torch.sqrt(du * du + dv * dv)
    parallax_num = torch.sum(cond)
    parallax_sum = torch.sum(torch.where(cond, par, torch.zeros_like(par)))
    mean_par = parallax_sum / torch.clamp(parallax_num, min=1)

    is_kf = ((fc < 2) | (last_track_num < 20) | (parallax_num == 0)
             | (mean_par >= min_parallax_norm))
    return AddResult(new_table, is_kf, last_track_num, mean_par)


# Triangulation solver, a module global with the reference's name and
# default, read at call time: the closed-form adjugate solve, or the
# smallest eigenvector of the batched 4x4 normal matrix.
ADJUGATE_TRIANGULATION = True


def triangulate(table: FeatureTable, p, q, ex_t, ex_q, init_depth,
                window_size: int = W - 1, td=0.0) -> FeatureTable:
    """Multi-view DLT for eligible features without a depth, solved as the
    inhomogeneous 3x3 normal equations in closed form (adjugate) with the
    relative conditioning gate of the reference, or (ADJUGATE_TRIANGULATION
    False) as the smallest eigenvector of the 4x4 normal matrix, whose
    depth ratio does not depend on the eigenvector's sign."""
    dtype = p.dtype
    elig = (table.fid >= 0) & (table.used_num >= 2) & (table.start < window_size - 2)
    need = elig & (table.depth <= 0)

    R_wb = rot.quat_to_rot(q)
    R_wc = R_wb @ rot.quat_to_rot(ex_q)[None]
    t_wc = p + torch.einsum("wij,j->wi", R_wb, ex_t)
    start = torch.clamp(table.start, 0, W - 1).long()
    R0 = R_wc[start]
    t0 = t_wc[start]
    R_rel = torch.einsum("fji,wjk->fwik", R0, R_wc)
    t_rel = torch.einsum("fji,fwj->fwi", R0, t_wc[None] - t0[:, None])
    P_rot = R_rel.transpose(-1, -2)
    P_t = -torch.einsum("fwij,fwj->fwi", P_rot, t_rel)
    P = torch.cat([P_rot, P_t[..., None]], dim=-1)               # (F, 11, 3, 4)

    td = torch.as_tensor(td, dtype=dtype, device=p.device)
    obs_c = torch.cat([table.obs[..., :2] - td * table.vel, table.obs[..., 2:]], dim=-1)
    f = obs_c / torch.clamp(torch.linalg.vector_norm(obs_c, dim=-1, keepdim=True), min=1e-9)
    row0 = f[..., 0:1] * P[..., 2, :] - f[..., 2:3] * P[..., 0, :]
    row1 = f[..., 1:2] * P[..., 2, :] - f[..., 2:3] * P[..., 1, :]
    m = table.mask.to(dtype)[..., None]
    rows = torch.cat([row0 * m, row1 * m], dim=1)
    AtA = torch.einsum("fri,frj->fij", rows, rows)
    init_d = torch.as_tensor(init_depth, dtype=dtype, device=p.device)
    if ADJUGATE_TRIANGULATION:
        M = AtA[:, :3, :3]
        b = -AtA[:, :3, 3]
        cof = torch.stack([
            torch.linalg.cross(M[:, 1], M[:, 2], dim=-1),
            torch.linalg.cross(M[:, 2], M[:, 0], dim=-1),
            torch.linalg.cross(M[:, 0], M[:, 1], dim=-1),
        ], dim=-1)
        det = torch.einsum("fi,fi->f", M[:, 0], cof[:, :, 0])
        scale3 = (torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / 3.0) ** 3
        ill = det <= 1e-6 * torch.clamp(scale3, min=1e-30)
        x = torch.einsum("fij,fj->fi", cof, b) / torch.where(ill, torch.ones_like(det), det)[:, None]
        depth = torch.where(ill, init_d, x[:, 2])
    else:
        vmin = eigh64(AtA)[1][..., 0]
        w = vmin[:, 3]
        depth = vmin[:, 2] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    depth = torch.where(depth < 0.1, init_d, depth)
    return table._replace(depth=torch.where(need, depth.to(dtype), table.depth))


def _shift_left(a: torch.Tensor) -> torch.Tensor:
    """Drop window column 0, shift 1..10 -> 0..9, clear column 10."""
    return torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)


def _free_slots(table: FeatureTable, free: torch.Tensor) -> FeatureTable:
    def z(a, fill):
        c = free.reshape((-1,) + (1,) * (a.dim() - 1))
        return torch.where(c, torch.full_like(a, fill), a)

    return FeatureTable(fid=z(table.fid, -1), start=z(table.start, 0),
                        obs=z(table.obs, 0.0), uv=z(table.uv, 0.0),
                        vel=z(table.vel, 0.0), mask=z(table.mask, False),
                        depth=z(table.depth, -1.0),
                        solve_flag=z(table.solve_flag, 0))


def slide_old(table: FeatureTable, shift_depth: bool, marg_R_wc, marg_t_wc,
              new_R_wc, new_t_wc, init_depth, td=0.0) -> FeatureTable:
    """removeBackShiftDepth (shift_depth) / removeBack."""
    anchored = (table.fid >= 0) & (table.start == 0)
    td = torch.as_tensor(td, dtype=table.obs.dtype, device=table.obs.device)
    ray0 = torch.cat([table.obs[:, 0, :2] - td * table.vel[:, 0],
                      table.obs[:, 0, 2:]], dim=-1)
    old_depth = table.depth
    new_mask = _shift_left(table.mask.to(torch.int32)).bool()
    new_start = torch.where(anchored, torch.zeros_like(table.start),
                            torch.clamp(table.start - 1, min=0))
    used_after = torch.sum(new_mask, dim=1)
    min_keep = 2 if shift_depth else 1
    free = (table.fid >= 0) & anchored & (used_after < min_keep)

    init_d = torch.as_tensor(init_depth, dtype=old_depth.dtype, device=old_depth.device)
    pts_i = ray0 * torch.where(old_depth > 0, old_depth, init_d)[:, None]
    w_pts = torch.einsum("ij,fj->fi", marg_R_wc, pts_i) + marg_t_wc
    pts_j = torch.einsum("ji,fj->fi", new_R_wc, w_pts - new_t_wc)
    dep_j = pts_j[:, 2]
    reanchored = torch.where(dep_j > 0, dep_j, init_d)
    keep_anchor = anchored & ~free
    new_depth = torch.where(keep_anchor & (old_depth > 0) if shift_depth
                            else torch.zeros_like(keep_anchor),
                            reanchored, table.depth)
    out = FeatureTable(fid=table.fid, start=new_start,
                       obs=_shift_left(table.obs), uv=_shift_left(table.uv),
                       vel=_shift_left(table.vel), mask=new_mask,
                       depth=new_depth, solve_flag=table.solve_flag)
    return _free_slots(out, free)


def slide_new(table: FeatureTable) -> FeatureTable:
    """removeFront(WINDOW_SIZE): slot W's observation replaces slot W-1."""
    def move(a):
        a = a.clone()
        a[:, W - 2] = a[:, W - 1]
        a[:, W - 1] = 0
        return a

    new_mask = move(table.mask)
    new_start = torch.where(table.start == W - 1,
                            torch.full_like(table.start, W - 2), table.start)
    free = (table.fid >= 0) & (torch.sum(new_mask, dim=1) == 0)
    out = table._replace(obs=move(table.obs), uv=move(table.uv),
                         vel=move(table.vel), mask=new_mask, start=new_start)
    return _free_slots(out, free)


def remove_failures(table: FeatureTable) -> FeatureTable:
    return _free_slots(table, (table.fid >= 0) & (table.solve_flag == 2))
