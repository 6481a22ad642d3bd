"""Feature tracker — the per-frame image pipeline (torch twin of
mobile_slam_tpu.frontend.tracker).

CLAHE -> pyramid -> pyramidal LK (K1) -> border mask -> prior-initialized
forward-backward check (K3 + K2) -> anchor-template refinement (K2) ->
motion-gated F-RANSAC with edge recovery -> grid dedup -> Shi-Tomasi
refill -> anchor re-extraction (K3) -> undistortion + velocity -> ids.

The LK operations dispatch on the device of the tensors (ops/lk.py): CUDA
tensors go through the hand-written kernels, CPU tensors through their
plain versions; ``TrackerConfig.use_pallas`` has no meaning here. The
reference's two ``lax.cond``s (RANSAC, refill) are computed branch-free
and selected with ``torch.where``, which gives the same result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mobile_slam_tpu_torch.config import TrackerConfig
from mobile_slam_tpu_torch.models.cameras.base import Camera
from mobile_slam_tpu_torch.ops import clahe as clahe_op
from mobile_slam_tpu_torch.ops import corners, image as im, lk, ransac
from mobile_slam_tpu_torch.utils import logging as slog


class TrackerState(NamedTuple):
    pyr: tuple                 # previous frame pyramid (levels+1 tensors)
    pts: torch.Tensor          # (K, 2)
    norm_pts: torch.Tensor     # (K, 2)
    ids: torch.Tensor          # (K,) int32
    track_cnt: torch.Tensor    # (K,) int32
    active: torch.Tensor       # (K,) bool
    next_id: torch.Tensor      # () int32
    prev_ts: torch.Tensor      # ()
    has_prev: torch.Tensor     # () bool
    anchor_tp: torch.Tensor    # (K, win*win)
    anchor_gx: torch.Tensor
    anchor_gy: torch.Tensor


class TrackerOutput(NamedTuple):
    ids: torch.Tensor          # (K,)
    obs: torch.Tensor          # (K, 3) unit-z rays
    uv: torch.Tensor           # (K, 2)
    vel: torch.Tensor          # (K, 2)
    valid: torch.Tensor        # (K,)
    num_tracked: torch.Tensor


def init_tracker_state(cfg: TrackerConfig, height: int, width: int,
                       dtype=torch.float32, *, device) -> TrackerState:
    K = cfg.max_points
    kw = dict(dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    p = cfg.lk_window_size * cfg.lk_window_size
    return TrackerState(
        pyr=tuple(torch.zeros((height // 2 ** l, width // 2 ** l), **kw)
                  for l in range(cfg.lk_pyramid_levels + 1)),
        pts=torch.zeros((K, 2), **kw), norm_pts=torch.zeros((K, 2), **kw),
        ids=torch.full((K,), -1, **i32), track_cnt=torch.zeros((K,), **i32),
        active=torch.zeros((K,), dtype=torch.bool, device=device),
        next_id=torch.zeros((), **i32), prev_ts=torch.zeros((), **kw),
        has_prev=torch.zeros((), dtype=torch.bool, device=device),
        anchor_tp=torch.zeros((K, p), **kw), anchor_gx=torch.zeros((K, p), **kw),
        anchor_gy=torch.zeros((K, p), **kw),
    )


def _grid_cell_dedup(pts, active, track_cnt, min_dist, width, height):
    """setMask: within each min_dist cell keep the highest-track_cnt point
    (ties to the lower slot)."""
    K = pts.shape[0]
    dev = pts.device
    gw = -(-width // min_dist)
    gh = -(-height // min_dist)
    cx = torch.clamp(torch.div(pts[:, 0], min_dist, rounding_mode="floor").long(), 0, gw - 1)
    cy = torch.clamp(torch.div(pts[:, 1], min_dist, rounding_mode="floor").long(), 0, gh - 1)
    cell = torch.where(active, cy * gw + cx, gh * gw)
    prio = (track_cnt.long() * (K + 1) + (K - torch.arange(K, device=dev)))
    best = torch.zeros(gh * gw + 1, dtype=torch.long, device=dev).scatter_reduce(
        0, cell, torch.where(active, prio, 0), reduce="amax")
    return active & (prio == best[cell])


def _virtual_pinhole(camera: Camera, pts, focal, cx, cy):
    ray = camera.lift_normalized(pts)
    return torch.stack([focal * ray[..., 0] + cx, focal * ray[..., 1] + cy], dim=-1)


def preprocess_frame(img: torch.Tensor, cfg: TrackerConfig):
    """CLAHE, pyramid, Shi-Tomasi response (+ fisheye border mask)."""
    h, w = img.shape
    if cfg.equalize:
        img = clahe_op.clahe(img, clip_limit=3.0, tiles=8)
    pyr = tuple(im.build_pyramid(img, cfg.lk_pyramid_levels))
    response = corners.min_eig_response(img)
    if cfg.fisheye:
        yy = torch.arange(h, dtype=img.dtype, device=img.device)[:, None] - h / 2.0
        xx = torch.arange(w, dtype=img.dtype, device=img.device)[None, :] - w / 2.0
        rad = torch.sqrt(yy * yy + xx * xx)
        response = torch.where(rad < min(h, w) / 2.0 - 4.0, response,
                               torch.zeros_like(response))
    return img, pyr, response


@slog.traced("track")
def detect_and_track(state: TrackerState, img: torch.Tensor, ts, camera: Camera,
                     cfg: TrackerConfig, focal: float, *,
                     generator: torch.Generator | None = None,
                     ransac_draws: torch.Tensor | None = None,
                     banned_ids: torch.Tensor | None = None,
                     preprocessed=None):
    """One frame. RANSAC samples come from ``ransac_draws`` (N, 8) if given,
    else from ``generator``. ``preprocessed`` is ``preprocess_frame(img,
    cfg)`` when the caller already ran it (the chunked path runs it for a
    whole chunk ahead of the frame loop). Returns (new_state,
    TrackerOutput)."""
    dtype, dev = img.dtype, img.device
    h, w = img.shape
    K = cfg.max_points
    ts = torch.as_tensor(ts, dtype=dtype, device=dev)

    if banned_ids is not None:
        banned = torch.any(state.ids[:, None] == banned_ids[None, :], dim=1) & (state.ids >= 0)
        state = state._replace(active=state.active & ~banned)

    if preprocessed is None:
        preprocessed = preprocess_frame(img, cfg)
    img, pyr, st_response = preprocessed

    params = lk.LKParams(window=cfg.lk_window_size, levels=cfg.lk_pyramid_levels,
                         iters=cfg.lk_iterations, eps=cfg.lk_eps)
    can_track = state.active & state.has_prev
    new_pts, ok = lk.track_pyramidal(state.pyr, pyr, state.pts, can_track, params)
    inside = ((new_pts[:, 0] >= 1) & (new_pts[:, 0] < w - 1)
              & (new_pts[:, 1] >= 1) & (new_pts[:, 1] < h - 1))
    active = can_track & ok & inside

    if cfg.fb_check:
        if cfg.fb_mode == "prior0":
            tp_b, gx_b, gy_b = lk.extract_patches(img, new_pts, cfg.lk_window_size)
            back_pts, ok_b, _ = lk.refine_template(
                state.pyr[0], tp_b, gx_b, gy_b, state.pts, active,
                cfg.lk_window_size, cfg.lk_iterations, cfg.lk_eps,
                2.0 + cfg.fb_max_err)
        else:
            back_pts, ok_b = lk.track_pyramidal(pyr, state.pyr, new_pts, active, params)
        fb2 = torch.sum((back_pts - state.pts) ** 2, dim=-1)
        active = active & ok_b & (fb2 <= cfg.fb_max_err ** 2)

    reanchor = torch.zeros(K, dtype=torch.bool, device=dev)
    if cfg.anchor_refine:
        ref_pos, ok_r, resid = lk.refine_template(
            img, state.anchor_tp, state.anchor_gx, state.anchor_gy, new_pts,
            active, cfg.lk_window_size, cfg.anchor_iters, cfg.lk_eps,
            cfg.anchor_max_shift)
        shift2 = torch.sum((ref_pos - new_pts) ** 2, dim=-1)
        good = (ok_r & (shift2 < (cfg.anchor_max_shift - 1e-3) ** 2)
                & (resid <= cfg.anchor_resid))
        new_pts = torch.where((active & good)[:, None], ref_pos, new_pts)
        reanchor = active & ~good

    disp2 = torch.sum((new_pts - state.pts) ** 2, dim=-1)
    n_act = torch.sum(active)
    rms = torch.sqrt(torch.sum(torch.where(active, disp2, torch.zeros_like(disp2)))
                     / torch.clamp(n_act, min=1))
    run_ransac = (n_act >= 30) & (rms >= 2.0)

    cx_v, cy_v = w / 2.0, h / 2.0
    und_prev = _virtual_pinhole(camera, state.pts, focal, cx_v, cy_v)
    und_next = _virtual_pinhole(camera, new_pts, focal, cx_v, cy_v)
    F_mat, status = ransac.find_fundamental_ransac(
        und_prev, und_next, active, cfg.f_threshold,
        num_hypotheses=cfg.ransac_iters, r=ransac_draws, generator=generator)
    status = ransac.edge_recovery(F_mat, und_prev, und_next, new_pts, status,
                                  active, cfg.f_threshold,
                                  cfg.f_threshold_edge_factor, cx_v, cy_v)
    active = active & torch.where(run_ransac, status, active)
    track_cnt = torch.where(active, state.track_cnt + 1, torch.zeros_like(state.track_cnt))

    active = _grid_cell_dedup(new_pts, active, track_cnt, cfg.min_dist, w, h)
    n_kept = torch.sum(active)

    n_needed = torch.clamp(cfg.max_cnt - n_kept, 0, K)
    response = corners.occupancy_suppression(st_response, new_pts, active, cfg.min_dist)
    cand_pts, cand_valid = corners.detect_grid(response, cfg.min_dist, K,
                                               quality_level=cfg.quality_level)
    do_detect = n_needed >= max(1, cfg.refill_min_deficit)
    cand_valid = cand_valid & do_detect
    cand_pts = torch.where(do_detect, cand_pts, torch.zeros_like(cand_pts))
    cand_rank = torch.cumsum(cand_valid.to(torch.int64), dim=0) - 1
    take = cand_valid & (cand_rank < n_needed)

    free_order = torch.argsort(active.to(torch.int32), stable=True)
    n_free = K - n_kept
    new_rank = torch.where(take, cand_rank, K)
    can_place = take & (cand_rank < n_free)
    slot = free_order[torch.clamp(new_rank, 0, K - 1)]
    slot = torch.where(can_place, slot, K)

    def place(base, vals):     # out of place: torch.func.vmap batches slot
        ext = torch.cat([base, torch.zeros_like(base[:1])], dim=0)
        return ext.index_put((slot,), vals)[:K]

    pts_out = place(new_pts, cand_pts.to(new_pts.dtype))
    ids = torch.where(active, state.ids, torch.full_like(state.ids, -1))
    ids = place(ids, (state.next_id + cand_rank).to(torch.int32))
    track_cnt = place(track_cnt, torch.ones_like(track_cnt))
    placed = place(torch.zeros(K, dtype=torch.bool, device=dev),
                   torch.ones(K, dtype=torch.bool, device=dev))
    active_out = active | placed
    next_id = state.next_id + torch.sum(can_place).to(torch.int32)

    if cfg.anchor_refine:
        tp_new, gx_new, gy_new = lk.extract_patches(img, pts_out, cfg.lk_window_size)
        upd = (placed | reanchor)[:, None]
        anchor_tp = torch.where(upd, tp_new, state.anchor_tp)
        anchor_gx = torch.where(upd, gx_new, state.anchor_gx)
        anchor_gy = torch.where(upd, gy_new, state.anchor_gy)
    else:
        anchor_tp, anchor_gx, anchor_gy = (state.anchor_tp, state.anchor_gx,
                                           state.anchor_gy)

    rays = camera.lift_normalized(pts_out)
    norm_pts = rays[:, 0:2]
    dt = ts - state.prev_ts
    vel_ok = (active & (dt > 1e-6) & state.has_prev)[:, None]
    vel = torch.where(vel_ok, (norm_pts - state.norm_pts) / torch.clamp(dt, min=1e-6),
                      torch.zeros_like(norm_pts))

    new_state = TrackerState(
        pyr=pyr, pts=pts_out, norm_pts=norm_pts, ids=ids, track_cnt=track_cnt,
        active=active_out, next_id=next_id, prev_ts=ts,
        has_prev=torch.ones((), dtype=torch.bool, device=dev),
        anchor_tp=anchor_tp, anchor_gx=anchor_gx, anchor_gy=anchor_gy)
    obs = torch.cat([norm_pts, torch.ones_like(norm_pts[:, :1])], dim=-1)
    out = TrackerOutput(ids=ids, obs=obs, uv=pts_out, vel=vel,
                        valid=active_out & (track_cnt > 1),
                        num_tracked=torch.sum(active))
    return new_state, out
