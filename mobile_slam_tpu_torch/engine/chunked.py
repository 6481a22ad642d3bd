"""Chunked frame processing — the serving mode (torch twin of
mobile_slam_tpu.engine.chunked).

The reference runs a chunk of T frames as one ``lax.scan`` device program.
The port runs the same per-frame step in a Python loop over the chunk:

* state-independent image work (CLAHE, pyramid, Shi-Tomasi response) runs
  for the whole chunk before the loop, as the reference's ``vmap`` does;
* the chunk's RANSAC draws, (T, ransac_iters, 8), come from the carry's
  generator in one call before the loop (or are injected);
* poses, ``ok`` and keyframe flags stay device tensors, stacked to (T, 3),
  (T, 4), (T,) and (T,); the caller copies them to the host once;
* the scale-runaway and growth gates run on the device.

The loop's own host read per frame is the keyframe flag that picks the
marginalization branch of ``solve_and_slide`` (the reference's
``lax.cond``). ``make_image_frame_step(host_branch=False)`` keeps the flag
on the device and runs both branches instead, for ``torch.func.vmap`` (the
fleet, parallel/batch.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mobile_slam_tpu_torch.engine import estimator as est
from mobile_slam_tpu_torch.engine.vio_engine import VIOEngine
from mobile_slam_tpu_torch.frontend import tracker as trk
from mobile_slam_tpu_torch.utils import logging as slog

# Scale-runaway gate constants, shared with the streaming engine.
_DEPTH_RUNAWAY_FACTOR = VIOEngine.DEPTH_RUNAWAY_FACTOR
_VEL_RUNAWAY_FACTOR = VIOEngine.VEL_RUNAWAY_FACTOR
_DEPTH_EMA_RATE = VIOEngine.DEPTH_EMA_RATE


def scale_gate(depth_ema, vel_ema, med_depth, vel):
    """Device-side scale-runaway gate: VIOEngine._check_scale_runaway as
    tensor math (median depth AND |v| against slow EMA baselines; a zero
    depth EMA means "not seeded yet"). Returns (new_depth_ema, new_vel_ema,
    runaway)."""
    has_depth = med_depth > 0
    ema0 = torch.where(depth_ema > 0, depth_ema, med_depth)
    vema0 = torch.clamp(torch.where(depth_ema > 0, vel_ema, vel), min=0.05)
    runaway = (has_depth & (med_depth > _DEPTH_RUNAWAY_FACTOR * ema0)
               & (vel > _VEL_RUNAWAY_FACTOR * vema0))
    ema1 = torch.where(has_depth, ema0 + _DEPTH_EMA_RATE * (med_depth - ema0), depth_ema)
    vema1 = torch.where(has_depth, vema0 + _DEPTH_EMA_RATE * (vel - vema0), vel_ema)
    return ema1, vema1, runaway


# Compounding-runaway growth detector: depth AND velocity jointly exceeding
# their GROWTH_WINDOW-frame-old values by the growth factors (a viewpoint
# change moves depth but not velocity). Rings of zeros keep it off until
# they fill; the server seeds them with the streaming EMAs.
GROWTH_WINDOW = 30
DEPTH_GROWTH_FACTOR = 1.8
VEL_GROWTH_FACTOR = 1.4


def growth_gate(lag_depth, lag_vel, lag_i, med_depth, vel):
    """Lagged-ratio runaway detector. Returns (new_lag_depth, new_lag_vel,
    new_lag_i, growth). The slot at ``lag_i`` holds the
    GROWTH_WINDOW-frame-old sample (the ring is written after reading); the
    cursor stays on the device (gather/scatter, no host read)."""
    idx = lag_i.reshape(1).long()
    lagd = lag_depth.gather(0, idx)[0]
    lagv = lag_vel.gather(0, idx)[0]
    # The lagged velocity itself must be moving: an acceleration from
    # near-hover must not trip on a floored ratio.
    growth = ((lagd > 0) & (med_depth > DEPTH_GROWTH_FACTOR * lagd)
              & (lagv > 0.05) & (vel > VEL_GROWTH_FACTOR * lagv))
    new_d = torch.where(med_depth > 0, med_depth, lagd).to(lag_depth.dtype)
    new_lag_depth = lag_depth.scatter(0, idx, new_d.reshape(1))
    new_lag_vel = lag_vel.scatter(0, idx, vel.to(lag_vel.dtype).reshape(1))
    new_lag_i = (lag_i + 1) % GROWTH_WINDOW
    return new_lag_depth, new_lag_vel, new_lag_i, growth


def _frame_ok(diag: est.StepDiag):
    return diag.state_finite & (diag.vel_norm <= 10.0) & (diag.pos_norm <= 100.0)


def _unstack(stacked, t: int):
    return type(stacked)(*[x[t] for x in stacked])


def make_chunked_step(params: est.StaticParams, num_iterations: int):
    """Returns fn(state, FrameInput with leading T) -> (state, (p (T, 3),
    q (T, 4), ok (T,), is_kf (T,))): bookkeeping + solve + slide per frame
    (the feature path; NON_LINEAR phase only)."""

    def chunk(state: est.EstimatorState, inputs: est.FrameInput):
        outs = []
        for t in range(inputs.ts.shape[0]):
            state, is_kf = est.bookkeeping_step(state, _unstack(inputs, t), params)
            state, p, q, diag = est.solve_and_slide(state, bool(is_kf), params,
                                                    num_iterations)
            outs.append((p, q, _frame_ok(diag), is_kf))
        return state, tuple(torch.stack(x) for x in zip(*outs))

    return chunk


def stack_frame_inputs(inputs: list[est.FrameInput]) -> est.FrameInput:
    """Stack FrameInputs along a leading chunk axis."""
    return est.FrameInput(*[torch.stack(xs) for xs in zip(*inputs)])


class ImageFrameInput(NamedTuple):
    """Per-frame raw input of the image path: a grayscale frame and the IMU
    slice (prev_ts, ts]."""

    img: torch.Tensor      # (H, W) grayscale 0..255
    ts: torch.Tensor       # () seconds since sequence start
    imu_dt: torch.Tensor   # (M,)
    imu_acc: torch.Tensor  # (M, 3)
    imu_gyr: torch.Tensor  # (M, 3)
    imu_cnt: torch.Tensor  # () int32


class ImageChunkCarry(NamedTuple):
    est_state: est.EstimatorState
    tracker_state: trk.TrackerState
    banned_ids: torch.Tensor     # (F,) estimator outlier feedback to the tracker
    gen: torch.Generator         # RANSAC hypothesis draws
    depth_ema: torch.Tensor      # () slow median-depth baseline; 0 = not seeded
    vel_ema: torch.Tensor        # () slow |v| baseline
    lag_depth: torch.Tensor      # (GROWTH_WINDOW,) growth-detector rings
    lag_vel: torch.Tensor
    lag_i: torch.Tensor          # () ring cursor


def make_image_frame_step(params: est.StaticParams, num_iterations: int,
                          tracker_cfg, camera, focal: float, *,
                          host_branch: bool = True):
    """The full per-frame image-path step: tracker (CLAHE -> pyramid -> LK
    K1 + FB K3/K2 + anchor K2/K3 -> F-RANSAC -> refill -> undistort), then
    bookkeeping + solve + slide and the two gates.

    Returns fn(carry, ImageFrameInput, preprocessed, ransac_draws (N, 8)) ->
    (carry, (p (3,), q (4,), ok (), is_kf ())); ``preprocessed`` may be None
    (the step then runs ``preprocess_frame`` itself). ``host_branch`` reads
    the keyframe flag on the host and runs one marginalization branch;
    False runs both and selects on the device (no host read, vmap-safe)."""

    def one_frame(carry: ImageChunkCarry, inp: ImageFrameInput, pre, draws):
        tstate, tout = trk.detect_and_track(
            carry.tracker_state, inp.img, inp.ts, camera, tracker_cfg, focal,
            ransac_draws=draws, banned_ids=carry.banned_ids, preprocessed=pre)
        dtype = carry.est_state.window.p.dtype
        finp = est.FrameInput(
            ts=inp.ts, ids=tout.ids, obs=tout.obs.to(dtype), uv=tout.uv.to(dtype),
            vel=tout.vel.to(dtype), valid=tout.valid, imu_dt=inp.imu_dt,
            imu_acc=inp.imu_acc, imu_gyr=inp.imu_gyr, imu_cnt=inp.imu_cnt)
        state, is_kf = est.bookkeeping_step(carry.est_state, finp, params)
        if host_branch:
            with slog.span("kf_flag"):
                branch = bool(is_kf)
        else:
            branch = is_kf
        state, p, q, diag = est.solve_and_slide(state, branch, params, num_iterations)
        with slog.span("gates"):
            ema1, vema1, runaway = scale_gate(carry.depth_ema, carry.vel_ema,
                                              diag.med_depth, diag.vel_norm)
            lagd, lagv, lagi, growth = growth_gate(carry.lag_depth, carry.lag_vel,
                                                   carry.lag_i, diag.med_depth,
                                                   diag.vel_norm)
            ok = _frame_ok(diag) & ~runaway & ~growth
        return (ImageChunkCarry(state, tstate, diag.culled_ids, carry.gen, ema1,
                                vema1, lagd, lagv, lagi),
                (p, q, ok, is_kf))

    return one_frame


def make_chunked_image_step(params: est.StaticParams, num_iterations: int,
                            tracker_cfg, camera, focal: float):
    """The full image path over a T-frame chunk: make_image_frame_step in a
    loop, the chunk's image preprocessing and RANSAC draws ahead of it.

    Returns fn(carry, ImageFrameInput with leading T, ransac_draws=None) ->
    (carry, (p (T, 3), q (T, 4), ok (T,), is_kf (T,))). ``ransac_draws``
    (T, N, 8) replaces the draws from ``carry.gen``."""
    one_frame = make_image_frame_step(params, num_iterations, tracker_cfg,
                                      camera, focal)

    def chunk(carry: ImageChunkCarry, inputs: ImageFrameInput, ransac_draws=None):
        n = inputs.img.shape[0]
        with slog.span("preprocess"):
            pre = [trk.preprocess_frame(inputs.img[t], tracker_cfg) for t in range(n)]
            if ransac_draws is None:
                ransac_draws = torch.randint(
                    0, 1 << 30, (n, tracker_cfg.ransac_iters, 8), generator=carry.gen,
                    device=inputs.img.device)
        outs = []
        for t in range(n):
            with slog.span("frame", request=slog.frame_request(t), index=t):
                carry, out = one_frame(carry, _unstack(inputs, t), pre[t], ransac_draws[t])
            outs.append(out)
        return carry, tuple(torch.stack(x) for x in zip(*outs))

    return chunk


def stack_image_inputs(inputs: list[ImageFrameInput], device) -> ImageFrameInput:
    """Stack host ImageFrameInputs along a leading chunk axis and move each
    field to ``device`` in one copy."""
    return ImageFrameInput(*[torch.stack(xs).to(device) for xs in zip(*inputs)])
