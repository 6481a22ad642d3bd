#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs:

0. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; exits with code 42 when no CUDA device is present.
1. build: compiles the LK kernels (mobile_slam_tpu_torch/csrc) with nvcc.
2. kernels: each LK kernel against its plain PyTorch version on the card,
   at the shapes of the main path (two consecutive 512x512 bench frames,
   their 4-level pyramids, 160 slots from the corner detector, a few
   inactive), held to the parity bars of the CPU tests; both timed with
   CUDA events (median of 30 runs after warm-up).
3. main path: the port's VIOEngine on the bench configuration (KB fisheye
   512x512, 160 slots, 384 landmarks, 2 LM iterations) over the bench's
   synthetic sequence until TRACKING plus 45 frames; checks the status,
   the poses (finite, ATE Sim3 < 0.05 m against ground truth) and that
   every tracker frame launched K1 once, K2 twice and K3 twice.

Prints a JSON line of per-kernel results, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}. Any failed check raises.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

SOURCE = "mobile_slam_tpu_torch/csrc/lk_kernels.cu"
REPLACES = {
    "track_pyramidal": "mobile_slam_tpu/ops/lk_pallas.py:490",
    "refine_template": "mobile_slam_tpu/ops/lk_pallas.py:763",
    "extract_patches": "mobile_slam_tpu/ops/lk_pallas.py:884",
}
POS_TOL = 0.02      # px, K1/K2 position bar
RESID_TOL = 0.05    # K2 residual bar (0..255 scale)
PATCH_TOL = 1e-3    # K3 patch bar
ATE_TOL = 0.05      # m, Sim3-aligned
EXTRA_FRAMES = 45   # tracking frames after initialization
NO_DEVICE = 42      # exit code without a CUDA device (tests/test_torch_cuda.py skips)


def _time_ms(fn, reps=30, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def phase_device() -> str:
    print(f"[phase 0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        print("[phase 0] no CUDA device: torch.cuda.is_available() is False",
              flush=True)
        sys.exit(NO_DEVICE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(f"[phase 0] device {torch.cuda.get_device_name(0)} | {smi[0]}",
          flush=True)
    return smi[0]


def phase_kernels(lk, data, cam, cfg, sim, example):
    """Kernel vs plain version at main-path shapes."""
    from mobile_slam_tpu_torch.frontend import tracker as trk
    from mobile_slam_tpu_torch.ops import corners

    dev = "cuda"
    tcfg = cfg.tracker
    win = tcfg.lk_window_size
    frames = [torch.as_tensor(sim.render_frame(data, fi, cam, example.R_IC,
                                               cfg.camera.t_ic_vec),
                              dtype=torch.float32, device=dev) for fi in (20, 21)]
    img0, pyr0, resp0 = trk.preprocess_frame(frames[0], tcfg)
    img1, pyr1, _ = trk.preprocess_frame(frames[1], tcfg)
    pts, valid = corners.detect_grid(resp0, tcfg.min_dist, tcfg.max_points,
                                     quality_level=tcfg.quality_level)
    active = valid.clone()
    active[::16] = False
    n_live = int(active.sum())
    print(f"[phase 2] {pts.shape[0]} slots, {n_live} active, levels "
          f"{[tuple(p.shape) for p in pyr0]}", flush=True)
    params = lk.LKParams(window=win, levels=tcfg.lk_pyramid_levels,
                         iters=tcfg.lk_iterations, eps=tcfg.lk_eps)
    results = {}

    # K1
    pos_k, ok_k = lk._track_pyramidal_cuda(pyr0, pyr1, pts, active, params)
    pos_p, ok_p = lk.track_pyramidal_ref(pyr0, pyr1, pts, active, params)
    torch.cuda.synchronize()
    both = ok_k & ok_p
    _check(bool((ok_k == ok_p).all()), "K1 ok masks differ")
    _check(int(both.sum()) >= n_live // 2, f"K1 tracked only {int(both.sum())}")
    err1 = float((pos_k - pos_p)[both].norm(dim=-1).max())
    _check(err1 < POS_TOL, f"K1 position difference {err1} px")
    results["track_pyramidal"] = dict(
        max_abs_err=err1,
        ms=_time_ms(lambda: lk._track_pyramidal_cuda(pyr0, pyr1, pts, active, params)),
        plain_ms=_time_ms(lambda: lk.track_pyramidal_ref(pyr0, pyr1, pts, active, params)))

    # K3 at the tracked points of the new frame (the FB template, tracker.py:205)
    new_pts = pos_k
    t_k = lk._extract_patches_cuda(img1, new_pts, win)
    t_p = lk.extract_patches_ref(img1, new_pts, win)
    err3 = max(float((a - b).abs().max()) for a, b in zip(t_k, t_p))
    _check(err3 < PATCH_TOL, f"K3 patch difference {err3}")
    results["extract_patches"] = dict(
        max_abs_err=err3,
        ms=_time_ms(lambda: lk._extract_patches_cuda(img1, new_pts, win)),
        plain_ms=_time_ms(lambda: lk.extract_patches_ref(img1, new_pts, win)))

    # K2 at both tracker settings: FB backward pass and anchor refinement.
    anchor = lk.extract_patches_ref(img0, pts, win)
    settings = {
        "fb": (pyr0[0], t_p, pts, tcfg.lk_iterations, 2.0 + tcfg.fb_max_err),
        "anchor": (img1, anchor, new_pts, tcfg.anchor_iters, tcfg.anchor_max_shift),
    }
    err2, times = 0.0, {}
    for name, (img, tmpl, start, iters, max_shift) in settings.items():
        args = (img, *tmpl, start, ok_k, win, iters, tcfg.lk_eps, max_shift)
        pk, okk, rk = lk._refine_template_cuda(*args)
        pp, okp, rp = lk.refine_template_ref(*args)
        torch.cuda.synchronize()
        _check(bool((okk == okp).all()), f"K2 ({name}) ok masks differ")
        m = okk & okp
        dpos = float((pk - pp)[m].norm(dim=-1).max())
        dres = float((rk - rp)[m].abs().max())
        _check(dpos < POS_TOL, f"K2 ({name}) position difference {dpos} px")
        _check(dres < RESID_TOL, f"K2 ({name}) residual difference {dres}")
        err2 = max(err2, dpos, dres)
        times[name] = (_time_ms(lambda: lk._refine_template_cuda(*args)),
                       _time_ms(lambda: lk.refine_template_ref(*args)))
        print(f"[phase 2] K2 {name}: iters {iters} max_shift {max_shift} "
              f"ok {int(m.sum())} pos diff {dpos:.3g} px resid diff {dres:.3g} "
              f"kernel {times[name][0]:.4f} ms plain {times[name][1]:.4f} ms",
              flush=True)
    results["refine_template"] = dict(
        max_abs_err=err2, ms=times["fb"][0], plain_ms=times["fb"][1],
        ms_anchor=times["anchor"][0], plain_ms_anchor=times["anchor"][1])
    for name in ("track_pyramidal", "extract_patches"):
        r = results[name]
        print(f"[phase 2] {name}: max err {r['max_abs_err']:.3g} kernel "
              f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms", flush=True)
    return results


def phase_main_path(lk, data, cam, cfg, sim, example):
    from mobile_slam_tpu_torch.engine.vio_engine import Status, VIOEngine
    from mobile_slam_tpu_torch.eval.evaluator import compute_ate

    engine = VIOEngine(cfg, device="cuda", dtype=torch.float32)
    est_ts, est_p = [], []
    imu_i, init_frame, n_frames = 0, None, 0
    frame_ms, at_init = [], None
    lk.reset_launch_counts()
    for fi in range(len(data.frames)):
        img = sim.render_frame(data, fi, cam, example.R_IC, cfg.camera.t_ic_vec)
        ts = data.cam_ts[fi]
        while imu_i < len(data.imu_ts) and data.imu_ts[imu_i] <= ts + 1e-9:
            engine.push_imu(data.imu_ts[imu_i], data.imu_acc[imu_i],
                            data.imu_gyr[imu_i])
            imu_i += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.process_frame(img, ts)
        torch.cuda.synchronize()
        dt_ms = 1e3 * (time.perf_counter() - t0)
        n_frames += 1
        if init_frame is not None:
            frame_ms.append(dt_ms)
        if res.ok:
            p, _, _ = engine.get_body_state()
            est_ts.append(ts)
            est_p.append(p)
        if init_frame is None and res.status == Status.TRACKING:
            init_frame = fi
            at_init = dict(lk.launch_counts)
            print(f"[phase 3] TRACKING at frame {fi}", flush=True)
        if init_frame is not None and fi >= init_frame + EXTRA_FRAMES:
            break
    counts = dict(lk.launch_counts)

    _check(init_frame is not None, "the engine never reached TRACKING")
    est_p = np.asarray(est_p)
    _check(len(est_p) >= 30, f"only {len(est_p)} ok poses")
    _check(bool(np.isfinite(est_p).all()), "non-finite poses")
    per_frame = {"track_pyramidal": 1, "refine_template": 2, "extract_patches": 2}
    n_track = n_frames - 1 - init_frame
    for k, n in per_frame.items():
        _check(counts[k] == n * n_frames,
               f"{k}: {counts[k]} launches over {n_frames} frames")
        _check(counts[k] - at_init[k] == n * n_track,
               f"{k}: {counts[k] - at_init[k]} launches over {n_track} tracking frames")
    ate = compute_ate(np.asarray(est_ts), est_p, data.cam_ts, data.gt_p)
    _check(ate.rmse < ATE_TOL, f"ATE {ate.rmse} m")
    print(f"[phase 3] init frame {init_frame}, {n_frames} frames, {len(est_p)} "
          f"poses, ATE sim3 rmse {ate.rmse:.4f} m over {ate.num_pairs} pairs, "
          f"median {np.median(frame_ms):.2f} ms per tracking frame "
          f"(p90 {np.percentile(frame_ms, 90):.2f} ms), launches {counts}",
          flush=True)
    return counts


def main() -> int:
    smi_line = phase_device()
    from mobile_slam_tpu_torch.engine import example
    from mobile_slam_tpu_torch.engine.vio_engine import set_full_precision
    from mobile_slam_tpu_torch.eval import simulation as sim
    from mobile_slam_tpu_torch.models.cameras.base import make_camera
    from mobile_slam_tpu_torch.ops import lk

    set_full_precision()
    t0 = time.perf_counter()
    lk.build_kernels()
    print(f"[phase 1] built {SOURCE} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    cfg = example.bench_config()
    cam = make_camera(cfg.camera, dtype=torch.float64)
    data = sim.simulate(example.bench_sim_config(8.0), cam,
                        cfg.camera.r_ic_mat, cfg.camera.t_ic_vec)
    kernels = phase_kernels(lk, data, cam, cfg, sim, example)
    counts = phase_main_path(lk, data, cam, cfg, sim, example)
    _check("jax" not in sys.modules, "jax was imported")

    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=SOURCE, replaces=REPLACES[k],
             launches=counts[k], **kernels[k]) for k in REPLACES]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
