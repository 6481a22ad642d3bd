#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs:

0. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; exits with code 42 when no CUDA device is present.
1. build: compiles every CUDA source of the port (mobile_slam_tpu_torch/
   csrc: the LK kernels and the probe kernels), one nvcc each, all in
   parallel, and prints what ptxas says of each kernel and how many of
   each kernel's global loads its machine code (cuobjdump) keeps inside
   loops; fails if P2's noarith mode keeps fewer per-step loads than full.
2. kernels: each LK kernel (K1-K3) against its plain PyTorch version on the
   card, at the shapes of the main path (two consecutive 512x512 bench
   frames, their 4-level pyramids, 160 slots from the corner detector, a few
   inactive), held to the parity bars of the CPU tests; the wrapper (layout
   glue + launch; also through its torch.library custom op, the path the
   tracker takes) and the plain version timed with CUDA events around each
   call, the launch alone on prepared inputs from a CUDA graph replay
   (device time only); the least time the card could take (bound) from
   this run's inputs and iteration counts (each kernel counts only the
   image pixels its blocks read: K1's templates and the windows its steps
   sweep at every level, K2's step and end-point windows, K3's blocks,
   and in phase 5 P2's). K1 and K2 also: the steps of the
   slowest point (their dependent chain), the device time of one step from
   two runs with the step count fixed, and the chain floor the two give.
   Every wrapper's prep is checked to hand over the caller's images
   uncopied. Then K1, K2 and K3 on a second, small set from a numpy seed
   that the bench pair does not reach: the run-time-window body (15, 31), 1
   and 3 levels, odd sides, points at and beyond every border, a NaN point
   (K3's patches NaN on both sides), one live slot alone, the iteration
   cap; same bars.
3. streaming path: the port's VIOEngine on the bench configuration (KB
   fisheye 512x512, 160 slots, 384 landmarks, 2 LM iterations) over the
   bench's synthetic sequence until TRACKING plus EXTRA_FRAMES frames;
   checks the status, the poses (finite, ATE Sim3 < 0.05 m) and that every
   tracker frame launched K1 once, K2 twice and K3 twice; counts the host
   syncs of a few tracking frames.
4. serving path: ChunkedImageServer over the bench's 300-frame image-path
   stretch (stream until TRACKING + 3 frames, then chunks of 50, the last
   one padded by flush); checks that it enters chunked mode, >= 200 finite
   poses, ATE Sim3 < 0.05 m, and K1/K2/K3 at exactly 1/2/2 launches per
   frame of the chunk loop and per streamed frame; counts the host syncs
   of one chunk.
5. probes: P1 (call overhead) and P2 (LK cost attribution) against their
   plain versions (P1 exact on inputs where its block sum shows; P2 on the
   reference's noise pair and on the bench frame pair of phase 2: full
   within 0.02 px, the other modes' displacement within 1e-6 px, every
   mode's witness within 1e-4 relative), then
   their drivers: ms/step against launches per step eagerly and under a
   CUDA graph, and ms per call of each P2 mode with the attribution, on
   both pairs; P2 full's device time per step and its fixed part (slope of
   two step counts, as K1's in phase 2).

6. file-driven entry point: writes a 7 s synthetic EuRoC-layout sequence
   (io/synthetic.py, noise, seed 7, 141 frames) and runs
   ``cli.main([configs/tum_vi_room1.yaml pointed at it, "--pipelined"])``
   in process, from _chip_scratch/phase6/ (its logs/<ts>/ land there); checks
   the run directory's files, that the engine ran on the card, K1/K2/K3 at
   1/2/2 launches per frame, >= 100 finite poses, ATE Sim3 < 0.05 m and
   finite map points; then a synchronous run, a run to a checkpoint at
   frame 100 and a run resumed from it: the resumed run gives the
   uninterrupted run's poses at the same timestamps, exactly (the card
   runs this path deterministically), and the pipelined run's poses lie
   within 1e-4 m of the synchronous run's (the bar of
   tests/test_cross_path_parity.py); counts the host syncs of a few pipelined and
   synchronous tracking frames; prints measure_device_step(50) on the
   bench sequence's features.

7. the fleet (parallel/batch.py): K1, K2 and K3 at B = 4 (phase 2's bench
   pair and three more pairs of the bench sequence), one batched launch
   against 4 single launches on the same inputs (bit-equal), against the
   vmap rule's one launch (bit-equal) and against the plain versions
   (phase 2's bars), timed and bounded as in phase 2; then the image fleet
   at B = 4 on the bench configuration: four stretches of the bench's
   300-frame sequence from frames 0, 20, 40, 60, each with its own RANSAC
   seed, streamed to chunked mode by its own ChunkedImageServer, their
   carries stacked and run through make_batched_image_step for 1 chunk of
   50 frames (2 before phase 11 came): every pose finite, each sequence's
   ATE Sim3 < 0.05 m, its
   first 3 fleet frames within 1e-4 m of its own single-stream chunk run
   with the same keyframe flags, K1/K2/K3 at 1/2/2 launches per fleet
   frame whatever B is; fleet fps, ms per fleet frame, host syncs per fleet
   frame, beside phase 4's chunked fps. Then the feature fleet at B = 8:
   the bench's feature-path state after initialization, each sequence fed
   the feature chunks with its own seeded pixel noise through
   make_batched_chunked_step, held against its own make_chunked_step run
   over the first 25 frames (first 3 frames within 1e-4 m with the same
   keyframe flags at float64, every frame finite and within 0.05 m).
   Phase 7 hands its sequences (the carries before its fleet ran, the
   frames, its float64 and float32 results) to phase 11.

8. the phone entry point (mobile_slam_tpu_torch/web/gateway.py): K1, K2
   and K3 at the gateway's mobile_default shapes (two frames of phase 8's
   sequence, 640x480 pinhole, 3 pyramid images, window 15 through the
   run-time-window body, 160 slots) against their plain versions and
   timed and bounded as in phase 2; then the gateway on the card, served
   in a thread on 127.0.0.1 and driven by the port's WebSocket client over
   a 4 s phone sequence (the profile's 30 fps, 200 Hz IMU / 7 = 28.6 fps,
   115 frames; io/synthetic.py's noise, seed 7; 15 ms camera-IMU offset):
   configure (mobile_default, the camera looking forward, estimate_td on),
   binary IMU batches and frames, then reset, get_map_points, dispose.
   Checks: no error message, TRACKING, at least half the frames after it
   ok, every pose SE(3), map points with every 10th frame while tracking,
   none after reset, ATE Sim3 < 0.05 m, td finite and within +-td_max on
   every tracking frame, K1/K2/K3 at 1/2/2 launches per frame, the
   handler and server threads ended; prints td, proc_ms, the session's
   fps and the host syncs of a few tracking frames.

9. the estimator's options, the other cameras and the landmark-sharded
   step: (a) from phase 3's last tracking state, solve_and_slide (keyframe
   branch, 8 LM iterations) at float64 under each arm (the default,
   EARLY_EXIT_FTOL 0 and 1e-6, GREEDY_GN, BATCH_CANDIDATES, the dense-eigh
   prior with and without RESTRICTED_SUPPORT, eigh triangulation): ftol 0
   bit-equal to the default, ftol 1e-6 no more accepted steps and poses
   within 1e-5, BATCH_CANDIDATES the same steps and poses within 1e-8,
   GREEDY_GN's cost within 1.05x and poses within 1e-3; the dense margin-new
   (eigen threshold at machine level) and the square-root one within 1e-6
   as J0ᵀJ0 / J0ᵀr0, the restricted prior and the dense one within 1e-6, the
   dense margin-old on the card and on the CPU within 1e-6 (the dense and
   square-root margin-old part by more on this state: printed); then at
   float32 each arm's ms per call (median of 10), host syncs per call and
   LM iterations run; (b) F-RANSAC with LU and eigh hypotheses on phase 2's
   bench pair (K1's tracks), the same draws: inliers, the inliers' median
   epipolar distance and ms per call, and at float64 the card's result
   against the CPU's (inliers equal, F within 1e-6); (c) a 4 s Mei sequence
   (752x480, xi 0.95, io/synthetic.py's noise, seed 7) streamed through
   VIOEngine on the card: TRACKING, ATE Sim3 < 0.05 m, K1/K2/K3 at 1/2/2
   launches per frame; a Scaramuzza lift / project on the card against
   float64 on the CPU; (d) parallel/tp_solver.tp_damped_step at world size
   1 over NCCL against lm._solve_damped on the same equations (float64,
   1e-9 relative).

10. calibration and the adversarial tier: (a) calibrate_from_board at
   float64 on the card for four cameras (EuRoC's pinhole 752x480, TUM-VI's
   Kannala-Brandt 512x512, the Mei camera of phase 9, the reference test's
   Scaramuzza camera), each from 25 views of a 9x6 board (1,350 corners,
   0.1 px noise) rendered as tests/test_calibration_bootstrap.py renders
   them: the reference test's bars on the result, the same call on the
   CPU within 0.02 px on every corner and 1e-6 on the RMS; prints ms per
   call and per Gauss-Newton iteration and the RMS before (the bootstrap)
   and after; the bundle's Jacobian timed in forward and reverse mode;
   refine_extrinsics and an 8-view calibrate_camera_odometry against their
   ground truth (the reference tests' bars). (b) the adversarial curve
   through ChunkedImageServer as bench.py's _image_path_recovering runs it
   (bench_config, float32, chunks of 25, bench.py's SimConfig, seed 11):
   level 0 over 6 s (ATE Sim3 < 0.05 m), level 2 over 12 s (every pose
   finite); prints poses, ATE, fps, render seconds, recoveries and the
   host-clock ms of each failed-tail replay; K1/K2/K3 at 1/2/2 launches per
   chunk-loop and streamed frame, replays included. (c) a failed chunk tail
   replayed: 4 s of the bench sequence through ChunkedImageServer in
   chunks of 25, the first chunk's last 10 frames blank with a 150 m/s^2
   accelerometer knock (the camera covered, the phone knocked): at least
   one recovery, the failed frames replayed through
   process_frame(imu_override=) with their own IMU slices, finite poses
   after the recovery and a chunk after it; prints the replay's ms.

11. the fleet over ranks (parallel/batch.py's RankMesh, one process per
   rank through parallel/launch.py): W = max(2, cards) ranks, rank r on
   card r % cards (NCCL on distinct cards, gloo when they share one);
   (a) phase 7's image fleet at B = 4, B / W sequences per rank, from phase
   7's carries and frames: the gathered poses of the first 3 frames at
   float64 within 1e-9 m of phase 7's world-1 fleet with the same keyframe
   flags, the float32 chunk's poses finite, each sequence's ATE Sim3 < 0.05
   m, K1/K2/K3 at 1/2/2 launches per fleet frame on each rank, K1's
   shared-memory attribute set on the rank's own card, every rank holding
   the same gathered poses; prints fleet fps, per-sequence fps, ms
   and host syncs per fleet frame beside phase 7's, and the float32
   differences; (b) phase 7's feature fleet at B = 8, the same checks
   (float64 against phase 7's); (c) parallel/dryrun.dryrun_multichip(W)
   (its landmark-sharded solve only with a card per rank). No rank imports
   jax or the JAX package.
12. the flagship step unit and the user tools: (a) entry.entry(), the
   tiny configuration's feature-level step (bookkeeping_step, then
   solve_and_slide on the keyframe flag as a tensor): 3 steps built at
   float64 on the card held against the same on the CPU (computed in a
   process of its own, started with phase 0) within 1e-9 m with the same
   keyframe flags and window timestamps, then the float32 unit on
   the card: 10 steps timed (host clock, each ended by a synchronize) and
   the host syncs of 3 more counted as phase 3 counts them; (b)
   tools.compare_trajectories on phase 6's pipelined run directory and
   ground truth, its ATE printed beside phase 6's own (< 0.05 m); (c)
   tools.export_replay_dataset --duration=2 --size=256, its 41 frames read
   back through io/png and checked against its manifest; (d) 5 of those
   frames as RGB and RGBA PNG in a EuRoC layout, read through EurocDataset
   (io/png and the native loader, read_image and image_stream), equal to
   the native loader's gray frames and to its integer luma.

Prints a JSON line of per-kernel results ("launches": phase 6's pipelined
run; phases 3, 4, 7, 8, 9's Mei run, 10's adversarial arms and 11's ranks
(one count per rank) beside it,
"batched_*" the B = 4
launch of phase 7, "mobile_*" phase 8's kernel timings), the nvidia-smi
line, and as the last line {"ok": true, "device": {...}}. Any failed check
raises.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

LK_SOURCE = "mobile_slam_tpu_torch/csrc/lk_kernels.cu"
PROBE_SOURCE = "mobile_slam_tpu_torch/csrc/probe_kernels.cu"
KERNELS = {     # name -> (source, TPU kernel it replaces)
    "track_pyramidal": (LK_SOURCE, "mobile_slam_tpu/ops/lk_pallas.py:490"),
    "refine_template": (LK_SOURCE, "mobile_slam_tpu/ops/lk_pallas.py:763"),
    "extract_patches": (LK_SOURCE, "mobile_slam_tpu/ops/lk_pallas.py:884"),
    "call_overhead": (PROBE_SOURCE, "scripts/dev_call_overhead.py:45"),
    "lk_pack_probe": (PROBE_SOURCE, "scripts/dev_lk_pack_probe.py:124"),
}
LK_PER_FRAME = {"track_pyramidal": 1, "refine_template": 2, "extract_patches": 2}
POS_TOL = 0.02      # px, K1/K2/P2-full position bar
P2_DISP_TOL = 1e-6  # px, P2's other modes: constant or zero steps
P2_WIT_RTOL = 1e-4  # P2 witness: float32 sums of 8 x 441 terms, full's
                    # windows up to POS_TOL apart
RESID_TOL = 0.05    # K2 residual bar (0..255 scale)
PATCH_TOL = 1e-3    # K3 patch bar
ATE_TOL = 0.05      # m, Sim3-aligned
PIPE_TOL = 1e-4     # m, pipelined against synchronous poses
EXTRA_FRAMES = 45   # streaming tracking frames after initialization
SYNC_FRAMES = 5     # streaming tracking frames whose host syncs are counted
SERVE_SECONDS = 15.0  # the bench's image-path stretch: 300 frames at 20 fps
CHUNK = 50          # bench.py CHUNK
MIN_SERVE_POSES = 200
CLI_SECONDS = 7.0   # phase 6's synthetic sequence: 141 frames at 20 fps (10 s
                    # until phase 7 came: cut to keep the whole run near 700 s)
MIN_CLI_POSES = 100
CLI_CHECKPOINT_EVERY = 50
CLI_CHECKPOINT_AT = 100  # frames of the run that writes the snapshot
CLI_SYNC_AT = 20    # host syncs counted from the 20th tracking call
CLI_DEVICE_STEPS = 50
JAX_BAND = "0.010-0.014 m over 253 poses (BENCH_r05.json, TPU v5e)"
NO_DEVICE = 42      # exit code without a CUDA device (tests/test_torch_cuda.py skips)
FLEET_B = 4         # the image fleet (bench.py FLEET_B)
FEATURE_FLEET_B = 8  # the feature fleet (bench.py Bf)
FLEET_PAIRS = ((40, 41), (60, 61), (80, 81))  # bench frame pairs beside phase 2's
FLEET_STARTS = (0, 20, 40, 60)  # image fleet: each sequence's first frame
FLEET_SEED = 100    # sequence s: RANSAC generator / pixel-noise seed 100 + s
FLEET_CHUNKS = 1    # fleet chunks of CHUNK frames (2 until phase 11 came: the smoke's time)
FLEET_CHECK_FRAMES = 3  # fleet frames held to FLEET_POS_TOL of the single run
FLEET_RANK_TOL = 1e-9   # m, phase 11's fleets over ranks against phase 7's, float64
FLEET_POS_TOL = 1e-4    # m; later frames only to the ATE bar (the bench ATE is
                        # chaotic in the tracked positions, PERF.md)
FLEET_CHUNK_TOL = 0.05  # m, feature fleet against its single run over its frames
FLEET_SINGLE_FRAMES = 25  # frames of each feature sequence's single run (half a
                          # chunk since phase 8 came: keeps the smoke under ~800 s)
FLEET_PIXEL_NOISE = 0.25  # px, feature fleet (the bench's pixel noise)
MOBILE_PROFILE = "mobile_default"  # the gateway's phone profile (window 15, 2 levels)
MOBILE_SECONDS = 4.0    # phase 8's sequence
MOBILE_CAM_RATE = 30.0  # the profile's phone rate (200 Hz IMU / 7: 28.6 fps, 115 frames)
MOBILE_TD = 0.015       # s, the camera-IMU offset phase 8's sequence carries
MOBILE_PERIOD_MS = 1e3 / 30.0  # a 30 fps phone's frame period
# The client's camera mount: the camera looks along the body's forward axis,
# as in tests/test_vio_gateway.py's configure. The profile's portrait default
# looks along -z of the body, at the simulated room's floor (phase 8 prints
# how few landmarks it would see).
MOBILE_R_IC = (0.0, 0.0, 1.0, -1.0, 0.0, 0.0, 0.0, -1.0, 0.0)
MOBILE_SYNC_FRAMES = 5  # tracking frames whose host syncs are counted
MOBILE_MIN_OK = 0.5     # share of the frames after initialization that must be ok
SOLVER_ITERS = 8        # phase 9: LM iterations per solve_and_slide (the budget of
                        # the reference's early-exit tests)
SOLVER_REPS = 10        # float32 calls timed per arm (median)
FTOL_SMALL = 1e-6       # the function tolerance of Ceres' default
FTOL_POSE_TOL = 1e-5    # tests/test_solver_early_exit.py's bars
BATCH_POSE_TOL = 1e-8   # tests/test_solver_batch_candidates.py's bar (float64)
GREEDY_POSE_TOL = 1e-3
GREEDY_COST_RATIO = 1.05
PRIOR_RTOL = 1e-6       # priors compared as J0ᵀJ0 and J0ᵀr0 (phase 9)
RANSAC_SEED = 9         # phase 9's RANSAC draws
RANSAC_F_TOL = 1e-6     # F, card float64 against CPU float64 (the CPU test's bar)
MEI_SECONDS = 4.0       # phase 9's Mei sequence (81 frames)
MEI_CAM = dict(model_type="MEI", width=752, height=480, focal_length=460.0,
               fx=460.0, fy=459.0, cx=376.0, cy=240.0,
               dist=(-0.01, 0.005, 1e-4, -2e-4), xi=0.95)  # tests/test_cameras.py MEI_CAM
SCARAMUZZA_CAM = dict(model_type="SCARAMUZZA", width=512, height=512, focal_length=190.0,
                      ocam_poly=(-190.0, 0.0, 1.0 / 380.0, 0.0, 1.0 / (8 * 190.0 ** 3)),
                      ocam_center=(256.0, 256.0))  # tests/test_cameras.py TestScaramuzza
SCARA_MAX_RHO = 300.0   # px, the range of its fitted inverse polynomial
SCARA_F32_PX = 1e-3     # float32 on the card against float64 on the CPU
SCARA_ROUND_TRIP_PX = 0.05  # the fitted inverse polynomial's error (tests/test_cameras.py)
TP_MU = 1e-4            # the damping of phase 9's sharded step
TP_RTOL = 1e-9
# Published H100 SXM peaks (NVIDIA data sheet) for the bounds: HBM3 bytes/s
# and float32 outside the tensor cores.
BOARD = (9, 6)          # phase 10: inner corners (cols, rows) of the calibration board
BOARD_SQUARE = 0.04     # m (tests/test_calibration_bootstrap.py)
CALIB_VIEWS = 25        # a real calibration sweep: 25 views, 1,350 corners
CALIB_NOISE_PX = 0.1
CALIB_ITERS = 30        # calibrate_from_board's joint iterations (its default)
CALIB_CPU_PX = 0.02     # px, card against CPU: every corner's projection (the Scaramuzza
                        # bundle's inverse polynomial is ill-conditioned: two correct float64
                        # solvers part by ~0.01 px after 30 iterations)
CALIB_RMS_RTOL = 1e-6   # card against CPU: the final board RMS
ODO_VIEWS = 8           # phase 10's hand-eye calibration
ADV_CHUNK = 25          # bench.py _image_path_recovering's serving chunk
ADV_SEED = 11           # bench.py --adv-seeds' default
ADV_ARMS = ((0, 6.0), (2, 12.0))  # (nuisance level, seconds): 121 and 241 frames
TAIL_SECONDS = 4.0      # phase 10 (c): 81 frames of the bench sequence, the failed first chunk
                        # and a chunk after it (121 frames until phase 12 came: the smoke's time)
TAIL_CHUNK = 25         # ADV_CHUNK
TAIL_BLANK = 10         # frames closing the first chunk with the camera covered (blank) and
TAIL_KNOCK = 150.0      # m/s^2 on the accelerometer's x axis (a knock, ~15 g): the chunk's
                        # last frames gate on |v| > 10 m/s (recover_tail is 6)
ADV_JAX = ("level 0: 0.0067 m over 230/241 poses at 12 s; level 2: 0.41-0.69 m over seeds "
           "11/23/37, 1 recovery each (artifacts/bench_adversarial_r5.json, TPU v5e)")
ENTRY_CHECK_STEPS = 3   # phase 12: entry steps held card (float64) against CPU (float64)
ENTRY_TOL = 1e-9        # m
ENTRY_TIMED_STEPS = 10  # float32 entry steps timed on the card
ENTRY_SYNC_STEPS = 3    # float32 entry steps whose host syncs are counted
ENTRY_DT = 0.05         # s between the entry steps' inputs (the example window's spacing)
REPLAY_ARGS = ("--duration=2", "--size=256")   # phase 12's replay export
COLOR_FRAMES = 5        # phase 12's colour PNG sequence
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12


def _time_ms(fn, reps=30, warmup=3) -> float:
    """Median of ``reps`` single calls, CUDA events around each."""
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


def _time_graph_ms(fn, n=20, reps=10) -> float:
    """Device time of one launch: n calls captured in one CUDA graph, the
    replay timed with CUDA events; median over ``reps`` replays, / n. No
    host enqueue time is inside the measurement."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _bound(nbytes: float, flops: float) -> dict:
    """The least time on the card: the larger of bytes over the memory rate
    and float32 operations over the float32 peak."""
    t_bytes = 1e3 * nbytes / PEAK_BYTES_S
    t_ops = 1e3 * flops / PEAK_F32_FLOP_S
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=float(nbytes), bound_flops=float(flops))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _origin(c, back, pad, n, side):
    """block_origin of csrc/lk_common.cuh for a tensor of coordinates: the
    floor (NaN as 0, held to +-2^24) less ``back``, clamped in the level of
    side n padded by ``pad``, returned unpadded (may be negative)."""
    f = torch.floor(torch.nan_to_num(c, nan=0.0)).clamp(-2 ** 24, 2 ** 24).long()
    return (f - back + pad).clamp(0, n + 2 * pad - side) - pad


def _k1_read_bytes(pyr0, pyr1, pts, windows, win):
    """Bytes of the level pixels K1 must read, once each: the (win+3)^2
    template block of every active slot at every level of the first
    pyramid, and the (win+1)^2 windows its steps sample in the second
    (``windows``: (level, x, y) of every step, from the plain version)."""
    half = (win - 1) // 2
    total = 0
    for lvl, (a, b) in enumerate(zip(pyr0, pyr1)):
        h, w = a.shape
        tx, ty = pts[:, 0] / float(2 ** lvl), pts[:, 1] / float(2 ** lvl)
        total += _footprint_bytes(a, _origin(ty, half + 1, half + 2, h, win + 3),
                                  _origin(tx, half + 1, half + 2, w, win + 3), win + 3)
        xs = [x for lv, x, _ in windows if lv == lvl]
        ys = [y for lv, _, y in windows if lv == lvl]
        if xs:
            xs, ys = torch.cat(xs), torch.cat(ys)
            total += _footprint_bytes(b, _origin(ys, half, half + 2, h, win + 1),
                                      _origin(xs, half, half + 2, w, win + 1), win + 1)
    return total


def _footprint_bytes(img, oy, ox, side):
    """Bytes of the distinct pixels of ``img`` that side x side blocks at
    origins (oy, ox) read, each row and column clamped into the image as the
    kernels load them: what a kernel that reads only those blocks must
    move, once each."""
    h, w = img.shape
    span = torch.arange(side, device=oy.device)
    rows = (oy[:, None] + span).clamp(0, h - 1)
    cols = (ox[:, None] + span).clamp(0, w - 1)
    seen = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    seen[rows[:, :, None], cols[:, None, :]] = True
    return int(seen.sum()) * img.element_size()


# Floating-point operations of the LK building blocks, counted from the
# kernels' source for a window of n = win * win pixels.
def _template_flops(win):     # block Scharr + 3 bilinear patches
    return 24 * (win + 1) ** 2 + 21 * win * win


def _sums_flops(win):         # the three structure-tensor sums
    return 6 * win * win


def _track_iter_flops(win):   # K1: bilinear window + diff + two dot sums
    return 12 * win * win + 10


def _refine_iter_flops(win):  # K2: bilinear window + mean + zero-mean diff + sums
    return 14 * win * win + 20


def _refine_fixed_flops(win):  # K2 per point: template sums, zero-mean, end residual
    return 20 * win * win


def _feed_imu(sink, data, imu_i, ts):
    while imu_i < len(data.imu_ts) and data.imu_ts[imu_i] <= ts + 1e-9:
        sink.push_imu(data.imu_ts[imu_i], data.imu_acc[imu_i], data.imu_gyr[imu_i])
        imu_i += 1
    return imu_i


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


def bench_pair(data, cam, cfg, sim, example, frames=(20, 21), r_ic=None):
    """Two consecutive frames of the sequence on the card, as the tracker
    sees them: (img0, pyr0, img1, pyr1, pts, valid), the max_points slots
    from the corner detector on the first (the bench's camera mount unless
    ``r_ic`` is given)."""
    from mobile_slam_tpu_torch.frontend import tracker as trk
    from mobile_slam_tpu_torch.ops import corners

    tcfg = cfg.tracker
    r_ic = example.R_IC if r_ic is None else r_ic
    frames = [torch.as_tensor(sim.render_frame(data, fi, cam, r_ic,
                                               cfg.camera.t_ic_vec),
                              dtype=torch.float32, device="cuda") for fi in frames]
    img0, pyr0, resp0 = trk.preprocess_frame(frames[0], tcfg)
    img1, pyr1, _ = trk.preprocess_frame(frames[1], tcfg)
    pts, valid = corners.detect_grid(resp0, tcfg.min_dist, tcfg.max_points,
                                     quality_level=tcfg.quality_level)
    return img0, pyr0, img1, pyr1, pts, valid


def _wave_image(rng, h, w):
    """A band-limited 0..255 texture as a function of (x, y): random
    sinusoids, so that a shifted copy is exact at any sub-pixel shift.
    Returns f(shift_x, shift_y) -> (h, w) float32 array, img(x + shift)."""
    n = 48
    freq = rng.uniform(1.0 / 40.0, 1.0 / 6.0, n) * rng.choice([-1.0, 1.0], n)
    ang = rng.uniform(0.0, np.pi, n)
    fx, fy = freq * np.cos(ang), freq * np.sin(ang)
    amp, ph = rng.uniform(0.5, 1.0, n), rng.uniform(0.0, 2.0 * np.pi, n)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)

    def raw(sx, sy):
        arg = 2.0 * np.pi * (fx[:, None, None] * (xx + sx) + fy[:, None, None] * (yy + sy))
        return np.sum(amp[:, None, None] * np.sin(arg + ph[:, None, None]), axis=0)

    scale = 127.5 / np.abs(raw(0.0, 0.0)).max()
    return lambda sx, sy: (127.5 + scale * raw(sx, sy)).clip(0.0, 255.0).astype(np.float32)


def _edge_points(rng, h, w):
    """Interior points, points within a few px of each border and corner,
    points outside the image, a NaN point and two dead slots."""
    inner = np.stack([rng.uniform(0.2 * w, 0.8 * w, 12),
                      rng.uniform(0.2 * h, 0.8 * h, 12)], axis=-1)
    edge = [[2.3, 0.5 * h], [w - 3.4, 0.45 * h], [0.55 * w, 1.7], [0.4 * w, h - 2.6],
            [1.5, 1.5], [w - 2.5, h - 2.5], [w - 2.2, 2.4], [3.1, h - 3.3],
            [9.6, 0.3 * h], [0.7 * w, h - 9.2]]
    outside = [[-6.0, 20.0], [w + 4.0, 30.0], [40.0, -3.0], [50.0, h + 7.0],
               [-400.0, -900.0]]
    pts = np.concatenate([inner, edge, outside, [[np.nan, 10.0]],
                          [[0.5 * w, 0.5 * h], [0.0, 0.0]]]).astype(np.float32)
    active = np.ones(len(pts), bool)
    active[-2:] = False
    return pts, active


SECOND_SET_SEED = 11
SECOND_SET = (  # name, (h, w), window, pyramid levels, iters, eps, shift, one live slot
    ("win15 3 levels odd sides", (203, 301), 15, 3, 30, 0.01, (5.3, -3.6), False),
    ("win31 1 level", (96, 128), 31, 1, 30, 0.01, (0.8, -0.6), False),
    ("win21 1 level borders", (203, 301), 21, 1, 30, 0.01, (1.7, -1.2), False),
    ("win21 3 levels one live slot", (203, 301), 21, 3, 30, 0.01, (3.1, 2.2), True),
    ("win15 1 level iteration cap", (96, 128), 15, 1, 2, 1e-4, (2.4, 1.9), False),
)


def second_set(device):
    """The cases of SECOND_SET as tensors on ``device``: (name, pyr0, pyr1,
    pts, active, window, iters, eps)."""
    from mobile_slam_tpu_torch.ops import image as im

    rng = np.random.RandomState(SECOND_SET_SEED)
    for name, (h, w), win, levels, iters, eps, shift, one_live in SECOND_SET:
        img = _wave_image(rng, h, w)
        pts, active = _edge_points(rng, h, w)
        if one_live:
            active[:] = False
            active[3] = True
        pyr = [im.build_pyramid(torch.as_tensor(img(sx, sy), device=device), levels - 1)
               for sx, sy in ((0.0, 0.0), shift)]
        yield (name, pyr[0], pyr[1], torch.as_tensor(pts, device=device),
               torch.as_tensor(active, device=device), win, iters, eps)


def _same(a, b) -> bool:
    """Bitwise-equal values, a NaN equal to a NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def run_second_case(lk, case):
    """K1, K3 at the start points on the first image, then K2 from K1's end
    points (the plain templates of the first image at the start points, as
    the tracker's anchor refinement has them), each against its plain
    version at the bars of the main-path check; K3's patches at a NaN centre
    are NaN on both sides."""
    name, pyr0, pyr1, pts, active, win, iters, eps = case
    params = lk.LKParams(window=win, levels=len(pyr0) - 1, iters=iters, eps=eps)
    steps = []
    pos_k, ok_k = lk._track_pyramidal_cuda(pyr0, pyr1, pts, active, params)
    pos_p, ok_p = lk.track_pyramidal_ref(pyr0, pyr1, pts, active, params, steps=steps)
    _check(bool((ok_k == ok_p).all()), f"K1 [{name}] ok masks differ at slots "
           f"{torch.nonzero(ok_k != ok_p).flatten().tolist()}: kernel {pos_k[ok_k != ok_p].tolist()} "
           f"plain {pos_p[ok_k != ok_p].tolist()}")
    _check(_same(pos_k[~active], pts[~active]) and not bool(ok_k[~active].any()),
           f"K1 [{name}] moved a dead slot")
    _check(int(ok_k.sum()) >= 1, f"K1 [{name}] tracked nothing")
    err1 = float((pos_k - pos_p)[ok_k].norm(dim=-1).max())
    _check(err1 < POS_TOL, f"K1 [{name}] position difference {err1} px")

    tmpl = lk.extract_patches_ref(pyr0[0], pts, win)
    nan = pts.isnan().any(dim=-1)
    err3 = 0.0
    for a, b in zip(lk._extract_patches_cuda(pyr0[0], pts, win), tmpl):
        _check(_same(a[nan], b[nan]), f"K3 [{name}] differs at a NaN centre")
        err3 = max(err3, float((a - b)[~nan].abs().max()))
    _check(err3 < PATCH_TOL, f"K3 [{name}] patch difference {err3}")
    start = pos_p + torch.tensor([0.4, -0.3], device=pts.device)
    args = (pyr1[0], *tmpl, start, active, win, iters, eps, 2.0)
    steps2 = []
    pk, okk, rk = lk._refine_template_cuda(*args)
    pp, okp, rp = lk.refine_template_ref(*args, steps=steps2)
    _check(bool((okk == okp).all()), f"K2 [{name}] ok masks differ at slots "
           f"{torch.nonzero(okk != okp).flatten().tolist()}: kernel {pk[okk != okp].tolist()} "
           f"plain {pp[okk != okp].tolist()}")
    _check(_same(pk[~active], start[~active]) and not bool(okk[~active].any())
           and not bool(rk[~active].any()), f"K2 [{name}] moved a dead slot")
    _check(int(okk.sum()) >= 1, f"K2 [{name}] refined nothing")
    dpos = float((pk - pp)[okk].norm(dim=-1).max())
    dres = float((rk - rp)[okk].abs().max())
    _check(dpos < POS_TOL, f"K2 [{name}] position difference {dpos} px")
    _check(dres < RESID_TOL, f"K2 [{name}] residual difference {dres}")
    return dict(case=name, k3_err=err3, k1_ok=int(ok_k.sum()), k1_err_px=err1,
                k1_steps_max=int(steps[0].max()), k2_ok=int(okk.sum()),
                k2_err_px=dpos, k2_resid_err=dres, k2_steps_max=int(steps2[0].max()),
                live=int(active.sum()))


def _step_ms(run, iters=(8, 24)):
    """Device time of one Gauss-Newton step of a kernel's slowest point:
    ``run(n)`` launches it with the step count fixed at n per level (eps 0,
    so no point leaves early); the slope of two graph-timed runs. Returns
    (ms per step and level, ms of the run's fixed part)."""
    lo, hi = (_time_graph_ms(lambda n=n: run(n)) for n in iters)
    step = (hi - lo) / (iters[1] - iters[0])
    return step, lo - iters[0] * step


def phase_kernels(lk, pair, cfg, tag="phase 2", second_cases=True):
    """K1-K3 against their plain versions at the shapes of ``cfg``'s path
    (phase 2: the bench's; phase 8: the gateway's mobile profile), then the
    second set when ``second_cases``."""
    tcfg = cfg.tracker
    win = tcfg.lk_window_size
    img0, pyr0, img1, pyr1, pts, valid = pair
    active = valid.clone()
    active[::16] = False
    n_live = int(active.sum())
    print(f"[{tag}] {pts.shape[0]} slots, {n_live} active, levels "
          f"{[tuple(p.shape) for p in pyr0]}", flush=True)
    params = lk.LKParams(window=win, levels=tcfg.lk_pyramid_levels,
                         iters=tcfg.lk_iterations, eps=tcfg.lk_eps)
    results = {}

    # K1
    pos_k, ok_k = lk._track_pyramidal_cuda(pyr0, pyr1, pts, active, params)
    its, steps, k1_wins = [], [], []  # point-iterations per level, coarse first;
    # steps per point; (level, x, y) of every step's windows
    pos_p, ok_p = lk.track_pyramidal_ref(pyr0, pyr1, pts, active, params,
                                         iterations=its, steps=steps, windows=k1_wins)
    torch.cuda.synchronize()
    _check(lk.build_kernels().lk_track_smem_bytes(win, len(pyr0))
           == lk.track_smem_bytes(win, len(pyr0)),
           "ops/lk.py and lk_kernels.cu disagree on K1's shared memory")
    both = ok_k & ok_p
    _check(bool((ok_k == ok_p).all()), "K1 ok masks differ")
    _check(int(both.sum()) >= n_live // 2, f"K1 tracked only {int(both.sum())}")
    err1 = float((pos_k - pos_p)[both].norm(dim=-1).max())
    _check(err1 < POS_TOL, f"K1 position difference {err1} px")
    k1_args = lk._track_prep(pyr0, pyr1, pts, active, params)
    _check(all(a.data_ptr() == b.data_ptr() for a, b in zip(k1_args[0] + k1_args[1],
                                                             (*pyr0, *pyr1))),
           "K1's prep copied a pyramid level")
    fixed = k1_args[:4]
    k1_step, k1_fixed = _step_ms(lambda n: lk._track_launch(
        *fixed, params._replace(iters=n, eps=0.0)))
    k1_step /= len(pyr0)    # the fixed-step runs take n steps at every level
    chain = int(steps[0].max())
    flops = (n_live * len(pyr0) * (_template_flops(win) + _sums_flops(win))
             + sum(its) * _track_iter_flops(win))
    k1_read = _k1_read_bytes(pyr0, pyr1, pts[active], k1_wins, win)
    results["track_pyramidal"] = dict(
        max_abs_err=err1,
        ms=_time_ms(lambda: lk._track_pyramidal_cuda(pyr0, pyr1, pts, active, params)),
        op_ms=_time_ms(lambda: lk.track_pyramidal(pyr0, pyr1, pts, active, params)),
        launch_ms=_time_graph_ms(lambda: lk._track_launch(*k1_args)),
        plain_ms=_time_ms(lambda: lk.track_pyramidal_ref(pyr0, pyr1, pts, active, params)),
        library_ms=None, iterations_per_level=its, chain_steps_max=chain,
        chain_steps_sum=int(steps[0].sum()), step_ms=k1_step, fixed_ms=k1_fixed,
        chain_floor_ms=chain * k1_step, image_bytes_read=k1_read,
        image_bytes_whole=_nbytes(*pyr0, *pyr1),
        **_bound(k1_read + _nbytes(pts, active, pos_k, ok_k), flops))

    # K3 at the tracked points of the new frame (the FB template)
    new_pts = pos_k
    t_k = lk._extract_patches_cuda(img1, new_pts, win)
    t_p = lk.extract_patches_ref(img1, new_pts, win)
    err3 = max(float((a - b).abs().max()) for a, b in zip(t_k, t_p))
    _check(err3 < PATCH_TOL, f"K3 patch difference {err3}")
    k3_args = lk._extract_prep(img1, new_pts, win)
    _check(k3_args[0].data_ptr() == img1.data_ptr(), "K3's prep copied the image")
    # Bytes: the pixels of the slots' (win+3)^2 blocks (their union), the
    # centres, the three patches.
    half, (h1, w1) = (win - 1) // 2, img1.shape
    k3_read = _footprint_bytes(
        img1, _origin(new_pts[:, 1], half + 1, half + 2, h1, win + 3),
        _origin(new_pts[:, 0], half + 1, half + 2, w1, win + 3), win + 3)
    results["extract_patches"] = dict(
        max_abs_err=err3,
        ms=_time_ms(lambda: lk._extract_patches_cuda(img1, new_pts, win)),
        op_ms=_time_ms(lambda: lk.extract_patches(img1, new_pts, win)),
        launch_ms=_time_graph_ms(lambda: lk._extract_launch(*k3_args)),
        plain_ms=_time_ms(lambda: lk.extract_patches_ref(img1, new_pts, win)),
        library_ms=None, image_bytes_read=k3_read,
        **_bound(k3_read + _nbytes(new_pts, *t_k), new_pts.shape[0] * _template_flops(win)))

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
        n_its, steps2, k2_wins = [], [], []
        pp, okp, rp = lk.refine_template_ref(*args, iterations=n_its, steps=steps2,
                                             windows=k2_wins)
        n_it, chain2 = n_its[0], int(steps2[0].max())
        torch.cuda.synchronize()
        _check(bool((okk == okp).all()), f"K2 ({name}) ok masks differ")
        m = okk & okp
        dpos = float((pk - pp)[m].norm(dim=-1).max())
        dres = float((rk - rp)[m].abs().max())
        _check(dpos < POS_TOL, f"K2 ({name}) position difference {dpos} px")
        _check(dres < RESID_TOL, f"K2 ({name}) residual difference {dres}")
        err2 = max(err2, dpos, dres)
        prepped = lk._refine_prep(*args)
        _check(prepped[0].data_ptr() == img.data_ptr(), "K2's prep copied the image")
        k2_step, k2_fixed = _step_ms(lambda n: lk._refine_launch(
            *prepped[:7], n, 0.0, prepped[9]))
        n_act = int(ok_k.sum())
        flops = n_act * _refine_fixed_flops(win) + n_it * _refine_iter_flops(win)
        # Bytes: the image pixels the step and end-point windows cover (their
        # union), the active slots' templates, the start points, the outputs.
        xs, ys = (torch.cat([w[i] for w in k2_wins]) for i in (0, 1))
        k2_read = _footprint_bytes(img, _origin(ys, half, half + 2, img.shape[0], win + 1),
                                   _origin(xs, half, half + 2, img.shape[1], win + 1), win + 1)
        times[name] = dict(
            ms=_time_ms(lambda: lk._refine_template_cuda(*args)),
            op_ms=_time_ms(lambda: lk.refine_template(*args)),
            launch_ms=_time_graph_ms(lambda: lk._refine_launch(*prepped)),
            plain_ms=_time_ms(lambda: lk.refine_template_ref(*args)),
            iterations=n_it, chain_steps_max=chain2, step_ms=k2_step,
            fixed_ms=k2_fixed, chain_floor_ms=chain2 * k2_step, image_bytes_read=k2_read,
            image_bytes_whole=_nbytes(img),
            **_bound(k2_read + 3 * n_act * win * win * 4 + _nbytes(start, ok_k, pk, okk, rk),
                     flops))
        print(f"[{tag}] K2 {name}: iters {iters} max_shift {max_shift} "
              f"ok {int(m.sum())} pos diff {dpos:.3g} px resid diff {dres:.3g} "
              f"wrapper {times[name]['ms']:.4f} ms (custom op {times[name]['op_ms']:.4f} ms) "
              f"launch (graph) "
              f"{times[name]['launch_ms']:.4f} ms plain {times[name]['plain_ms']:.4f} ms "
              f"bound {times[name]['bound_ms']:.5f} ms ({times[name]['bound_by']}, "
              f"{n_it} point-iterations, slowest point {chain2} steps); one step "
              f"{k2_step:.6f} ms, fixed part {k2_fixed:.6f} ms, chain floor "
              f"{chain2 * k2_step:.5f} ms", flush=True)
    results["refine_template"] = dict(
        max_abs_err=err2, library_ms=None, **times["fb"],
        **{f"{k}_anchor": v for k, v in times["anchor"].items()})
    for name in ("track_pyramidal", "extract_patches"):
        r = results[name]
        print(f"[{tag}] {name}: max err {r['max_abs_err']:.3g} wrapper "
              f"{r['ms']:.4f} ms (through its custom op {r['op_ms']:.4f} ms) launch "
              f"(graph) {r['launch_ms']:.4f} ms plain "
              f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.5f} ms ({r['bound_by']})",
              flush=True)
    r = results["track_pyramidal"]
    print(f"[{tag}] K1 point-iterations per level (coarse first): "
          f"{r['iterations_per_level']}, sum {r['chain_steps_sum']}, slowest point "
          f"{r['chain_steps_max']} steps over all levels; one step {r['step_ms']:.6f} ms, "
          f"fixed part (templates, launch) {r['fixed_ms']:.6f} ms, chain floor "
          f"{r['chain_floor_ms']:.5f} ms", flush=True)
    if not second_cases:
        return results
    second = [run_second_case(lk, case) for case in second_set("cuda")]
    torch.cuda.synchronize()
    for c in second:
        print(f"[{tag}] second set [{c['case']}]: {c['live']} live slots; K3 err "
              f"{c['k3_err']:.3g}; K1 ok "
              f"{c['k1_ok']} err {c['k1_err_px']:.3g} px, slowest point "
              f"{c['k1_steps_max']} steps; K2 ok {c['k2_ok']} err "
              f"{c['k2_err_px']:.3g} px resid err {c['k2_resid_err']:.3g}, slowest "
              f"point {c['k2_steps_max']} steps", flush=True)
    results["track_pyramidal"]["second_set"] = second
    results["extract_patches"]["second_set_max_err"] = max(c["k3_err"] for c in second)
    return results


def phase_streaming(lk, data, cam, cfg, sim, example):
    from mobile_slam_tpu_torch.engine.vio_engine import Status, VIOEngine
    from mobile_slam_tpu_torch.eval.evaluator import compute_ate
    from mobile_slam_tpu_torch.probes.sync_sites import SyncSites

    engine = VIOEngine(cfg)
    _check(engine.device.type == "cuda", f"engine on {engine.device}")
    # Phase 9 starts from the estimator state of the last tracking frame.
    last_solve, solve = {}, engine._solve

    def recorded_solve(state, is_kf):
        last_solve["state"] = state
        return solve(state, is_kf)

    engine._solve = recorded_solve
    est_ts, est_p = [], []
    imu_i, init_frame, n_frames = 0, None, 0
    frame_ms, at_init, syncs = [], None, []
    lk.reset_launch_counts()
    for fi in range(len(data.frames)):
        img = sim.render_frame(data, fi, cam, example.R_IC, cfg.camera.t_ic_vec)
        ts = data.cam_ts[fi]
        imu_i = _feed_imu(engine, data, imu_i, ts)
        counted = init_frame is not None and fi > init_frame + EXTRA_FRAMES - SYNC_FRAMES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if counted:
            with SyncSites() as sc:
                res = engine.process_frame(img, ts)
            syncs.append(sum(sc.sites.values()))
        else:
            res = engine.process_frame(img, ts)
        torch.cuda.synchronize()
        dt_ms = 1e3 * (time.perf_counter() - t0)
        n_frames += 1
        if init_frame is not None and not counted:
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
    n_track = n_frames - 1 - init_frame
    for k, n in LK_PER_FRAME.items():
        _check(counts[k] == n * n_frames,
               f"{k}: {counts[k]} launches over {n_frames} frames")
        _check(counts[k] - at_init[k] == n * n_track,
               f"{k}: {counts[k] - at_init[k]} launches over {n_track} tracking frames")
    ate = compute_ate(np.asarray(est_ts), est_p, data.cam_ts, data.gt_p)
    _check(ate.rmse < ATE_TOL, f"ATE {ate.rmse} m")
    out = dict(counts=counts, init_frame=init_frame, ate=float(ate.rmse),
               ms_per_frame=float(np.median(frame_ms)),
               syncs_per_frame=float(np.mean(syncs)),
               solve_state=last_solve["state"], params=engine.params)
    print(f"[phase 3] init frame {init_frame}, {n_frames} frames, {len(est_p)} "
          f"poses, ATE sim3 rmse {ate.rmse:.4f} m over {ate.num_pairs} pairs, "
          f"median {out['ms_per_frame']:.2f} ms per tracking frame "
          f"(p90 {np.percentile(frame_ms, 90):.2f} ms), host syncs per tracking "
          f"frame {syncs} (mean {out['syncs_per_frame']:.1f}), launches {counts}",
          flush=True)
    return out


def _span_ms(spans, name) -> list:
    """Durations in ms of the recorded spans named ``name`` (utils/logging.py)."""
    return [1e3 * sp.seconds for sp in spans if sp.name == name]


def phase_serving(lk, cfg, sim, example, make_camera):
    from mobile_slam_tpu_torch.engine.serving import ChunkedImageServer
    from mobile_slam_tpu_torch.eval.evaluator import compute_ate
    from mobile_slam_tpu_torch.probes.sync_sites import SyncSites
    from mobile_slam_tpu_torch.utils import logging as slog

    cam = make_camera(cfg.camera, dtype=torch.float64, device="cpu")
    data = sim.simulate(example.bench_sim_config(SERVE_SECONDS), cam,
                        cfg.camera.r_ic_mat, cfg.camera.t_ic_vec)
    n_img = min(int(SERVE_SECONDS * 20.0), len(data.frames))
    # The bench's protocol: stream until TRACKING + 3 frames (the init frame
    # and 3 more tracked in a row), then chunks.
    server = ChunkedImageServer(cfg, chunk_size=CHUNK, stable_frames=4)
    _check(server.engine.device.type == "cuda", f"server on {server.engine.device}")
    step = server._step
    loop = {"frames": 0, **{k: 0 for k in LK_PER_FRAME}}

    def counted_step(carry, inputs, ransac_draws=None):
        before = dict(lk.launch_counts)
        out = step(carry, inputs, ransac_draws)
        loop["frames"] += inputs.img.shape[0]
        for k in LK_PER_FRAME:
            loop[k] += lk.launch_counts[k] - before[k]
        return out

    server._step = counted_step
    results, imu_i, chunk_syncs = [], 0, None
    lk.reset_launch_counts()
    t_start = time.perf_counter()
    sync_ctx = None
    with slog.tracing():
        for fi in range(n_img):
            img = sim.render_frame(data, fi, cam, example.R_IC, cfg.camera.t_ic_vec)
            ts = data.cam_ts[fi]
            imu_i = _feed_imu(server, data, imu_i, ts)
            # Count the host syncs of the second chunk, from its first buffered
            # frame to the call that runs it.
            if (chunk_syncs is None and sync_ctx is None and server.n_chunks == 1
                    and server.mode == "chunked" and not server._buf):
                sync_ctx = SyncSites().__enter__()
                chunks_before = server.n_chunks
            out = server.process_frame(img, ts)
            if sync_ctx is not None and server.n_chunks > chunks_before:
                sync_ctx.__exit__(None, None, None)
                chunk_syncs, sync_ctx = sum(sync_ctx.sites.values()), None
            results += out
        results += server.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    chunk_s = sum(_span_ms(slog.drain(), "chunk")) / 1e3
    counts = dict(lk.launch_counts)

    _check(server.n_chunks >= 1, "the server never entered chunked mode")
    _check(chunk_syncs is not None, "no chunk was counted for host syncs")
    ok = [r for r in results if r.ok]
    est_p = np.asarray([r.p for r in ok])
    _check(len(ok) >= MIN_SERVE_POSES, f"only {len(ok)} ok poses")
    _check(bool(np.isfinite(est_p).all()), "non-finite poses")
    n_stream = server.frames_streamed
    for k, n in LK_PER_FRAME.items():
        _check(loop[k] == n * loop["frames"],
               f"{k}: {loop[k]} launches over {loop['frames']} chunk-loop frames")
        _check(counts[k] == n * (loop["frames"] + n_stream),
               f"{k}: {counts[k]} launches over {loop['frames']} chunk-loop + "
               f"{n_stream} streamed frames")
    ate = compute_ate(np.asarray([r.ts for r in ok]), est_p, data.cam_ts, data.gt_p)
    _check(ate.rmse < ATE_TOL, f"ATE {ate.rmse} m")
    ms_chunked = 1e3 * chunk_s / server.frames_chunked
    out = dict(counts=counts, ate=float(ate.rmse), n_poses=len(ok),
               ms_per_chunked_frame=ms_chunked, chunked_fps=server.frames_chunked / chunk_s,
               syncs_per_chunked_frame=chunk_syncs / CHUNK)
    print(f"[phase 4] {n_img} frames: {n_stream} streamed, {server.n_chunks} chunks "
          f"of {CHUNK} ({server.frames_chunked} real frames, {loop['frames']} through "
          f"the loop), {server.n_recoveries} recoveries, {len(ok)} ok poses; "
          f"ATE sim3 rmse {ate.rmse:.4f} m over {ate.num_pairs} pairs (JAX band "
          f"{JAX_BAND}); {ms_chunked:.2f} ms per chunked frame (the chunk spans), chunked_fps "
          f"{out['chunked_fps']:.3f}, whole run {wall:.1f} s; host syncs "
          f"{chunk_syncs} over one chunk = {chunk_syncs / CHUNK:.1f} per chunked "
          f"frame; launches {counts}, chunk loop {loop}", flush=True)
    return out


def phase_probes(lk, pair):
    from mobile_slam_tpu_torch.probes import call_overhead as p1
    from mobile_slam_tpu_torch.probes import lk_pack_probe as p2

    results = {}
    # P1 is held on inputs where its arithmetic shows (p1.check_inputs: an
    # integer image, whose float32 block sum is exact in any order, and
    # points near 0, so the sum moves every output by ~1e6 ulps): exact.
    cpts, cimg = p1.check_inputs("cuda")
    a = p1._touch_points_cuda(cpts, cimg)
    b = p1.touch_points_ref(cpts, cimg)
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    _check(err == 0.0, f"P1 differs from its plain version by {err}")
    _check(bool((b != cpts).all()), "P1's check inputs do not show the block sum")
    pts, imgs = p1.inputs("cuda")       # the reference's, for the timings
    results["call_overhead"] = dict(
        max_abs_err=err, library_ms=None,
        ms=_time_ms(lambda: p1._touch_points_cuda(pts, imgs[0])),
        launch_ms=_time_graph_ms(lambda: p1._touch_points_cuda(pts, imgs[0])),
        plain_ms=_time_ms(lambda: p1.touch_points_ref(pts, imgs[0])),
        **_bound(_nbytes(pts, imgs[0][:p1.BLOCK_ROWS, :p1.BLOCK_COLS], a),
                 p1.BLOCK_ROWS * p1.BLOCK_COLS + pts.numel()))

    # P2 on the reference's inputs (noise, a known (-3, +3) px shift) and on
    # the main path's: the bench frame pair at level 0 and its live slots.
    # full is held at the K1 bar. The other modes step by constants or by
    # exactly 0, so their displacement is held at P2_DISP_TOL, and every
    # mode's witness (the sum of every window it compared, which shows the
    # loads and the resampling the positions cannot) at P2_WIT_RTOL.
    _, pyr0, _, pyr1, pts_main, valid = pair
    p2_inputs = {
        "reference": p2.inputs("cuda"),
        "bench": (pts_main[valid].float().contiguous(),
                  lk._pad(pyr0[0], p2.PAD).contiguous(),
                  lk._pad(pyr1[0], p2.PAD).contiguous()),
    }
    err2, wit2 = {}, {}
    for src, (q, prev_p, next_p) in p2_inputs.items():
        for mode in p2.MODES:
            a, wa = p2._lk_probe_cuda(q, prev_p, next_p, p2.PAD, mode)
            b, wb = p2.lk_probe_ref(q, prev_p, next_p, p2.PAD, mode)
            torch.cuda.synchronize()
            name = f"{src} {mode}"
            err2[name] = e = float(((a - q) - (b - q)).abs().max())
            wit2[name] = w = float(((wa - wb).abs() / wb.abs().clamp(min=1.0)).max())
            tol = POS_TOL if mode == "full" else P2_DISP_TOL
            _check(e <= tol, f"P2 {mode} on the {src} inputs: displacement differs "
                             f"by {e} px (bar {tol})")
            _check(w <= P2_WIT_RTOL, f"P2 {mode} on the {src} inputs: witness differs "
                                     f"by {w} relative (bar {P2_WIT_RTOL})")
    q, prev_p, next_p = p2_inputs["bench"]
    win, k = p2.WIN, q.shape[0]
    flops = k * (_template_flops(win) + _sums_flops(win)
                 + p2.ITERS * _track_iter_flops(win))
    # Bytes of full: the template blocks in the first image and the windows
    # its steps sweep in the second (positions of the plain version before
    # each step), each pixel once, plus the points and both outputs. The
    # images are padded: origins are clamped into them, in their coordinates.
    half, n = (win - 1) // 2, prev_p.shape[0] - 2 * p2.PAD
    at = [q] + [p2.lk_probe_ref(q, prev_p, next_p, p2.PAD, "full", i)[0]
                for i in range(1, p2.ITERS)]
    steps = torch.cat(at)
    p2_read = (_footprint_bytes(prev_p, _origin(q[:, 1], half + 1, p2.PAD, n, win + 3) + p2.PAD,
                                _origin(q[:, 0], half + 1, p2.PAD, n, win + 3) + p2.PAD, win + 3)
               + _footprint_bytes(next_p, _origin(steps[:, 1], half, p2.PAD, n, win + 1) + p2.PAD,
                                  _origin(steps[:, 0], half, p2.PAD, n, win + 1) + p2.PAD,
                                  win + 1))
    results["lk_pack_probe"] = dict(
        max_abs_err=max(err2.values()), max_abs_err_by_inputs_mode=err2,
        witness_rel_err_by_inputs_mode=wit2, library_ms=None, points=k,
        ms=_time_ms(lambda: p2._lk_probe_cuda(q, prev_p, next_p, p2.PAD, "full")),
        launch_ms=_time_graph_ms(
            lambda: p2._lk_probe_cuda(q, prev_p, next_p, p2.PAD, "full")),
        plain_ms=_time_ms(lambda: p2.lk_probe_ref(q, prev_p, next_p, p2.PAD, "full")),
        image_bytes_read=p2_read, **_bound(p2_read + _nbytes(q, a, wa), flops))
    print(f"[phase 5] P1 max err {err}, P2 displacement err by inputs and mode "
          f"{err2}, witness relative err {wit2}", flush=True)

    # The probes' own path: their drivers, launches counted from 0.
    p1.reset_launch_counts()
    p2.reset_launch_counts()
    r1 = p1.run()
    r2 = p2.run()
    r2_bench = p2.run(data=p2_inputs["bench"])
    results["call_overhead"].update(
        launches=p1.launch_counts["touch_points"], eager_ms_per_step=r1["eager"],
        graph_ms_per_step=r1["graph"], slope_eager_us=r1["slope_eager_us"],
        slope_graph_us=r1["slope_graph_us"])
    results["lk_pack_probe"].update(
        launches=p2.launch_counts["lk_probe"], mode_ms=r2["ms"],
        per_point_iter_us=r2["per_point_iter_us"],
        median_displacement=r2["median_displacement"],
        bench_mode_ms=r2_bench["ms"],
        bench_per_point_iter_us=r2_bench["per_point_iter_us"])
    p2_step, p2_fixed = _step_ms(lambda n: p2._lk_probe_cuda(q, prev_p, next_p, p2.PAD,
                                                             "full", n))
    results["lk_pack_probe"].update(step_ms=p2_step, fixed_ms=p2_fixed)
    for n in r1["eager"]:
        print(f"[phase 5] P1 calls/step={n}: eager {r1['eager'][n]:.4f} ms/step, "
              f"graph {r1['graph'][n]:.4f} ms/step", flush=True)
    print(f"[phase 5] P1 per launch: eager {r1['slope_eager_us']:.3f} us, graph "
          f"{r1['slope_graph_us']:.3f} us", flush=True)
    print(f"[phase 5] P2 median displacement {r2['median_displacement']} (expect "
          f"~[-3, 3]); ms/call {r2['ms']}; per point-iteration us "
          f"{r2['per_point_iter_us']}", flush=True)
    print(f"[phase 5] P2 on the bench frame pair ({k} points): ms/call "
          f"{r2_bench['ms']}; per point-iteration us "
          f"{r2_bench['per_point_iter_us']}; full: one step {p2_step:.6f} ms, fixed "
          f"part (template, launch) {p2_fixed:.6f} ms", flush=True)
    for name in ("call_overhead", "lk_pack_probe"):
        r = results[name]
        _check(r["launches"] > 0, f"{name}: no launch on its driver's path")
        print(f"[phase 5] {name}: wrapper {r['ms']:.4f} ms, launch (graph) "
              f"{r['launch_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']})", flush=True)
    return results


class _PhaseSixRecorder:
    """While active, every VIOEngine that VIOSystem builds is one that
    records each pose by its timestamp, the host wall time of each
    tracking call, and the host syncs of SYNC_FRAMES tracking calls from
    the CLI_SYNC_AT-th on (pipelined ones in a pipelined run)."""

    def __init__(self, vio_system, base):
        self.engines, self._mod, self._base = [], vio_system, base
        recorder = self

        class RecordingEngine(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.poses, self.call_ms, self.syncs, self.n_tracking = {}, [], [], 0
                recorder.engines.append(self)

            def _keep(self, res, ts):
                if res.ok and res.pose is not None:
                    self.poses[res.ts if res.ts is not None else ts] = res.pose
                return res

            def process_frame(self, image, frame_ts, imu_override=None):
                from mobile_slam_tpu_torch.probes.sync_sites import SyncSites

                tracking = self.status.name == "TRACKING"
                self.n_tracking += tracking
                counted = tracking and CLI_SYNC_AT <= self.n_tracking < CLI_SYNC_AT + SYNC_FRAMES
                t0 = time.perf_counter()
                if counted:
                    with SyncSites() as sc:
                        res = super().process_frame(image, frame_ts, imu_override)
                    self.syncs.append(sum(sc.sites.values()))
                else:
                    res = super().process_frame(image, frame_ts, imu_override)
                    if tracking:
                        self.call_ms.append(1e3 * (time.perf_counter() - t0))
                return self._keep(res, frame_ts)

            def flush_all(self):
                return [self._keep(r, None) for r in super().flush_all()]

        self.cls = RecordingEngine

    def __enter__(self):
        self._mod.VIOEngine = self.cls
        return self

    def __exit__(self, *exc):
        self._mod.VIOEngine = self._base


def _run_cli(cli, recorder, cwd, argv):
    """cli.main(argv) from ``cwd``; (its engine, its run directory)."""
    os.makedirs(cwd, exist_ok=True)
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with recorder:
            rc = cli.main(argv)
    finally:
        os.chdir(here)
    _check(rc == 0, f"cli.main({argv}) returned {rc}")
    (run,) = os.listdir(os.path.join(cwd, "logs"))
    return recorder.engines[-1], os.path.join(cwd, "logs", run)


def _max_dp(a: dict, b: dict, keys) -> float:
    return max(float(np.linalg.norm(a[t][:3, 3] - b[t][:3, 3])) for t in keys)


def phase_cli(lk, data, sync_streaming):
    """Phase 6: the file-driven entry point, in process."""
    from mobile_slam_tpu_torch import cli
    from mobile_slam_tpu_torch.engine import checkpoint as ckpt
    from mobile_slam_tpu_torch.engine import example, vio_engine, vio_system
    from mobile_slam_tpu_torch.io import native_loader, synthetic

    t_phase = time.perf_counter()
    work = os.path.join(REPO, "_chip_scratch", "phase6")     # logs/<ts>/ land here
    seq = os.path.join(REPO, "_chip_scratch", "phase6_seq")
    for d in (work, seq):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    _check(synthetic.main(["--out", seq, "--duration", str(CLI_SECONDS), "--noise",
                           "--seed", "7"]) == 0, "the sequence writer failed")
    cfg_path = os.path.join(work, "tum_vi_room1.yaml")
    os.makedirs(work)
    with open(os.path.join(REPO, "configs", "tum_vi_room1.yaml")) as f:
        lines = [f"dataset_path: {seq}" if ln.startswith("dataset_path:") else ln
                 for ln in f.read().splitlines()]
    with open(cfg_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    n_seq = len(os.listdir(os.path.join(seq, "mav0", "cam0", "data")))
    print(f"[phase 6] wrote {n_seq} frames ({CLI_SECONDS} s, noise, seed 7) in "
          f"{time.perf_counter() - t0:.2f} s; images read by "
          f"{'native/loader.cpp' if native_loader.available() else 'io/png.py'}", flush=True)
    recorder = _PhaseSixRecorder(vio_system, vio_engine.VIOEngine)

    # 1. The pipelined run: the slice's main path, launches counted from 0.
    lk.reset_launch_counts()
    pipe, run_dir = _run_cli(cli, recorder, os.path.join(work, "pipelined"),
                             [cfg_path, "--pipelined"])
    counts = dict(lk.launch_counts)
    for name in ("config.yaml", "trajectory_pose.txt", "evaluation.txt", "evaluation.json",
                 "live.json"):
        _check(os.path.exists(os.path.join(run_dir, name)), f"{name} missing in {run_dir}")
    _check(pipe.device.type == "cuda", f"the CLI's engine ran on {pipe.device}")
    with open(os.path.join(run_dir, "evaluation.json")) as f:
        ev = json.load(f)
    frames = ev["frames"]
    _check(frames == n_seq, f"{frames} frames processed of {n_seq}")
    for k, n in LK_PER_FRAME.items():
        _check(counts[k] == n * frames, f"{k}: {counts[k]} launches over {frames} frames")
    p = np.asarray([v[:3, 3] for v in pipe.poses.values()])
    _check(len(p) >= MIN_CLI_POSES and len(p) == ev["poses"],
           f"{len(p)} poses (evaluation: {ev['poses']})")
    _check(bool(np.isfinite(p).all()), "non-finite poses")
    map_pts = pipe.get_map_points()
    timing = pipe.get_timing()
    ms = float(np.median(pipe.call_ms))
    print(f"[phase 6] pipelined: {frames} frames, {ev['poses']} poses, fps {ev['fps']:.3f}, "
          f"ATE {ev['ate_rmse_m']:.4f} m, RPE(1 s) {ev['rpe_trans_rmse_m']:.4f} m, median "
          f"{ms:.2f} ms per tracking call (p90 {np.percentile(pipe.call_ms, 90):.2f}), "
          f"stage EMAs {timing} ms, host syncs per pipelined tracking frame {pipe.syncs} "
          f"(synchronous streaming, phase 3: {sync_streaming:.1f}), map points "
          f"{len(map_pts)}, launches {counts}", flush=True)
    _check(len(map_pts) > 0 and bool(np.isfinite(map_pts).all()),
           f"{len(map_pts)} map points, finite: {bool(np.isfinite(map_pts).all())}")

    # 2. Synchronous runs: uninterrupted; to a checkpoint; resumed from it.
    sync, _ = _run_cli(cli, recorder, os.path.join(work, "sync"), [cfg_path])
    snap = os.path.join(work, "snapshot.npz")
    part, _ = _run_cli(cli, recorder, os.path.join(work, "to_checkpoint"),
                       [cfg_path, f"--frames={CLI_CHECKPOINT_AT}", f"--checkpoint={snap}",
                        f"--checkpoint-every={CLI_CHECKPOINT_EVERY}"])
    _check(os.path.exists(snap), "no checkpoint written")
    resumed, _ = _run_cli(cli, recorder, os.path.join(work, "resumed"),
                          [cfg_path, f"--resume={snap}"])
    host = json.loads(bytes(ckpt.load_extra(snap)["host_json"]).decode())
    t_ck = host["last_frame_ts"]
    _check(t_ck == max(part.poses), "the snapshot is not of the run's last frame")
    after = sorted(t for t in sync.poses if t > t_ck)
    _check(sorted(resumed.poses) == after,
           f"resumed poses at {len(resumed.poses)} timestamps, uninterrupted at {len(after)} "
           "after the checkpoint")
    d_resume = _max_dp(resumed.poses, sync.poses, after)
    _check(d_resume == 0.0, f"resumed poses differ by {d_resume} m")
    common = sorted(set(pipe.poses) & set(sync.poses))
    d_pipe = _max_dp(pipe.poses, sync.poses, common)
    _check(d_pipe < PIPE_TOL, f"pipelined poses differ from synchronous by {d_pipe} m")
    ate_ok = ev["ate_rmse_m"] < ATE_TOL

    # 3. The device step on the bench sequence's features.
    eng = vio_engine.VIOEngine(example.bench_config())
    imu_i, at = 0, None
    for fi, ts in enumerate(data.cam_ts):
        imu_i = _feed_imu(eng, data, imu_i, ts)
        f = data.frames[fi]
        res = eng.process_features(ts, f["ids"], f["rays"], uv=f["uv"], vel=f["vel"])
        at = fi if at is None and res.status == vio_engine.Status.TRACKING else at
        if at is not None and fi >= at + 3:
            break
    step_ms = eng.measure_device_step(CLI_DEVICE_STEPS)
    _check(step_ms is not None and step_ms > 0, f"measure_device_step gave {step_ms}")
    out = dict(counts=counts, frames=frames, poses=ev["poses"], fps=ev["fps"],
               ate=ev["ate_rmse_m"], rpe=ev["rpe_trans_rmse_m"], ms_per_tracking_call=ms,
               stage_ms=timing, syncs_per_pipelined_frame=float(np.mean(pipe.syncs)),
               syncs_per_sync_frame=float(np.mean(sync.syncs)), map_points=len(map_pts),
               resume_max_dp=d_resume, resume_poses=len(after), pipelined_max_dp=d_pipe,
               pipelined_common=len(common), device_step_ms=step_ms,
               run_dir=run_dir, seq=seq, seconds=time.perf_counter() - t_phase)
    print(f"[phase 6] synchronous: {len(sync.poses)} poses, host syncs per tracking frame "
          f"{sync.syncs}; checkpoint at {t_ck:.3f} s, resumed {len(after)} poses, largest "
          f"position difference to the uninterrupted run {d_resume:.3e} m; pipelined against "
          f"synchronous over {len(common)} poses {d_pipe:.3e} m (bar {PIPE_TOL} m); "
          f"measure_device_step({CLI_DEVICE_STEPS}) {step_ms:.3f} ms on the bench features "
          f"(TRACKING at frame {at}); phase 6 took {out['seconds']:.1f} s", flush=True)
    _check(ate_ok, f"ATE {ev['ate_rmse_m']} m over {ev['poses']} poses (bar {ATE_TOL} m)")
    return out


# ---------------------------------------------------------------------------
# Phase 7: the fleet (parallel/batch.py)
# ---------------------------------------------------------------------------

def _fleet_pairs(data, cam, cfg, sim, example, pair):
    """FLEET_B bench frame pairs on the card: phase 2's and the pairs at
    FLEET_PAIRS; each (img0, pyr0, img1, pyr1, pts, active), active the
    detector's valid slots less every 16th (as phase 2)."""
    pairs = [pair] + [bench_pair(data, cam, cfg, sim, example, frames=fr)
                      for fr in FLEET_PAIRS]
    out = []
    for img0, pyr0, img1, pyr1, pts, valid in pairs:
        active = valid.clone()
        active[::16] = False
        out.append((img0, pyr0, img1, pyr1, pts, active))
    return out


def _stacked(pairs, i):
    """Field i of every pair stacked on a leading fleet axis (a pyramid
    level by level)."""
    first = pairs[0][i]
    if isinstance(first, (tuple, list)):
        return [torch.stack([p[i][l] for p in pairs]) for l in range(len(first))]
    return torch.stack([p[i] for p in pairs])


def _all_same(batched, singles) -> bool:
    """Every output of a batched launch bit-equal (NaN equal to NaN) to the
    single launches', sequence by sequence."""
    return all(_same(x[b], y) for b, single in enumerate(singles)
               for x, y in zip(batched, single))


def phase_fleet_kernels(lk, pairs, cfg):
    """K1, K2, K3 at B = FLEET_B: one batched launch against B single
    launches on the same inputs (bit-equal), the batched outputs against
    the plain versions at phase 2's bars, the launch through the vmap rule
    (one launch, the same bits), and the batched launch timed as phase 2
    times single ones, with its bound from the pixels its blocks read."""
    tcfg = cfg.tracker
    win = tcfg.lk_window_size
    half = (win - 1) // 2
    params = lk.LKParams(window=win, levels=tcfg.lk_pyramid_levels,
                         iters=tcfg.lk_iterations, eps=tcfg.lk_eps)
    n = len(pairs)
    img0, pyr0, img1, pyr1, pts, act = (_stacked(pairs, i) for i in range(6))
    results = {}

    def through_vmap(fn, *args):
        before = dict(lk.launch_counts)
        out = torch.func.vmap(fn)(*args)
        counts = {k: lk.launch_counts[k] - before[k] for k in before}
        return out, counts

    # K1
    k1_prep = lk._track_prep_batched(pyr0, pyr1, pts, act, params)
    _check(all(a.data_ptr() == b.data_ptr() for a, b in zip(k1_prep[0] + k1_prep[1],
                                                             pyr0 + pyr1)),
           "K1's batched prep copied a level")
    pos_b, ok_b = lk._track_launch(*k1_prep)
    singles = [lk._track_pyramidal_cuda(p[1], p[3], p[4], p[5], params) for p in pairs]
    (pos_v, ok_v), counts = through_vmap(
        lambda a, b, c, d: lk.track_pyramidal(a, b, c, d, params), pyr0, pyr1, pts, act)
    torch.cuda.synchronize()
    _check(_all_same((pos_b, ok_b), singles), "K1: the batched launch differs from "
           "the single launches")
    _check(_same(pos_v, pos_b) and _same(ok_v, ok_b), "K1: the vmap rule's launch "
           "differs from the batched launch")
    _check(counts["track_pyramidal"] == 1, f"K1 under vmap launched {counts}")
    err1, flops1, read1, chain1 = 0.0, 0, 0, 0
    for b, (_, p0, _, p1, q, a) in enumerate(pairs):
        its, wins, steps = [], [], []
        pos_p, ok_p = lk.track_pyramidal_ref(p0, p1, q, a, params, iterations=its,
                                             windows=wins, steps=steps)
        chain1 = max(chain1, int(steps[0].max()))
        _check(bool((ok_b[b] == ok_p).all()), f"K1 sequence {b}: ok masks differ "
               "from the plain version")
        both = ok_b[b] & ok_p
        err1 = max(err1, float((pos_b[b] - pos_p)[both].norm(dim=-1).max()))
        n_live = int(a.sum())
        flops1 += (n_live * len(p0) * (_template_flops(win) + _sums_flops(win))
                   + sum(its) * _track_iter_flops(win))
        read1 += _k1_read_bytes(p0, p1, q[a], wins, win)
    _check(err1 < POS_TOL, f"K1 batched: position difference {err1} px")
    results["track_pyramidal"] = dict(
        batched_err=err1, batched_chain_steps_max=chain1,
        batched_ms=_time_ms(lambda: torch.func.vmap(
            lambda a, b, c, d: lk.track_pyramidal(a, b, c, d, params))(pyr0, pyr1, pts, act)),
        batched_launch_ms=_time_graph_ms(lambda: lk._track_launch(*k1_prep)),
        **{f"batched_{k}": v for k, v in
           _bound(read1 + _nbytes(pts, act, pos_b, ok_b), flops1).items()})

    # K3 at the tracked points of the new frames (the FB templates).
    k3_prep = lk._extract_prep_batched(img1, pos_b, win)
    _check(k3_prep[0].data_ptr() == img1.data_ptr(), "K3's batched prep copied the images")
    t_b = lk._extract_launch(*k3_prep)
    singles = [lk._extract_patches_cuda(p[2], pos_b[b], win) for b, p in enumerate(pairs)]
    t_v, counts = through_vmap(lambda i, c: lk.extract_patches(i, c, win), img1, pos_b)
    torch.cuda.synchronize()
    _check(_all_same(t_b, singles), "K3: the batched launch differs from the single launches")
    _check(all(_same(x, y) for x, y in zip(t_v, t_b)), "K3: the vmap rule's launch differs")
    _check(counts["extract_patches"] == 1, f"K3 under vmap launched {counts}")
    err3, read3 = 0.0, 0
    for b, p in enumerate(pairs):
        t_p = lk.extract_patches_ref(p[2], pos_b[b], win)
        err3 = max(err3, max(float((x[b] - y).abs().max()) for x, y in zip(t_b, t_p)))
        h1, w1 = p[2].shape
        read3 += _footprint_bytes(
            p[2], _origin(pos_b[b][:, 1], half + 1, half + 2, h1, win + 3),
            _origin(pos_b[b][:, 0], half + 1, half + 2, w1, win + 3), win + 3)
    _check(err3 < PATCH_TOL, f"K3 batched: patch difference {err3}")
    results["extract_patches"] = dict(
        batched_err=err3,
        batched_ms=_time_ms(lambda: torch.func.vmap(
            lambda i, c: lk.extract_patches(i, c, win))(img1, pos_b)),
        batched_launch_ms=_time_graph_ms(lambda: lk._extract_launch(*k3_prep)),
        **{f"batched_{k}": v for k, v in _bound(
            read3 + _nbytes(pos_b, *t_b), n * pos_b.shape[1] * _template_flops(win)).items()})

    # K2 at both tracker settings, as phase 2.
    anchor = [torch.stack(x) for x in zip(*[lk.extract_patches_ref(p[0], p[4], win)
                                            for p in pairs])]
    settings = {
        "fb": (pyr0[0], t_b, pts, tcfg.lk_iterations, 2.0 + tcfg.fb_max_err),
        "anchor": (img1, anchor, pos_b, tcfg.anchor_iters, tcfg.anchor_max_shift),
    }
    err2, times = 0.0, {}
    for name, (img, tmpl, start, iters, max_shift) in settings.items():
        args = (img, *tmpl, start, ok_b, win, iters, tcfg.lk_eps, max_shift)
        prep = lk._refine_prep_batched(*args)
        _check(prep[0].data_ptr() == img.data_ptr(), "K2's batched prep copied the images")
        out_b = lk._refine_launch(*prep)
        singles = [lk._refine_template_cuda(img[b], *(t[b] for t in tmpl), start[b], ok_b[b],
                                            win, iters, tcfg.lk_eps, max_shift)
                   for b in range(n)]
        out_v, counts = through_vmap(
            lambda i, t, gx, gy, s, a: lk.refine_template(i, t, gx, gy, s, a, win, iters,
                                                          tcfg.lk_eps, max_shift),
            img, *tmpl, start, ok_b)
        torch.cuda.synchronize()
        _check(_all_same(out_b, singles), f"K2 ({name}): the batched launch differs "
               "from the single launches")
        _check(all(_same(x, y) for x, y in zip(out_v, out_b)),
               f"K2 ({name}): the vmap rule's launch differs")
        _check(counts["refine_template"] == 1, f"K2 ({name}) under vmap launched {counts}")
        flops, read, chain = 0, 0, 0
        for b in range(n):
            n_its, wins, steps = [], [], []
            pp, okp, rp = lk.refine_template_ref(img[b], *(t[b] for t in tmpl), start[b],
                                                 ok_b[b], win, iters, tcfg.lk_eps,
                                                 max_shift, iterations=n_its, windows=wins,
                                                 steps=steps)
            chain = max(chain, int(steps[0].max()))
            _check(bool((out_b[1][b] == okp).all()), f"K2 ({name}) sequence {b}: ok masks "
                   "differ from the plain version")
            m = out_b[1][b] & okp
            err2 = max(err2, float((out_b[0][b] - pp)[m].norm(dim=-1).max()),
                       float((out_b[2][b] - rp)[m].abs().max()))
            n_act = int(ok_b[b].sum())
            flops += n_act * _refine_fixed_flops(win) + n_its[0] * _refine_iter_flops(win)
            xs, ys = (torch.cat([w[i] for w in wins]) for i in (0, 1))
            read += (_footprint_bytes(img[b], _origin(ys, half, half + 2, img.shape[1], win + 1),
                                      _origin(xs, half, half + 2, img.shape[2], win + 1), win + 1)
                     + 3 * n_act * win * win * 4)
        _check(err2 < POS_TOL, f"K2 ({name}) batched: difference {err2}")
        times[name] = dict(
            batched_chain_steps_max=chain,
            batched_ms=_time_ms(lambda: torch.func.vmap(
                lambda i, t, gx, gy, s, a: lk.refine_template(
                    i, t, gx, gy, s, a, win, iters, tcfg.lk_eps, max_shift))(
                        img, *tmpl, start, ok_b)),
            batched_launch_ms=_time_graph_ms(lambda: lk._refine_launch(*prep)),
            **{f"batched_{k}": v for k, v in
               _bound(read + _nbytes(start, ok_b, *out_b), flops).items()})
    results["refine_template"] = dict(batched_err=err2, **times["fb"],
                                      **{f"{k}_anchor": v for k, v in times["anchor"].items()})
    for name, r in results.items():
        print(f"[phase 7] {name} at B={n}: batched launch bit-equal to {n} single "
              f"launches and to the vmap rule's one launch; vs plain {r['batched_err']:.3g}; "
              f"wrapper (vmap) {r['batched_ms']:.4f} ms, launch (graph) "
              f"{r['batched_launch_ms']:.4f} ms, bound {r['batched_bound_ms']:.5f} ms "
              f"({r['batched_bound_by']})" + (
                  f", slowest point of the fleet {r['batched_chain_steps_max']} steps"
                  if "batched_chain_steps_max" in r else ""), flush=True)
    r = results["refine_template"]
    print(f"[phase 7] refine_template anchor at B={n}: wrapper (vmap) "
          f"{r['batched_ms_anchor']:.4f} ms, launch (graph) "
          f"{r['batched_launch_ms_anchor']:.4f} ms, bound "
          f"{r['batched_bound_ms_anchor']:.5f} ms, slowest point of the fleet "
          f"{r['batched_chain_steps_max_anchor']} steps", flush=True)
    for r in results.values():
        r["batched_B"] = n
    return results


def _tree_map(fn, tree):
    """``fn`` applied to every tensor of a tree of (named) tuples; other
    leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        fields = [_tree_map(fn, x) for x in tree]
        return type(tree)(*fields) if hasattr(tree, "_fields") else tuple(fields)
    return tree


def _to64(tree):
    """A tree with every floating tensor in float64 (phases 7 and 9's parity
    runs)."""
    return _tree_map(lambda t: t.double() if t.is_floating_point() else t, tree)


def _clone_gen(g: torch.Generator) -> torch.Generator:
    c = torch.Generator(device=g.device)
    c.set_state(g.get_state())
    return c


def phase_image_fleet(lk, cfg, sim, example, make_camera, serve):
    """FLEET_B sequences of the bench's image-path stretch, each from its
    own start frame and with its own RANSAC seed, streamed to chunked mode
    by its own ChunkedImageServer; their carries stacked and run through
    make_batched_image_step for FLEET_CHUNKS chunks of CHUNK frames."""
    from mobile_slam_tpu_torch.engine import chunked
    from mobile_slam_tpu_torch.engine.serving import ChunkedImageServer
    from mobile_slam_tpu_torch.eval.evaluator import compute_ate
    from mobile_slam_tpu_torch.parallel import batch
    from mobile_slam_tpu_torch.probes.sync_sites import SyncSites

    t_phase = time.perf_counter()
    cam = make_camera(cfg.camera, dtype=torch.float64, device="cpu")
    data = sim.simulate(example.bench_sim_config(SERVE_SECONDS), cam,
                        cfg.camera.r_ic_mat, cfg.camera.t_ic_vec)
    frames = {}

    def frame(fi):
        if fi not in frames:
            frames[fi] = sim.render_frame(data, fi, cam, example.R_IC, cfg.camera.t_ic_vec)
        return frames[fi]

    n_fleet = FLEET_CHUNKS * CHUNK
    seqs = []
    for s, start in enumerate(FLEET_STARTS):
        server = ChunkedImageServer(cfg, chunk_size=CHUNK, stable_frames=4)
        server.engine._gen.manual_seed(FLEET_SEED + s)
        imu_i = 0 if start == 0 else int(np.searchsorted(data.imu_ts, data.cam_ts[start - 1],
                                                         side="right"))
        fi, stream_ts, stream_p = start, [], []
        while server.mode != "chunked":
            _check(fi < start + 60, f"fleet sequence {s} never entered chunked mode")
            imu_i = _feed_imu(server, data, imu_i, data.cam_ts[fi])
            for r in server.process_frame(frame(fi), data.cam_ts[fi]):
                stream_ts.append(r.ts)
                stream_p.append(r.p)
            fi += 1
        _check(fi + n_fleet <= len(data.frames), f"fleet sequence {s} runs past the data")
        inputs, ts = [], []
        for k in range(fi, fi + n_fleet):
            imu_i = _feed_imu(server, data, imu_i, data.cam_ts[k])
            inputs.append(server._frame_input(frame(k), data.cam_ts[k]))
            ts.append(data.cam_ts[k])
        seqs.append(dict(server=server, carry=server._carry, inputs=inputs, ts=ts,
                         stream_ts=stream_ts, stream_p=stream_p, entry=fi))
    print(f"[phase 7] image fleet: {FLEET_B} sequences from frames {FLEET_STARTS}, "
          f"chunked from frames {[q['entry'] for q in seqs]}, "
          f"{sum(len(q['stream_p']) for q in seqs)} streamed poses", flush=True)

    eng = seqs[0]["server"].engine
    dev, iters, n_it = eng.device, cfg.tracker.ransac_iters, cfg.estimator.num_iterations
    focal, check = cfg.camera.focal_length, FLEET_CHECK_FRAMES

    # Parity, float64: the fleet's first frames against each sequence's own
    # single-stream chunk from the same carry and frames, the same draws.
    args64 = (_to64(eng.params), n_it, cfg.tracker,
              make_camera(cfg.camera, dtype=torch.float64, device=dev), focal)
    # The first frames' rows of the (CHUNK, iters, 8) draws the fleet's own
    # generators will give its first chunk.
    draws = [torch.randint(0, 1 << 30, (CHUNK, iters, 8), generator=_clone_gen(q["carry"].gen),
                           device=dev)[:check] for q in seqs]
    first = [[_to64(x) for x in q["inputs"][:check]] for q in seqs]
    single64 = chunked.make_chunked_image_step(*args64)
    ref64 = [single64(_to64(q["carry"]), chunked.stack_image_inputs(f, dev), ransac_draws=d)[1]
             for q, f, d in zip(seqs, first, draws)]
    inputs64 = chunked.ImageFrameInput(*[torch.stack(x, dim=1) for x in zip(
        *[chunked.stack_image_inputs(f, dev) for f in first])])
    _, out64 = batch.make_batched_image_step(*args64)(
        batch.batch_states([_to64(q["carry"]) for q in seqs]), inputs64,
        ransac_draws=torch.stack(draws, dim=1))
    diffs64 = []
    for s, r in enumerate(ref64):
        diffs64.append(float((out64[0][:, s] - r[0]).norm(dim=-1).max()))
        _check(diffs64[-1] < FLEET_POS_TOL, f"image fleet sequence {s} (float64): first "
               f"{check} frames {diffs64[-1]} m from its single-stream run")
        _check(bool(torch.equal(out64[3][:, s], r[3])), f"image fleet sequence {s} "
               "(float64): keyframe flags differ from its single-stream run")

    # The same first frames in float32 single-stream, to set beside the
    # float32 fleet's: printed, not held to FLEET_POS_TOL (batched and
    # single float32 products round differently and the solver amplifies
    # that, PERF.md).
    single_p, single_kf = [], []
    for q, d in zip(seqs, draws):
        one = q["server"]._step(q["carry"], chunked.stack_image_inputs(q["inputs"][:check], dev),
                                ransac_draws=d)[1]
        single_p.append(one[0].cpu().numpy())
        single_kf.append(one[3].cpu().numpy())

    # What phase 11 runs again over ranks, taken before this fleet's run
    # advances the sequences' generators: host copies, each generator as
    # its state.
    handoff = dict(
        params=_tree_map(lambda t: t.cpu(), eng.params),
        carries=[_tree_map(lambda t: t.cpu(), q["carry"]._replace(gen=q["carry"].gen.get_state()))
                 for q in seqs],
        inputs=[q["inputs"] for q in seqs], ts=[q["ts"] for q in seqs],
        stream_ts=[q["stream_ts"] for q in seqs], stream_p=[q["stream_p"] for q in seqs],
        draws=[d.cpu() for d in draws], out64=tuple(x.cpu() for x in out64),
        cam_ts=data.cam_ts, gt_p=data.gt_p)
    step = batch.make_batched_image_step(eng.params, n_it, cfg.tracker, eng.camera, focal)
    carry = batch.batch_states([q["carry"] for q in seqs])
    outs, walls = [], []
    lk.reset_launch_counts()
    for c in range(FLEET_CHUNKS):
        per_seq = [chunked.stack_image_inputs(q["inputs"][c * CHUNK:(c + 1) * CHUNK], dev)
                   for q in seqs]
        inputs = chunked.ImageFrameInput(*[torch.stack(x, dim=1) for x in zip(*per_seq)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if c == FLEET_CHUNKS - 1:
            with SyncSites() as sc:
                carry, out = step(carry, inputs)
            syncs = sum(sc.sites.values())
        else:
            carry, out = step(carry, inputs)
        out = tuple(x.cpu().numpy() for x in out)
        walls.append(time.perf_counter() - t0)
        outs.append(out)
    counts = dict(lk.launch_counts)
    p = np.concatenate([o[0] for o in outs])      # (T, B, 3)
    ok = np.concatenate([o[2] for o in outs])
    kf = np.concatenate([o[3] for o in outs])
    _check(bool(np.isfinite(p).all()), "image fleet: non-finite poses")
    for k, per in LK_PER_FRAME.items():
        _check(counts[k] == per * n_fleet, f"image fleet: {k} launched {counts[k]} times "
               f"over {n_fleet} fleet frames of {FLEET_B} sequences")
    diffs, same_kf, ates = [], [], []
    for s, q in enumerate(seqs):
        diffs.append(float(np.linalg.norm(p[:check, s] - single_p[s], axis=-1).max()))
        same_kf.append(bool((kf[:check, s] == single_kf[s]).all()))
        est_ts = q["stream_ts"] + [t for t, o in zip(q["ts"], ok[:, s]) if o]
        est_p = q["stream_p"] + [x for x, o in zip(p[:, s], ok[:, s]) if o]
        ate = compute_ate(np.asarray(est_ts), np.asarray(est_p), data.cam_ts, data.gt_p)
        ates.append(float(ate.rmse))
        _check(ate.rmse < ATE_TOL, f"image fleet sequence {s}: ATE {ate.rmse} m")
    _check(len({tuple(np.round(p[0, s], 6)) for s in range(FLEET_B)}) == FLEET_B,
           "image fleet: two sequences gave the same first pose")
    fps = FLEET_B * CHUNK / walls[0]
    out = dict(counts=counts, fps=fps, fps_per_seq=fps / FLEET_B,
               ms_per_fleet_frame=1e3 * walls[0] / CHUNK, chunk_walls_s=walls,
               syncs_per_fleet_frame=syncs / CHUNK, ates=ates, first_frames_diff_f64=diffs64,
               first_frames_diff_f32=diffs, first_frames_same_kf_f32=same_kf,
               ok_frames=int(ok.sum()), seconds=time.perf_counter() - t_phase)
    handoff.update(p32=p, kf32=kf)
    out["handoff"] = handoff
    print(f"[phase 7] image fleet B={FLEET_B}: {FLEET_CHUNKS} chunks of {CHUNK}, "
          f"{out['ok_frames']} of {FLEET_B * n_fleet} poses ok; fleet fps {fps:.3f} "
          f"({out['fps_per_seq']:.3f} per sequence), {out['ms_per_fleet_frame']:.2f} ms per "
          f"fleet frame (chunk walls {[round(w, 3) for w in walls]} s); host syncs per "
          f"fleet frame {out['syncs_per_fleet_frame']:.2f}; phase 4 chunked fps "
          f"{serve['chunked_fps']:.3f} ({serve['ms_per_chunked_frame']:.2f} ms per frame); "
          f"ATE per sequence {[round(a, 4) for a in ates]} m; first {check} frames "
          f"vs each sequence's single run: float64 {diffs64} m (same keyframe flags), "
          f"float32 {diffs} m (same keyframe flags {same_kf}); launches {counts} over "
          f"{n_fleet} fleet frames; phase 7 image fleet took {out['seconds']:.1f} s",
          flush=True)
    return out


def _feature_inputs(cfg, data, sim, fi0, n, t0, noise_seed, device):
    """FrameInputs of frames fi0 .. fi0 + n - 1 on the card (as
    tests/test_torch_chunked.py builds them), the observations moved by
    seeded pixel noise (FLEET_PIXEL_NOISE px, through the focal length)."""
    from mobile_slam_tpu_torch.engine.estimator import FrameInput

    rng = np.random.default_rng(noise_seed)
    k_pad, m_pad = cfg.tracker.max_points, cfg.estimator.max_imu_per_interval
    f32 = dict(dtype=torch.float32, device=device)

    def pad(a, n_p, sh):
        out = np.zeros((n_p,) + sh)
        out[:min(len(a), n_p)] = a[:n_p]
        return torch.as_tensor(out, **f32)

    out = []
    for fi in range(fi0, fi0 + n):
        f = data.frames[fi]
        m = len(f["ids"])
        px = rng.normal(0.0, FLEET_PIXEL_NOISE, (m, 2))
        rays = np.array(f["rays"], dtype=np.float64)
        rays[:, :2] += px / cfg.camera.focal_length
        uv = np.asarray(f["uv"]) + px
        dt, acc, gyr = sim.imu_between(data, data.cam_ts[fi - 1], data.cam_ts[fi])
        ids = np.full(k_pad, -1, np.int32)
        ids[:m] = f["ids"][:k_pad]
        out.append(FrameInput(
            ts=torch.tensor(data.cam_ts[fi] - t0, **f32),
            ids=torch.as_tensor(ids, device=device),
            obs=pad(rays, k_pad, (3,)), uv=pad(uv, k_pad, (2,)), vel=pad(f["vel"], k_pad, (2,)),
            valid=torch.as_tensor(np.arange(k_pad) < m, device=device),
            imu_dt=pad(dt, m_pad, ()), imu_acc=pad(acc, m_pad, (3,)),
            imu_gyr=pad(gyr, m_pad, (3,)),
            imu_cnt=torch.tensor(min(len(dt), m_pad), dtype=torch.int32, device=device)))
    return out


def phase_feature_fleet(cfg, data, sim, serve):
    """FEATURE_FLEET_B copies of the bench's feature-path state after
    initialization, each fed the bench's feature chunks with its own seeded
    pixel noise, through make_batched_chunked_step; each sequence held
    against its own make_chunked_step run over the first FLEET_SINGLE_FRAMES
    frames."""
    from mobile_slam_tpu_torch.engine import chunked
    from mobile_slam_tpu_torch.engine.vio_engine import Status, VIOEngine
    from mobile_slam_tpu_torch.parallel import batch

    t_phase = time.perf_counter()
    engine = VIOEngine(cfg)
    imu_i, fi0 = 0, None
    for fi in range(len(data.frames)):
        imu_i = _feed_imu(engine, data, imu_i, data.cam_ts[fi])
        f = data.frames[fi]
        res = engine.process_features(data.cam_ts[fi], f["ids"], f["rays"], uv=f["uv"],
                                      vel=f["vel"])
        if res.status == Status.TRACKING and fi0 is None:
            fi0 = fi + 4            # TRACKING + 3 frames, as the bench
        if fi0 is not None and fi + 1 == fi0:
            break
    _check(fi0 is not None, "feature fleet: the engine never reached TRACKING")
    n = FLEET_CHUNKS * CHUNK
    _check(fi0 + n <= len(data.frames), "feature fleet: the chunks run past the data")
    seq_inputs = [_feature_inputs(cfg, data, sim, fi0, n, engine._t0, FLEET_SEED + s,
                                  engine.device) for s in range(FEATURE_FLEET_B)]
    n_it, check = cfg.estimator.num_iterations, FLEET_CHECK_FRAMES

    def fleet_inputs(seqs, lo, hi):
        rows = [chunked.stack_frame_inputs(seq[lo:hi]) for seq in seqs]
        return type(rows[0])(*[torch.stack(x, dim=1) for x in zip(*rows)])

    # Parity, float64: the fleet's first frames against each sequence's own
    # make_chunked_step from the same state.
    p64, state64 = _to64(engine.params), _to64(engine.state)
    first64 = [[_to64(x) for x in seq[:check]] for seq in seq_inputs]
    single64 = chunked.make_chunked_step(p64, n_it)
    ref64 = [single64(state64, chunked.stack_frame_inputs(f))[1] for f in first64]
    _, out64 = batch.make_batched_chunked_step(p64, n_it)(
        batch.batch_states([state64] * FEATURE_FLEET_B), fleet_inputs(first64, 0, check))
    diffs64 = []
    for s, r in enumerate(ref64):
        diffs64.append(float((out64[0][:, s] - r[0]).norm(dim=-1).max()))
        _check(diffs64[-1] < FLEET_POS_TOL, f"feature fleet sequence {s} (float64): first "
               f"{check} frames {diffs64[-1]} m from its single run")
        _check(bool(torch.equal(out64[3][:, s], r[3])), f"feature fleet sequence {s} "
               "(float64): keyframe flags differ from its single run")

    single = chunked.make_chunked_step(engine.params, n_it)
    single_out, t_single = [], 0.0
    for s in range(FEATURE_FLEET_B):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = single(engine.state,
                        chunked.stack_frame_inputs(seq_inputs[s][:FLEET_SINGLE_FRAMES]))
        out = tuple(x.cpu().numpy() for x in out)
        t_single += time.perf_counter() - t0
        single_out.append(out)

    handoff = dict(params=_tree_map(lambda t: t.cpu(), engine.params),
                   state=_tree_map(lambda t: t.cpu(), engine.state),
                   inputs=[[_tree_map(lambda t: t.cpu(), x) for x in seq] for seq in seq_inputs],
                   out64=tuple(x.cpu() for x in out64))
    step = batch.make_batched_chunked_step(engine.params, n_it)
    state = batch.batch_states([engine.state] * FEATURE_FLEET_B)
    outs, walls = [], []
    for c in range(FLEET_CHUNKS):
        inputs = fleet_inputs(seq_inputs, c * CHUNK, (c + 1) * CHUNK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = step(state, inputs)
        outs.append(tuple(x.cpu().numpy() for x in out))
        walls.append(time.perf_counter() - t0)
    p = np.concatenate([o[0] for o in outs])
    kf = np.concatenate([o[3] for o in outs])
    _check(bool(np.isfinite(p).all()), "feature fleet: non-finite poses")
    diffs, first, same_kf = [], [], []
    for s, (p_s, _, ok_s, kf_s) in enumerate(single_out):
        d = np.linalg.norm(p[:FLEET_SINGLE_FRAMES, s] - p_s, axis=-1)
        diffs.append(float(d.max()))
        first.append(float(d[:check].max()))
        same_kf.append(bool((kf[:check, s] == kf_s[:check]).all()))
        _check(bool(np.isfinite(p_s).all()) and diffs[-1] < FLEET_CHUNK_TOL,
               f"feature fleet sequence {s}: {diffs[-1]} m from its single run over "
               f"{FLEET_SINGLE_FRAMES} frames")
    _check(len({tuple(np.round(p[-1, s], 6)) for s in range(FEATURE_FLEET_B)})
           == FEATURE_FLEET_B, "feature fleet: two sequences ended at the same pose")
    fps = FEATURE_FLEET_B * CHUNK / walls[0]
    single_fps = FEATURE_FLEET_B * FLEET_SINGLE_FRAMES / t_single
    out = dict(fps=fps, fps_per_seq=fps / FEATURE_FLEET_B, chunk_walls_s=walls,
               single_chunked_fps=single_fps, max_diff=max(diffs),
               first_frames_diff_f64=max(diffs64), first_frames_diff_f32=max(first),
               first_frames_same_kf_f32=same_kf, seconds=time.perf_counter() - t_phase)
    handoff.update(p32=p, kf32=kf)
    out["handoff"] = handoff
    print(f"[phase 7] feature fleet B={FEATURE_FLEET_B} from frame {fi0}: fleet fps "
          f"{fps:.3f} ({out['fps_per_seq']:.3f} per sequence; chunk walls "
          f"{[round(w, 3) for w in walls]} s); single-stream make_chunked_step "
          f"{single_fps:.3f} fps; phase 4 chunked (image path) fps {serve['chunked_fps']:.3f}; "
          f"first {check} frames vs each sequence's single run: float64 {max(diffs64):.3g} m "
          f"(same keyframe flags), float32 {max(first):.3g} m (same keyframe flags "
          f"{same_kf}); largest float32 difference over {FLEET_SINGLE_FRAMES} frames "
          f"{max(diffs):.3g} m; "
          f"phase 7 feature fleet took {out['seconds']:.1f} s", flush=True)
    return out


def mobile_sequence(sim, make_camera):
    """Phase 8's phone session: the configure overrides, the port's config
    they make (the gateway's build_config), the camera, and the simulated
    sequence (io/synthetic.py's noise, seed 7, the profile's phone rate,
    MOBILE_TD of camera-IMU offset). Also the median landmarks in view per
    frame under the profile's portrait default mount."""
    import dataclasses

    from mobile_slam_tpu_torch.io import synthetic
    from mobile_slam_tpu_torch.web import gateway

    overrides = {"camera": {"r_ic": list(MOBILE_R_IC)},
                 "estimator": {"estimate_td": True}}
    cfg = gateway.build_config(MOBILE_PROFILE, overrides)
    cam = make_camera(cfg.camera, dtype=torch.float64, device="cpu")
    scfg = dataclasses.replace(synthetic.sim_config(MOBILE_SECONDS, seed=7, noise=True),
                               cam_rate=MOBILE_CAM_RATE, cam_time_offset=MOBILE_TD)
    data = sim.simulate(scfg, cam, cfg.camera.r_ic_mat, cfg.camera.t_ic_vec)
    portrait = gateway.build_config(MOBILE_PROFILE, {}).camera
    seen = sim.simulate(scfg, cam, portrait.r_ic_mat, portrait.t_ic_vec)
    in_view = float(np.median([len(f["ids"]) for f in seen.frames]))
    return overrides, cfg, cam, data, in_view


def _recv_json(conn, want_type):
    """The next text message of ``want_type``; fails on an error message or
    on any other message in between."""
    is_text, payload = conn.recv()
    _check(payload is not None and is_text, "the gateway closed the connection")
    msg = json.loads(payload)
    _check(msg.get("type") != "error", f"gateway error: {msg.get('message')}")
    _check(msg.get("type") == want_type, f"expected {want_type}, got {msg}")
    return msg


def phase_gateway(lk, overrides, cfg, cam, data, sim, in_view, device="cuda"):
    """The port's WebSocket gateway on ``device``, served in a thread on
    127.0.0.1 and driven by the port's ws client: configure (MOBILE_PROFILE,
    td on), the sequence's IMU batches and frames as binary messages, then
    reset, get_map_points and dispose."""
    import socket
    import struct
    import threading

    from mobile_slam_tpu_torch.eval.evaluator import compute_ate
    from mobile_slam_tpu_torch.probes.sync_sites import SyncSites
    from mobile_slam_tpu_torch.web import gateway, ws

    cuda = torch.device(device).type == "cuda"
    r_ic, t_ic = cfg.camera.r_ic_mat, cfg.camera.t_ic_vec
    frames = [sim.render_frame(data, fi, cam, r_ic, t_ic) for fi in range(len(data.frames))]
    imu = np.ascontiguousarray(np.column_stack([data.imu_ts, data.imu_acc, data.imu_gyr]),
                               "<f8")
    sock = socket.socket()
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("127.0.0.1", 0))
    sessions, ready = [], threading.Event()
    server = threading.Thread(target=gateway.serve, args=(0, ready, sock),
                              kwargs=dict(device=device, sessions=sessions), daemon=True)
    server.start()
    _check(ready.wait(30), "the gateway did not start")
    conn = ws.connect("127.0.0.1", sock.getsockname()[1])
    conn.send(json.dumps({"type": "configure", "profile": MOBILE_PROFILE,
                          "config": overrides}))
    msg = _recv_json(conn, "configured")
    session = sessions[0]
    _check(msg["width"] == 640 and msg["height"] == 480, f"configured {msg}")
    _check(session.engine.device.type == torch.device(device).type,
           f"the session's engine is on {session.engine.device}")
    td_max = cfg.estimator.td_max

    lk.reset_launch_counts()
    rows, est_ts, est_p, syncs, n_maps, want_maps = [], [], [], [], 0, 0
    imu_i, init, t0 = 0, None, time.perf_counter()
    for fi, ts in enumerate(data.cam_ts):
        j = int(np.searchsorted(data.imu_ts, ts + 1e-9))
        if j > imu_i:
            conn.send(struct.pack("<BBH", gateway.MSG_IMU, 0, j - imu_i) + imu[imu_i:j].tobytes())
            imu_i = j
        h, w = frames[fi].shape
        counted = init is not None and len(syncs) < MOBILE_SYNC_FRAMES and fi >= init + 10
        sc = SyncSites().__enter__() if counted and cuda else None
        conn.send(struct.pack("<BBHHHd", gateway.MSG_FRAME, 0, w, h, 0, ts)
                  + frames[fi].tobytes())
        res = _recv_json(conn, "result")
        if sc is not None:
            sc.__exit__(None, None, None)
            syncs.append(sum(sc.sites.values()))
        td = session.last_result.td
        rows.append((fi, res["status"], res["ok"], res["proc_ms"], td))
        if init is None and res["status"] == "TRACKING":
            init = fi
        if res["ok"]:
            P = np.asarray(res["pose"]).reshape(4, 4)
            _check(np.abs(P[:3, :3] @ P[:3, :3].T - np.eye(3)).max() < 1e-4
                   and np.linalg.det(P[:3, :3]) > 0 and np.array_equal(P[3], [0, 0, 0, 1]),
                   f"frame {fi}: the pose is not SE(3)")
            _check(td is not None and np.isfinite(td) and abs(td) <= td_max,
                   f"frame {fi}: td {td}")
            # The pose is world-from-camera; the body sits at the camera
            # (t_ic = 0), as the ground truth's positions do.
            est_ts.append(res["ts"])
            est_p.append(P[:3, 3] - P[:3, :3] @ r_ic.T @ t_ic)
        if res["ok"] and (fi + 1) % gateway.MAP_POINTS_EVERY == 0:
            want_maps += 1
            pts = np.asarray(_recv_json(conn, "map_points")["points"])
            _check(len(pts) > 0 and np.isfinite(pts).all(), f"frame {fi}: map points {pts.shape}")
            n_maps += 1
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(lk.launch_counts)
    conn.send(json.dumps({"type": "reset"}))
    _recv_json(conn, "reset_done")
    conn.send(json.dumps({"type": "get_map_points"}))
    _check(_recv_json(conn, "map_points")["points"] == [], "reset left map points")
    conn.send(json.dumps({"type": "dispose"}))
    _recv_json(conn, "disposed")
    conn.close()
    session.thread.join(60)
    sock.shutdown(socket.SHUT_RDWR)
    sock.close()
    server.join(60)
    _check(not session.thread.is_alive() and not server.is_alive(),
           "the gateway's threads did not end")

    n = len(rows)
    _check(init is not None, "the session never reached TRACKING")
    after = [r for r in rows if r[0] > init]
    n_ok = sum(r[2] for r in after)
    _check(n_ok >= MOBILE_MIN_OK * len(after), f"{n_ok} of {len(after)} frames after "
           f"initialization ok")
    _check(n_maps == want_maps and n_maps > 0, f"{n_maps} map_points messages")
    if cuda:
        for k, per in LK_PER_FRAME.items():
            _check(counts[k] == per * n, f"{k}: {counts[k]} launches over {n} frames")
    ate = compute_ate(np.asarray(est_ts), np.asarray(est_p), data.cam_ts, data.gt_p)
    _check(ate.rmse < ATE_TOL, f"ATE {ate.rmse} m")
    proc = np.asarray([r[3] for r in rows if r[0] > init and r[2]])
    tds = [(r[0], r[4]) for r in rows if r[4] is not None]
    out = dict(counts=counts, frames=n, init_frame=init, ok_after_init=n_ok,
               ate=float(ate.rmse), n_poses=len(est_p), td_final=tds[-1][1],
               proc_ms_median=float(np.median(proc)),
               proc_ms_p90=float(np.percentile(proc, 90)), fps=n / wall,
               syncs_per_frame=float(np.mean(syncs)) if syncs else None,
               map_messages=n_maps, portrait_in_view=in_view)
    print(f"[phase 8] sequence: {n} frames at {1.0 / np.diff(data.cam_ts).mean():.2f} fps, "
          f"{MOBILE_TD * 1e3:.1f} ms camera-IMU offset; landmarks in view per frame "
          f"(median) {np.median([len(f['ids']) for f in data.frames]):.0f} with the "
          f"client's forward mount, {in_view:.0f} with the profile's portrait default",
          flush=True)
    print(f"[phase 8] td every 10 frames (ms): "
          f"{[(fi, round(1e3 * td, 3)) for fi, td in tds[::10]]}; final "
          f"{1e3 * out['td_final']:.3f} ms against {MOBILE_TD * 1e3:.1f} ms injected; "
          f"largest |td| {1e3 * max(abs(td) for _, td in tds):.3f} ms", flush=True)
    print(f"[phase 8] TRACKING at frame {init}; {n_ok} of {len(after)} frames after it ok; "
          f"ATE sim3 rmse {ate.rmse:.4f} m over {ate.num_pairs} pairs; {n_maps} map_points "
          f"messages; proc_ms median {out['proc_ms_median']:.2f} p90 {out['proc_ms_p90']:.2f} "
          f"against the {MOBILE_PERIOD_MS:.1f} ms period of a 30 fps phone; session "
          f"{out['fps']:.3f} fps ({wall:.1f} s for {n} frames); host syncs per tracking "
          f"frame {syncs}; launches {counts} ({', '.join(f'{k} {counts[k] / n:.2f}' for k in LK_PER_FRAME)} per frame)",
          flush=True)
    return out


@contextlib.contextmanager
def _flags(settings):
    """Set module globals ({(module, name): value}) and restore them."""
    old = {key: getattr(*key) for key in settings}
    try:
        for (mod, name), val in settings.items():
            setattr(mod, name, val)
        yield
    finally:
        for (mod, name), val in old.items():
            setattr(mod, name, val)


def _solver_arms():
    """Phase 9's arms: the options the JAX package's A/B harnesses flip."""
    from mobile_slam_tpu_torch.factors import marginalization as marg
    from mobile_slam_tpu_torch.frontend import feature_table as ft
    from mobile_slam_tpu_torch.solver import lm

    dense = {(marg, "SQRT_MARGIN_OLD"): False, (marg, "SQRT_MARGIN_NEW"): False}
    return {
        "default": {},
        "early_exit_ftol=0": {(lm, "EARLY_EXIT_FTOL"): 0.0},
        "early_exit_ftol=1e-6": {(lm, "EARLY_EXIT_FTOL"): FTOL_SMALL},
        "greedy_gn": {(lm, "GREEDY_GN"): True},
        "batch_candidates": {(lm, "BATCH_CANDIDATES"): True},
        "dense_prior": dense,
        "dense_prior_restricted": {**dense, (marg, "RESTRICTED_SUPPORT"): True},
        "eigh_triangulation": {(ft, "ADJUGATE_TRIANGULATION"): False},
    }


def _prior_gaps(a, b):
    """How far two priors part in information (QR and eigh row signs are not
    unique), as tests/test_sqrt_marginalization.py compares them:
    max |ΔJ0ᵀJ0| / max |J0ᵀJ0| and max |ΔJ0ᵀr0| / max |J0ᵀr0|."""
    H_a, H_b = a.J0.T @ a.J0, b.J0.T @ b.J0
    g_a, g_b = a.J0.T @ a.r0, b.J0.T @ b.r0
    return (float((H_a - H_b).abs().max() / H_b.abs().max().clamp(min=1e-30)),
            float((g_a - g_b).abs().max() / g_b.abs().max().clamp(min=1e-12)))


def _linearization(stream, cfg, device):
    """Phase 3's last tracking state in float64 on ``device`` as a solver
    input: (x: the window with depths from triangulation, table, window,
    prior, static params)."""
    from mobile_slam_tpu_torch.engine import estimator as est
    from mobile_slam_tpu_torch.frontend import feature_table as ft
    from mobile_slam_tpu_torch.models.state import eligible_mask
    from mobile_slam_tpu_torch.solver import assembly

    st = _tree_map(lambda t: t.to(device), _to64(stream["solve_state"]))
    ps = est.make_params(cfg, dtype=torch.float64, device=device)
    w = st.window
    table = ft.triangulate(st.table, w.p, w.q, ps.ex_t, ps.ex_q, ps.init_depth, td=st.td)
    lam = torch.where(eligible_mask(table),
                      1.0 / torch.where(table.depth > 0, table.depth, ps.init_depth),
                      torch.ones_like(table.depth))
    x = assembly.XState(p=w.p, q=w.q, v=w.v, ba=w.ba, bg=w.bg, lam=lam, td=st.td)
    return x, table, w, st.prior, ps


def _dense_margin_old(lin):
    from mobile_slam_tpu_torch.engine import estimator as est
    from mobile_slam_tpu_torch.factors import marginalization as marg
    from mobile_slam_tpu_torch.factors.imu_factor import sqrt_info_from_cov

    x, table, w, prior, ps = lin
    with _flags({(marg, "SQRT_MARGIN_OLD"): False}):
        return marg.marginalize_old(x, table, w, sqrt_info_from_cov(w.pre.cov[1:]), prior,
                                    ps.ex_t, ps.ex_q, est.solver_params(ps))


def phase_solver_arms(stream, cfg, device="cuda"):
    """(a) solve_and_slide from phase 3's last tracking frame under each arm:
    float64 checks, then float32 times, host syncs and LM iterations."""
    from mobile_slam_tpu_torch.engine import estimator as est
    from mobile_slam_tpu_torch.factors import marginalization as marg
    from mobile_slam_tpu_torch.probes.sync_sites import SyncSites
    from mobile_slam_tpu_torch.solver import lm

    arms = _solver_arms()
    st32, p32 = stream["solve_state"], stream["params"]
    st64, p64 = _to64(st32), est.make_params(cfg, dtype=torch.float64, device=device)
    runs = {}
    for name, kv in arms.items():
        with _flags(kv):
            lm.reset_counts()
            new, p, q, d = est.solve_and_slide(st64, True, p64, SOLVER_ITERS)
            runs[name] = dict(p=p, q=q, cost=float(d.solver_cost), acc=int(d.accepted_steps),
                              prior=new.prior, iters=lm.counts["iterations"])
            if name == "default" or name.startswith("dense"):
                runs[name]["prior_general"] = est.solve_and_slide(
                    st64, False, p64, SOLVER_ITERS)[0].prior
    base = runs["default"]

    def dp(name):
        r = runs[name]
        return max(float((r["p"] - base["p"]).abs().max()),
                   float((r["q"] - base["q"]).abs().max()))

    z = runs["early_exit_ftol=0"]
    _check(torch.equal(z["p"], base["p"]) and torch.equal(z["q"], base["q"])
           and z["cost"] == base["cost"] and z["acc"] == base["acc"],
           "EARLY_EXIT_FTOL = 0 is not bit-equal to the fixed loop")
    f = runs["early_exit_ftol=1e-6"]
    _check(f["acc"] <= base["acc"] and dp("early_exit_ftol=1e-6") <= FTOL_POSE_TOL,
           f"EARLY_EXIT_FTOL 1e-6: {f['acc']} steps against {base['acc']}, "
           f"poses {dp('early_exit_ftol=1e-6')}")
    b = runs["batch_candidates"]
    _check(b["acc"] == base["acc"] and dp("batch_candidates") <= BATCH_POSE_TOL,
           f"BATCH_CANDIDATES: {b['acc']} steps, poses {dp('batch_candidates')}")
    g = runs["greedy_gn"]
    _check(g["cost"] <= GREEDY_COST_RATIO * base["cost"]
           and dp("greedy_gn") <= GREEDY_POSE_TOL,
           f"GREEDY_GN: cost {g['cost']} against {base['cost']}, poses {dp('greedy_gn')}")
    # The priors. Dense and square-root margin-new agree once the dense
    # path's eigen threshold is at machine level (the procedure of
    # tests/test_sqrt_marginalization.py); RESTRICTED_SUPPORT changes
    # nothing while the prior keeps to its support; the dense margin-old on
    # the card is held against the same function on the CPU (on this state it
    # parts from the square-root margin-old by more than roundoff: printed).
    gaps = {name: _prior_gaps(runs[name]["prior"], base["prior"])
            + _prior_gaps(runs[name]["prior_general"], base["prior_general"])
            for name in ("dense_prior", "dense_prior_restricted")}
    with _flags({**arms["dense_prior"], (marg, "REL_EIG_EPS"): 1e-13}):
        gaps["dense margin-new, machine threshold"] = _prior_gaps(
            est.solve_and_slide(st64, False, p64, SOLVER_ITERS)[0].prior,
            base["prior_general"])
    gaps["restricted against dense"] = (
        _prior_gaps(runs["dense_prior_restricted"]["prior"], runs["dense_prior"]["prior"])
        + _prior_gaps(runs["dense_prior_restricted"]["prior_general"],
                      runs["dense_prior"]["prior_general"]))
    lin = _linearization(stream, cfg, device)
    gaps["dense margin-old, card against CPU"] = _prior_gaps(
        _tree_map(torch.Tensor.cpu, _dense_margin_old(lin)),
        _dense_margin_old(_tree_map(torch.Tensor.cpu, lin)))
    for name in ("dense margin-new, machine threshold", "restricted against dense",
                 "dense margin-old, card against CPU"):
        _check(max(gaps[name]) <= PRIOR_RTOL, f"{name}: prior gaps {gaps[name]}")
    _check(bool(torch.isfinite(runs["eigh_triangulation"]["p"]).all()),
           "eigh triangulation: non-finite pose")
    for name, r in runs.items():
        print(f"[phase 9] float64 {name}: {r['acc']} accepted of {r['iters']} LM "
              f"iterations, cost {r['cost']:.9g}, pose difference to the default "
              f"{dp(name):.3e}" + (f", prior gaps to the square-root prior (keyframe "
                                   f"J0ᵀJ0, J0ᵀr0; general J0ᵀJ0, J0ᵀr0) "
                                   f"{['%.2e' % x for x in gaps[name]]}"
                                   if name in gaps else ""), flush=True)
    for name in ("dense margin-new, machine threshold", "restricted against dense",
                 "dense margin-old, card against CPU"):
        print(f"[phase 9] prior gaps (J0ᵀJ0, J0ᵀr0), {name}: "
              f"{['%.2e' % x for x in gaps[name]]}", flush=True)

    out = {}
    for name, kv in arms.items():
        with _flags(kv):
            def call():
                return est.solve_and_slide(st32, True, p32, SOLVER_ITERS)

            call()
            torch.cuda.synchronize()
            with SyncSites() as sc:
                call()
                torch.cuda.synchronize()
            lm.reset_counts()
            ms = _time_ms(call, reps=SOLVER_REPS, warmup=1)
            out[name] = dict(ms=ms, syncs=sum(sc.sites.values()),
                             iterations=lm.counts["iterations"] / (SOLVER_REPS + 1),
                             accepted=runs[name]["acc"])
    for name, r in out.items():
        print(f"[phase 9] float32 {name}: {r['ms']:.2f} ms per solve_and_slide "
              f"({r['ms'] / out['default']['ms']:.3f}x the default), {r['syncs']} host "
              f"syncs per call, {r['iterations']:.1f} LM iterations run", flush=True)
    return out


def phase_ransac(lk, pair, cfg, device="cuda"):
    """(b) F-RANSAC with LU and eigh hypotheses on phase 2's bench pair (K1's
    tracks, the tracker's virtual-pinhole points), the same draws."""
    from mobile_slam_tpu_torch.frontend import tracker as trk
    from mobile_slam_tpu_torch.models.cameras.base import make_camera
    from mobile_slam_tpu_torch.ops import ransac

    tcfg = cfg.tracker
    img0, pyr0, _, pyr1, pts, valid = pair
    params = lk.LKParams(window=tcfg.lk_window_size, levels=tcfg.lk_pyramid_levels,
                         iters=tcfg.lk_iterations, eps=tcfg.lk_eps)
    new, ok = lk.track_pyramidal(pyr0, pyr1, pts, valid, params)
    active = valid & ok
    h, w = img0.shape
    cam = make_camera(cfg.camera, dtype=torch.float32, device=device)
    focal = cfg.camera.focal_length
    und0 = trk._virtual_pinhole(cam, pts, focal, w / 2.0, h / 2.0)
    und1 = trk._virtual_pinhole(cam, new, focal, w / 2.0, h / 2.0)
    n_hyp, thr = tcfg.ransac_iters, tcfg.f_threshold
    r = torch.randint(0, 1 << 30, (n_hyp, 8), generator=torch.Generator().manual_seed(RANSAC_SEED))
    r_dev = r.to(device)
    out = {}
    for name, lu in (("lu", True), ("eigh", False)):
        with _flags({(ransac, "USE_LU_HYPOTHESES"): lu}):
            def call(a=und0, b=und1, m=active, rr=r_dev):
                return ransac.find_fundamental_ransac(a, b, m, thr, num_hypotheses=n_hyp, r=rr)

            F, inl = call()
            resid = float(ransac._epipolar_dist(F, und0, und1)[inl].median())
            ms = _time_ms(call, reps=10)
            # The card at float64 against the CPU at float64, the same draws;
            # held for the LU hypotheses (the eigh ones' 9x9 eigenvectors come
            # from cuSOLVER on one side and LAPACK on the other: printed).
            F_c, inl_c = call(und0.double(), und1.double())
            F_h, inl_h = call(und0.double().cpu(), und1.double().cpu(), active.cpu(), r)
            F_c = F_c.cpu()
            a, c = F_c / F_c.norm(), F_h / F_h.norm()
            f_err = float(min((a - c).abs().max(), (a + c).abs().max()))
            n_diff = int((inl_c.cpu() != inl_h).sum())
            if lu:
                _check(n_diff == 0 and f_err < RANSAC_F_TOL,
                       f"RANSAC lu: {n_diff} inliers differ, F by {f_err} from the CPU")
        out[name] = dict(ms=ms, inliers=int(inl.sum()), residual_px=resid, f64_err=f_err,
                         f64_inliers_differing=n_diff)
        print(f"[phase 9] RANSAC {name} hypotheses on the bench pair ({int(active.sum())} "
              f"tracks, {n_hyp} hypotheses): {int(inl.sum())} inliers, median epipolar "
              f"distance of the inliers {resid:.4f} px, {ms:.3f} ms per call (float32); "
              f"float64 card against CPU: {n_diff} inliers differ, F within {f_err:.2e}",
              flush=True)
    return out


def mei_config(example):
    """The bench configuration through the Mei camera of MEI_CAM."""
    import dataclasses

    base = example.bench_config()
    return dataclasses.replace(
        base, camera=dataclasses.replace(base.camera, **MEI_CAM),
        tracker=dataclasses.replace(base.tracker, fisheye=False))


def phase_cameras(lk, sim, example, make_camera, device="cuda"):
    """(c) A Mei sequence streamed to TRACKING on the card, then a Scaramuzza
    round trip on the card against float64 on the CPU."""
    from mobile_slam_tpu_torch import config as cfgmod
    from mobile_slam_tpu_torch.engine.vio_engine import Status, VIOEngine
    from mobile_slam_tpu_torch.eval.evaluator import compute_ate
    from mobile_slam_tpu_torch.io import synthetic
    from mobile_slam_tpu_torch.models.cameras import scaramuzza

    cfg = mei_config(example)
    cam = make_camera(cfg.camera, dtype=torch.float64, device="cpu")
    r_ic, t_ic = cfg.camera.r_ic_mat, cfg.camera.t_ic_vec
    data = sim.simulate(synthetic.sim_config(MEI_SECONDS, seed=7, noise=True), cam, r_ic, t_ic)
    engine = VIOEngine(cfg, device=device)
    _check(engine.camera.model_type == "MEI", f"engine camera {engine.camera.model_type}")
    est_ts, est_p, frame_ms, init_frame, imu_i = [], [], [], None, 0
    lk.reset_launch_counts()
    for fi in range(len(data.frames)):
        img = sim.render_frame(data, fi, cam, r_ic, t_ic)
        ts = data.cam_ts[fi]
        imu_i = _feed_imu(engine, data, imu_i, ts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.process_frame(img, ts)
        torch.cuda.synchronize()
        if init_frame is not None:
            frame_ms.append(1e3 * (time.perf_counter() - t0))
        if res.ok:
            est_ts.append(ts)
            est_p.append(engine.get_body_state()[0])
        if init_frame is None and res.status == Status.TRACKING:
            init_frame = fi
    counts = dict(lk.launch_counts)
    n = len(data.frames)
    _check(init_frame is not None, "the Mei sequence never reached TRACKING")
    for k, per in LK_PER_FRAME.items():
        _check(counts[k] == per * n, f"Mei: {k} {counts[k]} launches over {n} frames")
    ate = compute_ate(np.asarray(est_ts), np.asarray(est_p), data.cam_ts, data.gt_p)
    _check(bool(np.isfinite(est_p).all()) and ate.rmse < ATE_TOL, f"Mei ATE {ate.rmse} m")
    print(f"[phase 9] Mei ({cfg.camera.width}x{cfg.camera.height}, xi {cfg.camera.xi}): "
          f"{n} frames, TRACKING at frame {init_frame}, {len(est_p)} poses, ATE sim3 rmse "
          f"{ate.rmse:.4f} m over {ate.num_pairs} pairs, median "
          f"{np.median(frame_ms):.2f} ms per tracking frame, launches {counts}", flush=True)

    scfg = cfgmod.CameraConfig(**SCARAMUZZA_CAM, ocam_inv_poly=tuple(
        scaramuzza.fit_inverse_poly(np.asarray(SCARAMUZZA_CAM["ocam_poly"]), SCARA_MAX_RHO)))
    uv = np.stack(np.meshgrid(np.linspace(80, 432, 12), np.linspace(80, 432, 12)), -1).reshape(-1, 2)
    host = make_camera(scfg, dtype=torch.float64, device="cpu")
    want_ray = host.lift(torch.as_tensor(uv, dtype=torch.float64))
    want_uv = host.project(want_ray)
    errs = {}
    for dtype in (torch.float64, torch.float32):
        card = make_camera(scfg, dtype=dtype, device=device)
        ray = card.lift(torch.as_tensor(uv, dtype=dtype, device=device))
        back = card.project(ray).double().cpu()
        errs[str(dtype)] = (float(((ray.double().cpu() - want_ray) / want_ray.norm(dim=-1, keepdim=True)).abs().max()),
                            float((back - want_uv).abs().max()))
    round_trip = float((want_uv - torch.as_tensor(uv)).abs().max())
    _check(errs["torch.float64"][0] <= 1e-12 and errs["torch.float64"][1] <= 1e-9,
           f"Scaramuzza float64 on the card against the CPU: {errs['torch.float64']}")
    _check(errs["torch.float32"][1] <= SCARA_F32_PX, f"Scaramuzza float32: {errs['torch.float32']}")
    _check(round_trip <= SCARA_ROUND_TRIP_PX, f"Scaramuzza round trip {round_trip} px")
    print(f"[phase 9] Scaramuzza ({len(uv)} pixels): lift / project on the card against "
          f"float64 on the CPU: float64 {errs['torch.float64'][0]:.2e} relative / "
          f"{errs['torch.float64'][1]:.2e} px, float32 {errs['torch.float32'][0]:.2e} / "
          f"{errs['torch.float32'][1]:.2e} px; round trip {round_trip:.4f} px (the fitted "
          f"inverse polynomial)", flush=True)
    return dict(counts=counts, ate=float(ate.rmse), init_frame=init_frame, poses=len(est_p),
                ms_per_frame=float(np.median(frame_ms)))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_tp_solver(stream, cfg, device="cuda"):
    """(d) tp_damped_step at world size 1 over NCCL against lm._solve_damped
    on the same equations, float64, from phase 3's last tracking frame."""
    import torch.distributed as dist

    from mobile_slam_tpu_torch.engine import estimator as est
    from mobile_slam_tpu_torch.factors.imu_factor import sqrt_info_from_cov
    from mobile_slam_tpu_torch.models.state import eligible_mask
    from mobile_slam_tpu_torch.parallel import tp_solver
    from mobile_slam_tpu_torch.solver import assembly, lm

    x, table, w, prior, ps = _linearization(stream, cfg, device)
    elig = eligible_mask(table)
    args = (x, table, w.pre, sqrt_info_from_cov(w.pre.cov[1:]),
            (w.pre.sum_dt[1:] < 10.0) & (w.imu_cnt[1:] > 0), prior,
            prior.J0.T @ prior.J0, ps.ex_t, ps.ex_q, est.solver_params(ps),
            assembly.proj_valid_mask(table))
    mu = torch.tensor(TP_MU, dtype=torch.float64, device=device)
    eqs = assembly.build_normal_eqs(*args)
    dx_ref, dlam_ref = lm._solve_damped(eqs, mu, elig)
    dist.init_process_group("nccl" if torch.device(device).type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        dx, dlam, cost = tp_solver.tp_damped_step(*args, elig, mu)
        ms = _time_ms(lambda: tp_solver.tp_damped_step(*args, elig, mu), reps=10)
    finally:
        dist.destroy_process_group()
    plain_ms = _time_ms(lambda: lm._solve_damped(assembly.build_normal_eqs(*args), mu, elig),
                        reps=10)
    e_dx = float((dx - dx_ref).abs().max() / dx_ref.abs().max())
    e_dl = float((dlam - dlam_ref).abs().max() / dlam_ref.abs().max())
    e_c = float(abs(cost - eqs.cost) / eqs.cost)
    _check(max(e_dx, e_dl) <= TP_RTOL and e_c <= 1e-12,
           f"tp_damped_step against _solve_damped: dx {e_dx}, dlam {e_dl}, cost {e_c}")
    print(f"[phase 9] tp_damped_step, world 1 over NCCL, {int(elig.sum())} landmarks: dx "
          f"{e_dx:.2e}, dlam {e_dl:.2e}, cost {e_c:.2e} relative to the unsharded solve; "
          f"{ms:.2f} ms per step against {plain_ms:.2f} ms for build_normal_eqs + "
          f"_solve_damped", flush=True)
    return dict(dx_rel=e_dx, dlam_rel=e_dl, ms=ms, plain_ms=plain_ms)


def _euler_rot(rx, ry, rz):
    cx, sx, cy, sy, cz, sz = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry), np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def board_views(project, params, width, height, n_views, seed=0, depth=0.55, lateral=0.12):
    """Board views of a calibration sweep, as tests/test_calibration_bootstrap.py
    renders them (strong tilts, off-center placements, the whole board in the
    image), through a port camera's float64 ``project`` on the host, with
    CALIB_NOISE_PX of pixel noise: (object points, pixels, camera-frame
    corners) per view."""
    rng = np.random.default_rng(seed)
    cols, rows = BOARD
    xs, ys = np.meshgrid(np.arange(cols), np.arange(rows))
    obj = np.stack([xs.ravel() * BOARD_SQUARE, ys.ravel() * BOARD_SQUARE,
                    np.zeros(cols * rows)], axis=-1)
    center = obj.mean(axis=0)
    tilts = [(-0.6, 0.15), (0.6, -0.15), (0.15, -0.6), (-0.15, 0.6), (0.45, 0.45),
             (-0.45, -0.45), (0.0, 0.0), (0.3, -0.5), (-0.5, 0.3), (0.5, 0.5)]
    offs = [(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1), (1, -1), (-1, 1), (0, 0)]
    objs, imgs, pcs = [], [], []
    for v in range(8 * n_views):
        if len(objs) == n_views:
            break
        rx, ry = tilts[v % len(tilts)]
        ox, oy = offs[v % len(offs)]
        R = _euler_rot(rx + 0.05 * rng.normal(), ry + 0.05 * rng.normal(), rng.uniform(-0.5, 0.5))
        t = np.array([lateral * ox + rng.uniform(-0.02, 0.02),
                      lateral * oy + rng.uniform(-0.02, 0.02), depth * rng.uniform(0.9, 1.25)])
        pc = (obj - center) @ R.T + t
        if (pc[:, 2] < 0.05).any():
            continue
        uv = project(params, torch.as_tensor(pc, dtype=torch.float64)).numpy()
        uv = uv + rng.normal(size=uv.shape) * CALIB_NOISE_PX
        if ((uv[:, 0] > 2) & (uv[:, 0] < width - 2) & (uv[:, 1] > 2) & (uv[:, 1] < height - 2)).all():
            objs.append(obj)
            imgs.append(uv)
            pcs.append(pc)
    _check(len(objs) == n_views, f"only {len(objs)} board views fit the image")
    return objs, imgs, np.concatenate(pcs)


def calibration_cameras():
    """The four models of phase 10 (a): model -> (true flat parameters
    (float64, CPU), width, height, view options, the reference test's bar
    on the result)."""
    from mobile_slam_tpu_torch import config as cfgmod
    from mobile_slam_tpu_torch.models.cameras import equidistant, mei, pinhole, scaramuzza

    kw = dict(dtype=torch.float64, device="cpu")
    eu = cfgmod.load_config(os.path.join(REPO, "configs", "euroc.yaml")).camera
    tv = cfgmod.load_config(os.path.join(REPO, "configs", "tum_vi_room1.yaml")).camera
    poly = np.array([-250.0, 0.0, 1.8e-3, -2.0e-6, 8.0e-9])   # the reference test's OCAM camera
    scara = np.concatenate([scaramuzza.fit_inverse_poly(poly, 0.5 * np.hypot(752, 480)),
                            [376.0, 240.0, 1.0, 0.0, 0.0]])

    def focal_bar(true, p, rms):       # test_calibration_bootstrap.py: pinhole / KB
        return rms < 0.5 and all(abs(p[i] - true[i]) / true[i] < 0.05 for i in (0, 1))

    def mei_bar(true, p, rms):         # f_eq = gamma / (1 + xi) within 8%
        f_true, f_eq = true[0] / (1 + true[8]), p[0] / (1 + p[8])
        return rms < 1.0 and abs(f_eq - f_true) / f_true < 0.08

    def scara_bar(true, p, rms):       # the ray fan the board sweep covers, within 2 px
        from mobile_slam_tpu_torch.models.cameras import calibration as cal

        th = np.linspace(-1.5, -0.85, 25)
        fan = torch.as_tensor(np.stack([np.cos(th), np.zeros_like(th), -np.sin(th)], -1))
        err = (cal._scaramuzza_project_flat(torch.as_tensor(p), fan)
               - cal._scaramuzza_project_flat(torch.as_tensor(true), fan)).norm(dim=-1).max()
        return rms < 0.5 and float(err) < 2.0

    return {
        "PINHOLE": (pinhole.make_params(eu.fx, eu.fy, eu.cx, eu.cy, *eu.dist, **kw), 752, 480,
                    {}, focal_bar),
        "KANNALA_BRANDT": (equidistant.make_params(tv.fx, tv.fy, tv.cx, tv.cy, *tv.dist, **kw),
                           512, 512, dict(depth=0.45), focal_bar),
        "MEI": (mei.make_params(MEI_CAM["fx"], MEI_CAM["fy"], MEI_CAM["cx"], MEI_CAM["cy"],
                                *MEI_CAM["dist"], xi=MEI_CAM["xi"], **kw), 752, 480,
                dict(depth=0.5), mei_bar),
        "SCARAMUZZA": (torch.as_tensor(scara), 752, 480, dict(depth=0.4, lateral=0.22),
                       scara_bar),
    }


def _host_ms(fn, reps, device):
    """Median host-clock ms of ``reps`` calls, each ended by a device sync."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def phase_calibration(device="cuda", n_views=CALIB_VIEWS):
    """(a) calibrate_from_board for each model on the card at float64, held
    to the reference test's bars and against the same call on the CPU; the
    bundle's Jacobian timed in forward and reverse mode; refine_extrinsics and
    calibrate_camera_odometry against their ground truth."""
    from mobile_slam_tpu_torch.models.cameras import calibration as cal
    from mobile_slam_tpu_torch.utils import gpl

    refine = cal._refine_board_joint
    timing = {}

    def timed_refine(*a, **kw):
        t0 = time.perf_counter()
        out = refine(*a, **kw)
        timing["refine_ms"] = 1e3 * (time.perf_counter() - t0)
        return out

    out = {}
    cal._refine_board_joint = timed_refine
    try:
        for mt, (true, w, h, opts, bar) in calibration_cameras().items():
            project = cal._PROJECT[mt]
            objs, imgs, pcs = board_views(project, true, w, h, n_views, **opts)
            args = (mt, BOARD, objs, imgs, w, h)
            _, rms0 = cal.calibrate_from_board(*args, refine=False, device=device)
            cal.calibrate_from_board(*args, refine_iters=1, device=device)   # warm-up
            t0 = time.perf_counter()
            p, rms = cal.calibrate_from_board(*args, refine_iters=CALIB_ITERS, device=device)
            call_ms = 1e3 * (time.perf_counter() - t0)
            iter_ms = timing["refine_ms"] / CALIB_ITERS
            t0 = time.perf_counter()
            p_cpu, rms_cpu = cal.calibrate_from_board(*args, refine_iters=CALIB_ITERS, device="cpu")
            cpu_ms = 1e3 * (time.perf_counter() - t0)
            pts = torch.as_tensor(pcs)
            px = float((project(torch.as_tensor(p), pts)
                        - project(torch.as_tensor(p_cpu), pts)).abs().max())
            d_rms = abs(rms - rms_cpu) / rms_cpu
            _check(bool(bar(true.numpy(), p, rms)), f"{mt}: calibration misses the reference "
                   f"test's bar: rms {rms} px, params {p} against {true.numpy()}")
            _check(px <= CALIB_CPU_PX and d_rms <= CALIB_RMS_RTOL,
                   f"{mt}: card against CPU: corners {px} px, rms {d_rms} relative")
            out[mt] = dict(call_ms=call_ms, iter_ms=iter_ms, cpu_ms=cpu_ms, rms_before=rms0,
                           rms=rms, cpu_px=px, cpu_rms_rel=d_rms, params=p.tolist())
            print(f"[phase 10] calibrate_from_board {mt} {w}x{h}, {n_views} views "
                  f"({len(pcs)} corners, {CALIB_NOISE_PX} px noise): rms {rms0:.4f} px "
                  f"(bootstrap) -> {rms:.4f} px after {CALIB_ITERS} joint iterations; "
                  f"{call_ms:.1f} ms per call on {device}, {iter_ms:.2f} ms per Gauss-Newton "
                  f"iteration; params {np.array2string(p[:4], precision=3)} against "
                  f"{np.array2string(true.numpy()[:4], precision=3)}; the CPU's call "
                  f"{cpu_ms:.1f} ms, corners within {px:.2e} px, rms {d_rms:.1e} relative",
                  flush=True)
            if mt == "KANNALA_BRANDT":
                # The bundle's Jacobian at the solution, both AD modes, on the card.
                kw = dict(dtype=torch.float64, device=device)
                poses = [cal._board_pnp(torch.as_tensor(p, **kw), mt, o, i)
                         for o, i in zip(objs, imgs)]
                q = torch.as_tensor(np.stack([gpl._rotation_to_quat(R) for R, _ in poses]), **kw)
                t = torch.as_tensor(np.stack([t_ for _, t_ in poses]), **kw)
                _, residual = cal._board_residual(project, torch.as_tensor(np.stack(objs), **kw),
                                                  torch.as_tensor(np.stack(imgs), **kw), len(p))
                x = (torch.zeros(len(p) + 6 * n_views, **kw), torch.as_tensor(p, **kw), q, t)
                jf = torch.func.jacfwd(residual)(*x)
                jr = torch.func.jacrev(residual)(*x)
                jac = dict(fwd_ms=_host_ms(lambda: torch.func.jacfwd(residual)(*x), 5, device),
                           rev_ms=_host_ms(lambda: torch.func.jacrev(residual)(*x), 5, device),
                           residual_ms=_host_ms(lambda: residual(*x), 5, device),
                           shape=tuple(jf.shape),
                           agree=float((jf - jr).abs().max() / jf.abs().max()))
                _check(jac["agree"] < 1e-12, f"jacfwd and jacrev disagree: {jac['agree']}")
                out["jacobian"] = jac
                print(f"[phase 10] bundle Jacobian {jac['shape']} on {device}: jacfwd "
                      f"{jac['fwd_ms']:.2f} ms, jacrev {jac['rev_ms']:.2f} ms, the residual "
                      f"alone {jac['residual_ms']:.2f} ms (host clock, median of 5); the two "
                      f"agree to {jac['agree']:.1e}", flush=True)
    finally:
        cal._refine_board_joint = refine
    out.update(phase_pose_calibration(device))
    return out


def phase_pose_calibration(device):
    """refine_extrinsics (the reference test's pinhole scene) and
    calibrate_camera_odometry over ODO_VIEWS views on the card, against the
    ground truth at the reference tests' bars."""
    from mobile_slam_tpu_torch.models.cameras import calibration as cal, pinhole
    from mobile_slam_tpu_torch.utils import rotations as rot

    kw = dict(dtype=torch.float64, device="cpu")
    params = pinhole.make_params(460.0, 458.0, 376.0, 240.0, -0.28, 0.07, 1e-4, -2e-4, **kw)

    def R(q):
        return rot.quat_to_rot(torch.as_tensor(q, dtype=torch.float64)).numpy()

    rng = np.random.default_rng(5)
    wp = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-2, 2, 200), rng.uniform(0, 1, 200)], -1)
    q_true = np.array([np.cos(0.15), 0.1, np.sin(0.15), 0.05])
    q_true /= np.linalg.norm(q_true)
    t_true = np.array([0.3, -0.2, 4.0])
    uv = pinhole.project(params, torch.as_tensor(wp @ R(q_true).T + t_true)).numpy()
    t0 = time.perf_counter()
    q, t, rms0, rms1 = cal.refine_extrinsics("PINHOLE", params, [1.0, 0, 0, 0], [0, 0, 3.5], wp,
                                             uv, iters=40, device=device)
    ext_ms = 1e3 * (time.perf_counter() - t0)
    _check(rms1 < 1e-5 and np.abs(t - t_true).max() < 1e-4 and abs(abs(q @ q_true) - 1) < 1e-8,
           f"refine_extrinsics: rms {rms1}, t {t} against {t_true}")

    rng = np.random.default_rng(11)
    V, N = ODO_VIEWS, 120
    q_oc = np.array([np.cos(0.2), 0.1, np.sin(0.2), -0.05])
    q_oc /= np.linalg.norm(q_oc)
    t_oc = np.array([0.12, -0.06, 0.30])
    odo_q = np.stack([[np.cos(0.075 * i), 0.0, 0.0, np.sin(0.075 * i)] for i in range(V)])
    odo_t = np.stack([[0.4 * i, 0.1 * i, 0.0] for i in range(V)])
    wps, uvs = [], []
    for i in range(V):
        pc = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1.0, 1.0, N),
                       rng.uniform(2.0, 6.0, N)], -1)
        wps.append((pc @ R(q_oc).T + t_oc) @ R(odo_q[i]).T + odo_t[i])
        uvs.append(pinhole.project(params, torch.as_tensor(pc)).numpy())
    box = lambda q_, d: rot.quat_boxplus(torch.as_tensor(q_), torch.as_tensor(d)).numpy()
    oq0, ot0 = odo_q.copy(), odo_t.copy()
    for i in range(1, V):
        oq0[i] = box(odo_q[i], rng.uniform(-0.03, 0.03, 3))
        ot0[i] = odo_t[i] + rng.uniform(-0.05, 0.05, 3)
    t0 = time.perf_counter()
    q_r, t_r, _, ot_r, o_rms0, o_rms1 = cal.calibrate_camera_odometry(
        "PINHOLE", params, box(q_oc, [0.05, -0.04, 0.06]), t_oc + [0.05, 0.08, -0.06], oq0, ot0,
        np.stack(wps), np.stack(uvs), iters=40, device=device)
    odo_ms = 1e3 * (time.perf_counter() - t0)
    _check(o_rms0 > 1.0 and o_rms1 < 1e-4 and np.abs(t_r - t_oc).max() < 1e-3
           and abs(abs(q_r @ q_oc) - 1) < 1e-6 and np.abs(ot_r[2] - odo_t[2]).max() < 1e-3,
           f"calibrate_camera_odometry: rms {o_rms0} -> {o_rms1}, t_oc {t_r} against {t_oc}")
    print(f"[phase 10] refine_extrinsics (200 points, 40 iterations) on {device}: rms "
          f"{rms0:.2f} -> {rms1:.2e} px, t within {np.abs(t - t_true).max():.1e} m, "
          f"{ext_ms:.1f} ms; calibrate_camera_odometry ({V} views x {N} points, 40 "
          f"iterations): rms {o_rms0:.2f} -> {o_rms1:.2e} px, t_oc within "
          f"{np.abs(t_r - t_oc).max():.1e} m, {odo_ms:.1f} ms", flush=True)
    return dict(extrinsics_ms=ext_ms, odometry_ms=odo_ms, odometry_rms=o_rms1)


def phase_adversarial(lk, cfg, arms=ADV_ARMS, device="cuda"):
    """(b) The adversarial curve through the port's ChunkedImageServer, as
    bench.py's _image_path_recovering runs it: per arm, the oracle-rendered
    sequence (seed ADV_SEED) streamed frame by frame with its IMU, chunks of
    ADV_CHUNK, rebuild-and-replay of a failed chunk tail."""
    from mobile_slam_tpu_torch.engine.serving import ChunkedImageServer
    from mobile_slam_tpu_torch.eval import adversarial as adv
    from mobile_slam_tpu_torch.eval import simulation as sim
    from mobile_slam_tpu_torch.eval.evaluator import compute_ate
    from mobile_slam_tpu_torch.utils import logging as slog

    r_ic, t_ic = cfg.camera.r_ic_mat, np.asarray(cfg.camera.t_ic_vec)
    out = {"arms": []}
    lk.reset_launch_counts()
    loop = {"frames": 0, **{k: 0 for k in LK_PER_FRAME}}
    streamed = 0
    for level, seconds in arms:
        nuis = adv.LEVELS[level]
        scfg = sim.SimConfig(duration=seconds, cam_rate=20.0, imu_rate=200.0, num_landmarks=900,
                             max_features=150, acc_noise=0.02, gyr_noise=0.002, pixel_noise=0.0,
                             acc_bias=(0.01, -0.005, 0.015), gyr_bias=(0.001, -0.0005, 0.0008),
                             seed=ADV_SEED)      # bench.py:511-517
        data = adv.make_adversarial_data(scfg, cfg.camera, r_ic, t_ic, nuis)
        movers = adv.make_movers(nuis)
        t0 = time.perf_counter()
        frames = [adv.render_frame_adversarial(data, fi, cfg.camera, r_ic, t_ic, nuis, movers)
                  for fi in range(len(data.cam_ts))]
        render_s = time.perf_counter() - t0
        server = ChunkedImageServer(cfg, device=device, dtype=torch.float32, chunk_size=ADV_CHUNK)
        step = server._step

        def counted_step(carry, inputs, ransac_draws=None, step=step):
            before = dict(lk.launch_counts)
            res = step(carry, inputs, ransac_draws)
            loop["frames"] += inputs.img.shape[0]
            for k in LK_PER_FRAME:
                loop[k] += lk.launch_counts[k] - before[k]
            return res

        server._step = counted_step
        est_ts, est_p, imu_i = [], [], 0
        t0 = time.perf_counter()
        with slog.tracing():
            for fi, img in enumerate(frames):
                imu_i = _feed_imu(server, data, imu_i, data.cam_ts[fi])
                for r in server.process_frame(img, data.cam_ts[fi]):
                    if r.ok:
                        est_ts.append(r.ts)
                        est_p.append(r.p)
            for r in server.flush():
                if r.ok:
                    est_ts.append(r.ts)
                    est_p.append(r.p)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        replay_ms = _span_ms(slog.drain(), "recover")
        streamed += server.frames_streamed
        est_p = np.asarray(est_p, np.float64)
        _check(len(est_p) > 10 and bool(np.isfinite(est_p).all()),
               f"level {level}: {len(est_p)} poses, finite {np.isfinite(est_p).all()}")
        ate = compute_ate(np.asarray(est_ts), est_p, data.cam_ts, data.gt_p, with_scale=True)
        if level == 0:
            _check(ate.rmse < ATE_TOL, f"level 0 (clean oracle) ATE {ate.rmse} m")
        arm = dict(level=level, seconds=seconds, frames=len(frames), poses=len(est_p),
                   ate=float(ate.rmse), fps=len(frames) / wall, render_s=render_s,
                   recoveries=server.n_recoveries, replay_ms=replay_ms,
                   chunks=server.n_chunks, streamed=server.frames_streamed)
        out["arms"].append(arm)
        print(f"[phase 10] adversarial level {level}, {seconds} s, seed {ADV_SEED}: "
              f"{arm['poses']} poses of {arm['frames']} frames, ATE sim3 {arm['ate']:.4f} m over "
              f"{ate.num_pairs} pairs, {arm['fps']:.3f} fps, rendered in {render_s:.1f} s, "
              f"{server.n_chunks} chunks of {ADV_CHUNK}, {server.frames_streamed} frames "
              f"streamed, {server.n_recoveries} recoveries, replay ms "
              f"{[round(x, 1) for x in replay_ms]} (JAX: {ADV_JAX})", flush=True)
    counts = dict(lk.launch_counts)
    for k, n in LK_PER_FRAME.items():
        _check(counts[k] == n * (loop["frames"] + streamed),
               f"adversarial {k}: {counts[k]} launches over {loop['frames']} chunk-loop + "
               f"{streamed} streamed frames")
    out.update(counts=counts, loop_frames=loop["frames"], streamed=streamed)
    print(f"[phase 10] adversarial launches {counts} over {loop['frames']} chunk-loop frames "
          f"(padding included) + {streamed} streamed (replays included)", flush=True)
    return out


def phase_tail_replay(lk, cfg, sim, example, make_camera, device="cuda"):
    """(c) A failed chunk tail replayed on the card: the bench sequence
    through ChunkedImageServer (chunks of TAIL_CHUNK), the last TAIL_BLANK
    frames of its first chunk blank with a TAIL_KNOCK accelerometer spike
    (the tracker keeps nothing and the IMU alone drives the state past the
    gate's 10 m/s), then the stretch on to the end: the server recovers,
    replays the failed frames and initializes again."""
    from mobile_slam_tpu_torch.engine.serving import ChunkedImageServer
    from mobile_slam_tpu_torch.utils import logging as slog

    cam = make_camera(cfg.camera, dtype=torch.float64, device="cpu")
    data = sim.simulate(example.bench_sim_config(TAIL_SECONDS), cam,
                        cfg.camera.r_ic_mat, cfg.camera.t_ic_vec)
    server = ChunkedImageServer(cfg, device=device, chunk_size=TAIL_CHUNK)
    eng = server.engine
    real_process, real_input = eng.process_frame, server._frame_input
    calls, inputs = [], {}

    def process_frame(image, ts, imu_override=None):
        calls.append((ts, imu_override))
        return real_process(image, ts, imu_override=imu_override)

    def frame_input(image, ts):
        inputs[ts] = real_input(image, ts)
        return inputs[ts]

    eng.process_frame, server._frame_input = process_frame, frame_input
    after, imu_i, blank, chunks_after = [], 0, None, 0
    t0 = time.perf_counter()
    with slog.tracing():
        for fi in range(len(data.frames)):
            img = sim.render_frame(data, fi, cam, example.R_IC, cfg.camera.t_ic_vec)
            knock = blank is not None and fi in blank
            if knock:
                img = np.zeros_like(img)
            while imu_i < len(data.imu_ts) and data.imu_ts[imu_i] <= data.cam_ts[fi] + 1e-9:
                server.push_imu(data.imu_ts[imu_i],
                                data.imu_acc[imu_i] + (TAIL_KNOCK if knock else 0.0) * np.eye(3)[0],
                                data.imu_gyr[imu_i])
                imu_i += 1
            recovered, n_chunks = server.n_recoveries > 0, server.n_chunks
            out = server.process_frame(img, data.cam_ts[fi])
            if recovered:
                after += [r.p for r in out if r.ok]
                chunks_after += server.n_chunks - n_chunks
            if blank is None and server.mode == "chunked":
                first = fi + 1      # the first chunk's frames: first .. first + TAIL_CHUNK - 1
                blank = range(first + TAIL_CHUNK - TAIL_BLANK, first + TAIL_CHUNK)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    replay_ms = _span_ms(slog.drain(), "recover")
    _check(blank is not None, "tail replay: the server never entered chunked mode")
    _check(server.n_recoveries >= 1, f"tail replay: {server.n_recoveries} recoveries after "
           f"{TAIL_BLANK} blank frames closing a chunk of {TAIL_CHUNK}")
    replayed = [(ts, ov) for ts, ov in calls if ov is not None]
    last = blank.stop - 1       # the first chunk's last frame
    want_ts = [data.cam_ts[fi] for fi in range(last - len(replayed) + 1, last + 1)]
    _check(len(replayed) >= server.recover_tail and [ts for ts, _ in replayed] == want_ts,
           f"tail replay: replayed frames at {[ts for ts, _ in replayed]}, the chunk's last "
           f"frame at {data.cam_ts[last]}")
    for ts, (dt, acc, gyr) in replayed:
        inp = inputs[ts]
        cnt = int(inp.imu_cnt)
        _check(np.array_equal(dt, inp.imu_dt[:cnt].numpy())
               and np.array_equal(acc, inp.imu_acc[:cnt].numpy())
               and np.array_equal(gyr, inp.imu_gyr[:cnt].numpy()),
               f"tail replay: frame at {ts} replayed with another IMU slice")
    after = np.asarray(after)
    _check(len(after) > 0 and bool(np.isfinite(after).all()),
           f"tail replay: {len(after)} poses after the recovery, finite "
           f"{bool(np.isfinite(after).all()) if len(after) else None}")
    _check(chunks_after >= 1, "tail replay: the server did not return to chunked mode")
    out = dict(recoveries=server.n_recoveries, replay_ms=replay_ms,
               replayed=len(replayed), poses_after=len(after), chunks_after=chunks_after,
               frames=len(data.frames), wall_s=wall)
    print(f"[phase 10] tail replay: {TAIL_BLANK} blank frames with a {TAIL_KNOCK} m/s^2 knock "
          f"closing chunk 1 of {TAIL_CHUNK} (frames {blank.start}-{last}); {server.n_recoveries} "
          f"recoveries, {len(replayed)} frames replayed through process_frame(imu_override=) "
          f"with their own IMU slices, replay ms {[round(x, 1) for x in replay_ms]}; "
          f"{len(after)} finite poses after the recovery, {chunks_after} chunks after it, "
          f"{server.n_chunks} chunks in all over {len(data.frames)} frames in {wall:.1f} s",
          flush=True)
    return out


def _on_device(tree, device):
    return _tree_map(lambda t: t.to(device), tree)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _rank_fleets(rank, world, path, device="cuda"):
    """Phase 11 on one rank: phase 7's image fleet and feature fleet over the
    ranks' mesh (parallel/batch.py's RankMesh), from phase 7's handoff."""
    from mobile_slam_tpu_torch.engine import chunked, example
    from mobile_slam_tpu_torch.engine.vio_engine import set_full_precision
    from mobile_slam_tpu_torch.models.cameras.base import make_camera
    from mobile_slam_tpu_torch.ops import lk
    from mobile_slam_tpu_torch.parallel import batch
    from mobile_slam_tpu_torch.probes.sync_sites import SyncSites

    set_full_precision()
    on_card = torch.device(device).type == "cuda"
    mesh = batch.make_mesh(None if on_card else [device] * world)
    dev = mesh.device
    d = torch.load(path, weights_only=False)
    cfg = example.bench_config()
    n_it, focal = cfg.estimator.num_iterations, cfg.camera.focal_length
    chunk, n_chunks = d["chunk"], d["chunks"]
    out = dict(device=str(dev), device_index=dev.index,
               card=torch.cuda.get_device_name(dev) if on_card else "cpu",
               backend=torch.distributed.get_backend())
    syncs = SyncSites if on_card else contextlib.nullcontext

    # (a) the image fleet.
    img = d["image"]
    params = _on_device(img["params"], dev)
    check = img["draws"][0].shape[0]

    def carries():
        cs = []
        for c in img["carries"]:
            g = torch.Generator(device=dev)
            g.set_state(c.gen)
            cs.append(_on_device(c._replace(gen=g), dev))
        return cs

    def fleet_inputs(lo, hi, dtype=None):
        rows = [chunked.stack_image_inputs([x if dtype is None else _to64(x) for x in seq[lo:hi]],
                                           dev) for seq in img["inputs"]]
        return chunked.ImageFrameInput(*[torch.stack(x, dim=1) for x in zip(*rows)])

    args64 = (_to64(params), n_it, cfg.tracker,
              make_camera(cfg.camera, dtype=torch.float64, device=dev), focal)
    _, o64 = batch.make_batched_image_step(*args64, mesh=mesh)(
        batch.shard_batched(batch.batch_states([_to64(c) for c in carries()]), mesh),
        fleet_inputs(0, check, torch.float64),
        ransac_draws=torch.stack([x.to(dev) for x in img["draws"]], dim=1))
    ref = img["out64"]
    out["image_diff_f64"] = [float((o64[0][:, s].cpu() - ref[0][:, s]).norm(dim=-1).max())
                             for s in range(len(img["carries"]))]
    out["image_same_kf_f64"] = bool(torch.equal(o64[3].cpu(), ref[3]))

    step = batch.make_batched_image_step(params, n_it, cfg.tracker,
                                         make_camera(cfg.camera, dtype=torch.float32, device=dev),
                                         focal, mesh=mesh)
    # A throwaway float32 pass (fresh generators) loads the float32 kernels,
    # so the timed chunk is no colder than phase 7's, whose process has run
    # float32 steps of this model before its fleet.
    step(batch.shard_batched(batch.batch_states(carries()), mesh), fleet_inputs(0, check))
    carry = batch.shard_batched(batch.batch_states(carries()), mesh)
    outs, walls = [], []
    lk.reset_launch_counts()
    for c in range(n_chunks):
        inputs = fleet_inputs(c * chunk, (c + 1) * chunk)
        _sync(dev)
        torch.distributed.barrier()
        t0 = time.perf_counter()
        with syncs() as sc:         # the step alone, as phase 7 counts it
            carry, o = step(carry, inputs)
        o = tuple(x.cpu().numpy() for x in o)
        walls.append(time.perf_counter() - t0)
        n_syncs = sum(sc.sites.values()) if on_card else 0
        outs.append(o)
    out["image_counts"] = dict(lk.launch_counts)
    out["configured"] = sorted(lk._configured)      # cards K1's attribute was set on
    out["image_walls"], out["image_syncs"] = walls, n_syncs
    out["image_p"] = np.concatenate([o[0] for o in outs])
    out["image_ok"] = np.concatenate([o[2] for o in outs])
    out["image_kf"] = np.concatenate([o[3] for o in outs])
    out["image_local_b"] = int(carry.est_state.window.p.shape[0])

    # (b) the feature fleet.
    fea = d["feature"]
    fparams, fstate = _on_device(fea["params"], dev), _on_device(fea["state"], dev)

    def feature_inputs(lo, hi, dtype=None):
        rows = [chunked.stack_frame_inputs([_on_device(x if dtype is None else _to64(x), dev)
                                            for x in seq[lo:hi]]) for seq in fea["inputs"]]
        return type(rows[0])(*[torch.stack(x, dim=1) for x in zip(*rows)])

    n_seq = len(fea["inputs"])
    _, f64 = batch.make_batched_chunked_step(_to64(fparams), n_it, mesh=mesh)(
        batch.shard_batched(batch.batch_states([_to64(fstate)] * n_seq), mesh),
        feature_inputs(0, check, torch.float64))
    ref = fea["out64"]
    out["feature_diff_f64"] = max(float((f64[0][:, s].cpu() - ref[0][:, s]).norm(dim=-1).max())
                                  for s in range(n_seq))
    out["feature_same_kf_f64"] = bool(torch.equal(f64[3].cpu(), ref[3]))
    fstep = batch.make_batched_chunked_step(fparams, n_it, mesh=mesh)
    state = batch.shard_batched(batch.batch_states([fstate] * n_seq), mesh)
    fstep(state, feature_inputs(0, check))      # float32 warm-up, as for the image fleet
    outs, walls = [], []
    for c in range(n_chunks):
        inputs = feature_inputs(c * chunk, (c + 1) * chunk)
        _sync(dev)
        torch.distributed.barrier()
        t0 = time.perf_counter()
        with syncs() as sc:
            state, o = fstep(state, inputs)
        o = tuple(x.cpu().numpy() for x in o)
        walls.append(time.perf_counter() - t0)
        out["feature_syncs"] = sum(sc.sites.values()) if on_card else 0
        outs.append(o)
    out["feature_walls"] = walls
    out["feature_p"] = np.concatenate([o[0] for o in outs])
    out["feature_kf"] = np.concatenate([o[3] for o in outs])
    out["jax_imported"] = "jax" in sys.modules
    out["reference_imported"] = any(m == "mobile_slam_tpu" or m.startswith("mobile_slam_tpu.")
                                    for m in sys.modules)
    return out


def phase_rank_fleet(lk, fleet, ffleet, device="cuda"):
    """11. Phase 7's fleets over W = max(2, cards) ranks (one process each,
    parallel/launch.py), then dryrun_multichip(W)."""
    from mobile_slam_tpu_torch.eval.evaluator import compute_ate
    from mobile_slam_tpu_torch.parallel import dryrun, launch

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    # At least two ranks, at most one per card, and a count that splits both fleets.
    cards_here = torch.cuda.device_count() if on_card else 0
    world = max(w for w in range(2, max(2, cards_here) + 1)
                if FLEET_B % w == 0 and FEATURE_FLEET_B % w == 0)
    path = os.path.join(REPO, "_chip_scratch", "phase11", "fleets.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img, fea = fleet["handoff"], ffleet["handoff"]
    torch.save(dict(image=img, feature=fea, chunk=CHUNK, chunks=FLEET_CHUNKS), path)
    ranks = launch.run_ranks(_rank_fleets, world, path, device, device=device)
    cards = sorted({r["device_index"] for r in ranks})
    n_fleet = FLEET_CHUNKS * CHUNK
    for r, got in enumerate(ranks):
        _check(not got["jax_imported"] and not got["reference_imported"],
               f"rank {r} imported jax or the JAX package")
        _check(max(got["image_diff_f64"]) < FLEET_RANK_TOL and got["image_same_kf_f64"],
               f"rank {r}: image fleet (float64) first {FLEET_CHECK_FRAMES} frames "
               f"{got['image_diff_f64']} m from phase 7's world-1 fleet, same keyframe flags "
               f"{got['image_same_kf_f64']}")
        _check(got["feature_diff_f64"] < FLEET_RANK_TOL and got["feature_same_kf_f64"],
               f"rank {r}: feature fleet (float64) {got['feature_diff_f64']} m from phase 7's, "
               f"same keyframe flags {got['feature_same_kf_f64']}")
        _check(got["configured"] == ([got["device_index"]] if on_card else []),
               f"rank {r} on card {got['device_index']} set K1's shared-memory attribute "
               f"on cards {got['configured']}")
        _check(got["image_local_b"] == FLEET_B // world, f"rank {r} holds "
               f"{got['image_local_b']} sequences of the image fleet's carry")
        for k, per in LK_PER_FRAME.items():
            _check(got["image_counts"][k] == (per * n_fleet if on_card else 0),
                   f"rank {r}: {k} launched {got['image_counts'][k]} times over {n_fleet} "
                   "fleet frames")
        _check(np.array_equal(got["image_p"], ranks[0]["image_p"])
               and np.array_equal(got["feature_p"], ranks[0]["feature_p"]),
               f"rank {r} gathered other poses than rank 0")
    got = ranks[0]
    p, ok = got["image_p"], got["image_ok"]
    _check(bool(np.isfinite(p).all()) and bool(np.isfinite(got["feature_p"]).all()),
           "rank fleet: non-finite poses")
    ates = []
    for s in range(FLEET_B):
        est_ts = img["stream_ts"][s] + [t for t, o in zip(img["ts"][s], ok[:, s]) if o]
        est_p = img["stream_p"][s] + [x for x, o in zip(p[:, s], ok[:, s]) if o]
        ate = compute_ate(np.asarray(est_ts), np.asarray(est_p), img["cam_ts"], img["gt_p"])
        ates.append(float(ate.rmse))
        _check(ate.rmse < ATE_TOL, f"rank fleet sequence {s}: ATE {ate.rmse} m")
    d32 = float(np.linalg.norm(p - img["p32"], axis=-1).max())
    d32_first = float(np.linalg.norm(p[:FLEET_CHECK_FRAMES] - img["p32"][:FLEET_CHECK_FRAMES],
                                     axis=-1).max())
    fd32 = float(np.linalg.norm(got["feature_p"] - fea["p32"], axis=-1).max())
    wall = max(r["image_walls"][0] for r in ranks)
    fwall = max(r["feature_walls"][0] for r in ranks)
    out = dict(world=world, cards=len(cards), backend=got["backend"],
               fps=FLEET_B * CHUNK / wall, fps_per_seq=CHUNK / wall,
               ms_per_fleet_frame=1e3 * wall / CHUNK,
               syncs_per_fleet_frame=[r["image_syncs"] / CHUNK for r in ranks],
               feature_fps=FEATURE_FLEET_B * CHUNK / fwall,
               feature_syncs_per_frame=[r["feature_syncs"] / CHUNK for r in ranks],
               ates=ates, image_diff_f64=max(max(r["image_diff_f64"]) for r in ranks),
               feature_diff_f64=max(r["feature_diff_f64"] for r in ranks),
               image_diff_f32=d32, image_diff_f32_first=d32_first, feature_diff_f32=fd32,
               counts=[r["image_counts"] for r in ranks])
    out["fps_ratio"] = out["fps"] / fleet["fps"]
    out["feature_fps_ratio"] = out["feature_fps"] / ffleet["fps"]
    print(f"[phase 11] fleets over {world} ranks (the most, at least two and at most one per "
          f"card of {cards_here}, that split B = {FLEET_B} and {FEATURE_FLEET_B}) on "
          f"{len(cards)} distinct card(s) {cards} "
          f"({got['card']}), gather over {got['backend']}: image fleet B={FLEET_B} "
          f"({FLEET_B // world} per rank), {FLEET_CHUNKS} chunk(s) of {CHUNK}: fleet fps "
          f"{out['fps']:.3f} ({out['fps_per_seq']:.3f} per sequence), "
          f"{out['ms_per_fleet_frame']:.2f} ms per fleet frame, host syncs per fleet frame "
          f"per rank {[round(x, 2) for x in out['syncs_per_fleet_frame']]} (the gather's: "
          f"{got['image_syncs'] - round(fleet['syncs_per_fleet_frame'] * CHUNK)} per chunk of "
          f"{CHUNK}); phase 7 (world 1, "
          f"this call) fleet fps {fleet['fps']:.3f} ({fleet['fps_per_seq']:.3f} per sequence, "
          f"{fleet['ms_per_fleet_frame']:.2f} ms per fleet frame, "
          f"{fleet['syncs_per_fleet_frame']:.2f} host syncs per fleet frame): ratio "
          f"{out['fps_ratio']:.3f}; ATE per sequence {[round(a, 4) for a in ates]} m "
          f"(< {ATE_TOL}); first {FLEET_CHECK_FRAMES} frames against phase 7's world-1 fleet: "
          f"float64 {out['image_diff_f64']:.3g} m (same keyframe flags), float32 "
          f"{d32_first:.3g} m (all {n_fleet} frames {d32:.3g} m); launches per rank "
          f"{out['counts']} over {n_fleet} fleet frames (1 / 2 / 2 per fleet frame on each "
          f"rank)", flush=True)
    print(f"[phase 11] feature fleet B={FEATURE_FLEET_B} over {world} ranks: fleet fps "
          f"{out['feature_fps']:.3f} against phase 7's {ffleet['fps']:.3f} (ratio "
          f"{out['feature_fps_ratio']:.3f}); host syncs per fleet frame per rank "
          f"{[round(x, 2) for x in out['feature_syncs_per_frame']]}; first "
          f"{FLEET_CHECK_FRAMES} frames float64 {out['feature_diff_f64']:.3g} m from phase "
          f"7's (same keyframe flags); float32 over {n_fleet} frames {fd32:.3g} m", flush=True)
    if on_card and len(cards) < 2:
        print(f"[phase 11] dryrun_multichip({world}): check 2 (the landmark-sharded solve "
              f"over NCCL) needs a card per rank and this machine has {len(cards)}; phase 9 "
              "holds it at world 1", flush=True)
    out["dryrun"] = dryrun.dryrun_multichip(world, device=device)
    _check(not out["dryrun"]["jax_imported"] and not out["dryrun"]["reference_imported"],
           "a rank of dryrun_multichip imported jax or the JAX package")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[phase 11] took {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 12: the flagship step unit, the user tools, a colour PNG sequence
# ---------------------------------------------------------------------------

def _color_png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB (colour type 2) or RGBA (6) PNG of ``rgb`` ((H, W, 3 or
    4) uint8), every row unfiltered."""
    import struct
    import zlib

    from mobile_slam_tpu_torch.io import png

    h, w, ch = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * ch)], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (png.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[ch], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def _entry_steps(device, dtype=torch.float64, n=ENTRY_CHECK_STEPS):
    """``n`` steps of ``entry(device, dtype)``'s unit, each input ``ENTRY_DT``
    after the last: [(p, q, window ts, keyframe flag)] on the host. A
    keyframe step slides the window (its first timestamp changes); a
    general step replaces the newest frame."""
    from mobile_slam_tpu_torch import entry

    step, (st, inp) = entry.entry(device=device, dtype=dtype)
    out = []
    for _ in range(n):
        first = float(st.window.ts[0])
        st, p, q = step(st, inp)
        ts = st.window.ts.cpu().numpy()
        out.append((p.cpu().numpy(), q.cpu().numpy(), ts, bool(ts[0] != first)))
        inp = inp._replace(ts=inp.ts + ENTRY_DT)
    return out


def start_entry_reference():
    """Phase 12's CPU reference (``_entry_steps("cpu")``), computed in a
    process of its own from the start of the run, beside the card's phases:
    (future, executor); the executor is shut down once the result is read."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    return pool.submit(_entry_steps, "cpu"), pool


def phase_entry_tools(cli_run, cpu_steps, device="cuda"):
    """Phase 12 (module docstring); ``cpu_steps`` the CPU reference's
    ``_entry_steps``."""
    import io as _io

    from mobile_slam_tpu_torch import entry
    from mobile_slam_tpu_torch.io import dataset, native_loader, png
    from mobile_slam_tpu_torch.probes.sync_sites import SyncSites
    from mobile_slam_tpu_torch.tools import compare_trajectories, export_replay_dataset

    t_phase = time.perf_counter()
    # (a) The step unit: card against CPU at float64, then float32 timed.
    cpu, card = cpu_steps, _entry_steps(device)
    d_entry = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(card, cpu))
    d_q = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(card, cpu))
    flags = [c[3] for c in cpu]
    _check([c[3] for c in card] == flags and all(np.array_equal(a[2], b[2])
                                                 for a, b in zip(card, cpu)),
           f"entry: keyframe flags {[c[3] for c in card]} on the card, {flags} on the CPU")
    _check(d_entry < ENTRY_TOL, f"entry: card against CPU {d_entry} m over "
           f"{ENTRY_CHECK_STEPS} float64 steps (bar {ENTRY_TOL})")
    step, (st, inp) = entry.entry(device=device)
    _check(st.window.p.device.type == torch.device(device).type
           and st.window.p.dtype == torch.float32,
           f"entry() built on {st.window.p.device} in {st.window.p.dtype}")
    st, p, q = step(st, inp)            # first call: loads the float32 kernels
    ms, syncs = [], []
    for i in range(ENTRY_TIMED_STEPS + ENTRY_SYNC_STEPS):
        inp = inp._replace(ts=inp.ts + ENTRY_DT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i < ENTRY_TIMED_STEPS:
            st, p, q = step(st, inp)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        else:
            with SyncSites() as sc:
                st, p, q = step(st, inp)
                torch.cuda.synchronize()
            syncs.append(sum(sc.sites.values()))
    _check(bool(torch.isfinite(p).all() and torch.isfinite(q).all()),
           f"entry: float32 step gave p {p}, q {q}")
    print(f"[phase 12] entry(): {ENTRY_CHECK_STEPS} float64 steps, card against CPU "
          f"{d_entry:.3e} m (bar {ENTRY_TOL}), q {d_q:.3e}, keyframe flags {flags}; "
          f"float32 step median {np.median(ms):.2f} ms (p90 {np.percentile(ms, 90):.2f}) over "
          f"{ENTRY_TIMED_STEPS} steps, host syncs per step {syncs}, p {p.cpu().numpy()}",
          flush=True)

    # (b) compare_trajectories on phase 6's pipelined run.
    gt = os.path.join(cli_run["seq"], "mav0", "mocap0", "data.csv")
    t0 = time.perf_counter()
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = compare_trajectories.main([cli_run["run_dir"], "--gt", gt, "--no-display"])
    lines = buf.getvalue().splitlines()
    _check(rc == 0 and len(lines) == 3 and lines[0].startswith("ATE: rmse"),
           f"compare_trajectories returned {rc}: {lines}")
    tool_ate = float(lines[0].split()[2])
    _check(np.isfinite(tool_ate) and tool_ate < ATE_TOL, f"compare_trajectories ATE {tool_ate} m")
    print(f"[phase 12] compare_trajectories on phase 6's pipelined run in "
          f"{time.perf_counter() - t0:.2f} s: ATE {tool_ate:.4f} m (phase 6's evaluation "
          f"{cli_run['ate']:.4f} m); " + " | ".join(lines), flush=True)

    # (c) export_replay_dataset, its frames read back through io/png.
    out_dir = os.path.join(REPO, "_chip_scratch", "phase12_replay")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_io.StringIO()):
        rc = export_replay_dataset.main([out_dir, *REPLAY_ARGS])
    t_export = time.perf_counter() - t0
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    size = int(REPLAY_ARGS[1].split("=")[1])
    frames = [png.imread_gray(os.path.join(out_dir, fr["file"])) for fr in manifest["frames"]]
    with open(os.path.join(out_dir, "imu.csv")) as f:
        n_imu = sum(1 for ln in f if not ln.startswith("#"))
    _check(rc == 0 and len(frames) == 41 and all(fr.shape == (size, size) for fr in frames)
           and sorted(os.listdir(os.path.join(out_dir, "frames")))
           == [os.path.basename(fr["file"]) for fr in manifest["frames"]] and n_imu > 0,
           f"export_replay_dataset: rc {rc}, {len(frames)} frames, {n_imu} IMU rows")
    print(f"[phase 12] export_replay_dataset {' '.join(REPLAY_ARGS)} in {t_export:.2f} s: "
          f"{len(frames)} PNG frames {size}x{size} read back through io/png (mean grey "
          f"{np.mean([fr.mean() for fr in frames]):.1f}), {n_imu} IMU rows, manifest "
          f"{sorted(manifest)}", flush=True)

    # (d) A colour PNG sequence through EurocDataset, against the native loader.
    root = os.path.join(REPO, "_chip_scratch", "phase12_color")
    shutil.rmtree(root, ignore_errors=True)
    cam_dir = os.path.join(root, "mav0", "cam0", "data")
    os.makedirs(cam_dir)
    os.makedirs(os.path.join(root, "mav0", "imu0"))
    with open(os.path.join(root, "mav0", "imu0", "data.csv"), "w") as f:
        f.write("1000,0,0,0,0,0,9.8\n")
    rows, want = [], []
    for i, fr in enumerate(frames[:COLOR_FRAMES]):
        rgb = np.stack([fr, np.roll(fr, 7, axis=1), 255 - fr] + [fr] * (i % 2), -1)
        with open(os.path.join(cam_dir, f"{1000 + i}.png"), "wb") as f:
            f.write(_color_png(rgb))
        rows.append(f"{1000 + i},{1000 + i}.png\n")
        c = rgb[..., :3].astype(np.uint32)
        want.append(((299 * c[..., 0] + 587 * c[..., 1] + 114 * c[..., 2]) // 1000).astype(np.uint8))
    with open(os.path.join(root, "mav0", "cam0", "data.csv"), "w") as f:
        f.write("".join(rows))
    _check(native_loader.available(), "native/loader.cpp did not build")
    pure = dataset.EurocDataset(root, use_native=False)
    nat = dataset.EurocDataset(root)
    streamed = [img.copy() for _, img in nat.image_stream(size, size, prefetch=2)]
    for i in range(COLOR_FRAMES):
        path = os.path.join(cam_dir, f"{1000 + i}.png")
        native = native_loader.decode_image(path, size, size)
        _check(all(np.array_equal(x, native) for x in
                   (want[i], pure.read_image(i), nat.read_image(i), streamed[i])),
               f"colour frame {i}: io/png, EurocDataset and the native loader disagree")
    print(f"[phase 12] {COLOR_FRAMES} colour PNG frames (RGB and RGBA, {size}x{size}) read "
          f"through EurocDataset (io/png and the native loader, read_image and image_stream) "
          f"equal to the native loader's gray frames", flush=True)
    out = dict(entry_err_m=d_entry, entry_flags=flags, entry_ms=float(np.median(ms)),
               entry_syncs=float(np.mean(syncs)), tool_ate=tool_ate, export_s=t_export,
               seconds=time.perf_counter() - t_phase)
    print(f"[phase 12] took {out['seconds']:.1f} s", flush=True)
    return out


def main() -> int:
    smi_line = phase_device()
    entry_ref, entry_pool = start_entry_reference()
    from mobile_slam_tpu_torch.engine import example
    from mobile_slam_tpu_torch.engine.vio_engine import set_full_precision
    from mobile_slam_tpu_torch.eval import simulation as sim
    from mobile_slam_tpu_torch.models.cameras.base import make_camera
    from mobile_slam_tpu_torch.ops import cuda_build, lk
    from mobile_slam_tpu_torch.probes import call_overhead, lk_pack_probe

    set_full_precision()
    cfg = example.bench_config()
    t0 = time.perf_counter()
    cuda_build.build(*cuda_build.SOURCES)    # one nvcc per library, all at once
    lk.build_kernels()
    call_overhead.build_kernels()
    lk_pack_probe.build_kernels()
    print(f"[phase 1] built {', '.join(cuda_build.SOURCES)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in cuda_build.SOURCES:
        for line in cuda_build.ptxas_report(name):
            print(f"[phase 1] ptxas {name}: {line}", flush=True)
    # P2's stripped modes must keep the per-step loads they claim: noarith
    # (mode 3) loads each step's window like full (mode 0), inside the loop.
    loads = {}
    for name in cuda_build.SOURCES:
        loads.update(cuda_build.sass_loop_loads(name))
    for kern, (inner, total) in loads.items():
        print(f"[phase 1] sass {kern}: {inner} global loads inside loops, {total} in all",
              flush=True)
    full, noarith = loads["lk_probe_kernel<0>"][0], loads["lk_probe_kernel<3>"][0]
    _check(full > 0 and noarith >= full, f"P2 noarith keeps {noarith} loads in its "
           f"step loop, full {full}")
    print(f"[phase 1] K1 dynamic shared memory at window {cfg.tracker.lk_window_size}, "
          f"{cfg.tracker.lk_pyramid_levels + 1} levels: "
          f"{lk.track_smem_bytes(cfg.tracker.lk_window_size, cfg.tracker.lk_pyramid_levels + 1)}"
          f" B of {lk.SMEM_LIMIT}", flush=True)

    cam = make_camera(cfg.camera, dtype=torch.float64, device="cpu")
    data = sim.simulate(example.bench_sim_config(8.0), cam,
                        cfg.camera.r_ic_mat, cfg.camera.t_ic_vec)
    pair = bench_pair(data, cam, cfg, sim, example)
    kernels = phase_kernels(lk, pair, cfg)
    stream = phase_streaming(lk, data, cam, cfg, sim, example)
    serve = phase_serving(lk, cfg, sim, example, make_camera)
    kernels.update(phase_probes(lk, pair))
    cli_run = phase_cli(lk, data, stream["syncs_per_frame"])
    fleet_k = phase_fleet_kernels(lk, _fleet_pairs(data, cam, cfg, sim, example, pair), cfg)
    fleet = phase_image_fleet(lk, cfg, sim, example, make_camera, serve)
    ffleet = phase_feature_fleet(cfg, data, sim, serve)
    m_over, m_cfg, m_cam, m_data, m_in_view = mobile_sequence(sim, make_camera)
    m_pair = bench_pair(m_data, m_cam, m_cfg, sim, example, r_ic=m_cfg.camera.r_ic_mat)
    mobile_k = phase_kernels(lk, m_pair, m_cfg, tag="phase 8", second_cases=False)
    gate = phase_gateway(lk, m_over, m_cfg, m_cam, m_data, sim, m_in_view)
    arms = phase_solver_arms(stream, cfg)
    ransac_arms = phase_ransac(lk, pair, cfg)
    cams = phase_cameras(lk, sim, example, make_camera)
    tp = phase_tp_solver(stream, cfg)
    t10 = time.perf_counter()
    calib = phase_calibration()
    adver = phase_adversarial(lk, cfg)
    tail = phase_tail_replay(lk, cfg, sim, example, make_camera)
    print(f"[phase 10] took {time.perf_counter() - t10:.1f} s", flush=True)
    ranked = phase_rank_fleet(lk, fleet, ffleet)
    with entry_pool:
        cpu_steps = entry_ref.result()
    unit = phase_entry_tools(cli_run, cpu_steps)
    for k in LK_PER_FRAME:
        kernels[k].update(launches=cli_run["counts"][k], launches_serving=serve["counts"][k],
                          launches_streaming=stream["counts"][k],
                          launches_fleet=fleet["counts"][k],
                          launches_gateway=gate["counts"][k],
                          launches_mei=cams["counts"][k],
                          launches_adversarial=adver["counts"][k],
                          launches_rank_fleet=[c[k] for c in ranked["counts"]], **fleet_k[k],
                          **{f"mobile_{n}": v for n, v in mobile_k[k].items()})
    print(f"[summary] streaming {stream['ms_per_frame']:.2f} ms per tracking frame, "
          f"{stream['syncs_per_frame']:.1f} host syncs per frame; chunked "
          f"{serve['ms_per_chunked_frame']:.2f} ms per frame, "
          f"{serve['syncs_per_chunked_frame']:.1f} host syncs per frame; serving "
          f"ATE {serve['ate']:.4f} m over {serve['n_poses']} poses; CLI (pipelined) "
          f"{cli_run['frames']} frames, {cli_run['poses']} poses, fps {cli_run['fps']:.3f}, "
          f"ATE {cli_run['ate']:.4f} m, {cli_run['syncs_per_pipelined_frame']:.1f} host syncs "
          f"per pipelined frame, measure_device_step {cli_run['device_step_ms']:.3f} ms; "
          f"image fleet B={FLEET_B} {fleet['fps']:.3f} fps ({fleet['fps_per_seq']:.3f} per "
          f"sequence, {fleet['ms_per_fleet_frame']:.2f} ms per fleet frame, "
          f"{fleet['syncs_per_fleet_frame']:.2f} host syncs per fleet frame) against "
          f"chunked {serve['chunked_fps']:.3f} fps; feature fleet B={FEATURE_FLEET_B} "
          f"{ffleet['fps']:.3f} fps against single-stream {ffleet['single_chunked_fps']:.3f}; "
          f"gateway ({MOBILE_PROFILE}, td on) {gate['fps']:.3f} fps, proc_ms median "
          f"{gate['proc_ms_median']:.2f} p90 {gate['proc_ms_p90']:.2f}, ATE {gate['ate']:.4f} m, "
          f"td {1e3 * gate['td_final']:.3f} ms against {1e3 * MOBILE_TD:.1f} ms; solver arms "
          f"(float32 ms per solve_and_slide, host syncs, LM iterations) "
          f"{ {k: (round(v['ms'], 2), v['syncs'], v['iterations']) for k, v in arms.items()} }; "
          f"RANSAC lu {ransac_arms['lu']['ms']:.3f} ms / eigh {ransac_arms['eigh']['ms']:.3f} ms; "
          f"Mei ATE {cams['ate']:.4f} m; tp_damped_step dx {tp['dx_rel']:.1e}; calibration rms "
          f"{ {k: round(v['rms'], 4) for k, v in calib.items() if isinstance(v, dict) and 'rms' in v} } px; "
          f"adversarial (level: ATE m, poses, frames, recoveries) "
          f"{ {a['level']: (round(a['ate'], 4), a['poses'], a['frames'], a['recoveries']) for a in adver['arms']} }"
          f"; "
          f"tail replay {tail['recoveries']} recoveries, replay ms "
          f"{[round(x, 1) for x in tail['replay_ms']]}; fleet over {ranked['world']} ranks "
          f"({ranked['cards']} card(s)) {ranked['fps']:.3f} fps against {fleet['fps']:.3f} at "
          f"world 1 (ratio {ranked['fps_ratio']:.3f}), feature fleet ratio "
          f"{ranked['feature_fps_ratio']:.3f}, dryrun speedup "
          f"{ranked['dryrun']['speedup']:.2f}x; entry step {unit['entry_ms']:.2f} ms, "
          f"{unit['entry_syncs']:.1f} host syncs; compare_trajectories ATE "
          f"{unit['tool_ate']:.4f} m against phase 6's {cli_run['ate']:.4f} m",
          flush=True)
    _check("jax" not in sys.modules, "jax was imported")
    _check(not any(m == "mobile_slam_tpu" or m.startswith("mobile_slam_tpu.")
                   for m in sys.modules), "the JAX package was imported")

    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=src, replaces=rep, **kernels[k])
        for k, (src, rep) in KERNELS.items()]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
