"""Immutable configuration for the TPU-native VIO framework.

Replaces the reference's global mutable ``utility::g_config``
(``include/utility/config.h``, ``src/utility/config.cpp``) with frozen
dataclasses threaded explicitly through the pipeline. Static fields (shapes,
window size, iteration counts) become jit-static; runtime-tunable scalars
(noise levels, thresholds) live in device arrays created from this config.

The YAML loader accepts the reference's config format, including the
OpenCV-style ``%YAML:1.0`` header, ``!!opencv-matrix`` extrinsics, and both
intrinsics naming schemes (``fx/fy/cx/cy`` and ``mu/mv/u0/v0``), mirroring
``Config::loadFromYaml`` (src/utility/config.cpp:15-140).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Tuple

import numpy as np

WINDOW_SIZE = 10  # Keyframe window: WINDOW_SIZE+1 = 11 slots (utility/config.h:11).
NUM_SLOTS = WINDOW_SIZE + 1

# State tangent ordering inside one frame block (utility/config.h StateOrder).
O_P, O_R, O_V, O_BA, O_BG = 0, 3, 6, 9, 12
FRAME_TANGENT = 15
EX_TANGENT = 6
# Camera-IMU time offset (td): one scalar calibration state, jointly
# estimated VINS-Fusion-style (ray_td = ray - td * vel in the projection
# residual). The reference explicitly LACKS td estimation
# (docs/analysis-report.md:408-418 missing-features list) — this is a
# capability beyond parity. Solved dims are the prefix [frames | td];
# the extrinsic block stays held constant after it.
TD_TANGENT = 1
# Full tangent layout used by the solver & marginalization prior:
# [11 frames x 15] + [td 1] + [extrinsic 6].
STATE_TANGENT = NUM_SLOTS * FRAME_TANGENT + TD_TANGENT + EX_TANGENT

MODEL_PINHOLE = "PINHOLE"
MODEL_KANNALA_BRANDT = "KANNALA_BRANDT"
MODEL_MEI = "MEI"
MODEL_SCARAMUZZA = "SCARAMUZZA"


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera intrinsics + camera-to-IMU extrinsics (CameraConfig, config.h:18-31)."""

    model_type: str = MODEL_PINHOLE
    width: int = 752
    height: int = 480
    focal_length: float = 460.0
    # Pinhole: fx fy cx cy;  Kannala-Brandt: mu mv u0 v0;  Mei: gamma1 gamma2 u0 v0.
    fx: float = 460.0
    fy: float = 460.0
    cx: float = 376.0
    cy: float = 240.0
    # Distortion. Pinhole/Mei: (k1, k2, p1, p2). Kannala-Brandt: (k2, k3, k4, k5).
    dist: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    # Mei mirror parameter.
    xi: float = 0.0
    # Scaramuzza polynomial coefficients (forward poly, inverse poly).
    ocam_poly: Tuple[float, ...] = ()
    ocam_inv_poly: Tuple[float, ...] = ()
    ocam_center: Tuple[float, float] = (0.0, 0.0)  # (cx, cy)
    ocam_affine: Tuple[float, float, float] = (1.0, 0.0, 0.0)  # (c, d, e)
    # Extrinsics: rotation/translation from camera frame to IMU frame (imu^T_cam).
    r_ic: Tuple[float, ...] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    t_ic: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def r_ic_mat(self) -> np.ndarray:
        return np.asarray(self.r_ic, dtype=np.float64).reshape(3, 3)

    @property
    def t_ic_vec(self) -> np.ndarray:
        return np.asarray(self.t_ic, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Feature tracker parameters (FeatureTrackerConfig, config.h:34-59)."""

    max_cnt: int = 150
    min_dist: int = 30
    f_threshold: float = 1.0
    equalize: bool = True
    fisheye: bool = False
    lk_window_size: int = 21
    lk_pyramid_levels: int = 3
    lk_iterations: int = 30
    lk_eps: float = 0.01
    f_threshold_edge_factor: float = 0.0
    # Fixed-capacity point slots for the jitted tracker (>= max_cnt).
    # 160 == 192 in the 8-seed 14 s + 2-seed 140 s image-path A/Bs
    # (artifacts/multiseed_extrafast.json, multiseed_140_extrafast.json:
    # ATE 0.021/0.035 m vs control 0.023/0.025 m, 0 gate trips, 2x faster).
    max_points: int = 160
    # RANSAC hypothesis count for the vectorized F-matrix rejection.
    # 32 == 64 in the 8-seed image-path A/B (the estimator's own outlier
    # culling + FB check backstop the weaker single-shot confidence);
    # artifacts/multiseed_it3_ransac32.json. 16 == 32 in the extra-fast
    # 140 s confirm (multiseed_140_extrafast.json).
    ransac_iters: int = 16
    # Shi-Tomasi detection grid (replaces the sequential min-dist mask paint).
    quality_level: float = 0.01
    # Forward-backward verification: track next->prev and kill tracks whose
    # round trip misses the origin by more than fb_max_err px. Culls the
    # occlusion/aperture failures cv::calcOpticalFlowPyrLK lets through.
    fb_check: bool = True
    fb_max_err: float = 0.5
    # Backward-pass implementation for the FB check:
    #   "pyramid" — full pyramidal LK next->prev from the tracked position
    #               (symmetric to the forward pass; 2x the LK cost);
    #   "prior0"  — finest-level-only refinement initialized AT the known
    #               origin (prev position): extract the patch around the
    #               tracked point in the NEW frame, KLT-refine it in the
    #               PREVIOUS frame starting from the old position, and
    #               require it to stay there. Tests the same next->prev
    #               photometric consistency at ~1/5 the cost; the round
    #               trip a bad track fails is the same (the new-frame
    #               patch does not match the old position).
    # Default prior0: E2E-identical to pyramid in the 8-seed 14 s and
    # 2-seed 140 s A/Bs (artifacts/multiseed_fbprior0.json,
    # multiseed_140_fastpkg.json) at ~1/5 the cost.
    fb_mode: str = "prior0"
    # Anchor-template refinement: re-localize each track against its
    # first-observation patch (zero-mean KLT at full resolution) so
    # frame-to-frame errors do not random-walk. Re-anchors automatically
    # when appearance changes (resid > anchor_resid or shift > max_shift).
    anchor_refine: bool = True
    # 4 == 8 in the extra-fast multiseed A/Bs (anchor KLT converges in <4
    # iterations at these patch sizes; multiseed_140_extrafast.json).
    anchor_iters: int = 4
    anchor_max_shift: float = 2.0   # px search radius around the LK estimate
    anchor_resid: float = 14.0      # mean |zero-mean diff| re-anchor gate
    # LK/anchor kernel implementation: None = auto (Pallas on TPU, where
    # XLA's gather-based formulation serializes to ~400 ms/frame; plain XLA
    # on CPU). True/False force it.
    use_pallas: bool | None = None
    # Corner detection runs only when at least this many point slots need
    # refilling. 1 = top up every frame (the reference's behavior,
    # feature_tracker.cpp:185-186); higher values refill in bursts, which
    # skips the Shi-Tomasi/occupancy/NMS block on most TRACKING frames
    # (lax.cond executes one branch on TPU) at the cost of the live count
    # dipping up to this far below max_cnt.
    refill_min_deficit: int = 1


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Backend parameters (EstimatorConfig, config.h:62-82)."""

    # LM iteration budget. The reference budgets 10 Ceres iterations
    # (config.h:62-82) but stops early on function_tolerance; with the
    # square-root prior our solver converges in <=5 accepted steps — a
    # 5-vs-8 multiseed A/B is bit-identical per seed at 14 s (8 seeds) and
    # 140 s (2 seeds) while chunked throughput rises 30%
    # (artifacts/multiseed_iters.json, artifacts/multiseed_140_iters.json).
    # 3 LM iterations == 5 == 8 with the square-root prior: 8-seed 14 s and
    # 2-seed 140 s image-path A/Bs are statistically identical (the fast
    # package is slightly BETTER at 140 s: 0.024 vs 0.030 m median) —
    # artifacts/multiseed_it3_ransac32.json, multiseed_140_fastpkg.json.
    num_iterations: int = 3
    solver_time: float = 0.05  # Advisory only; the TPU solver is iteration-budgeted.
    min_parallax: float = 10.0  # Keyframe threshold in pixels.
    init_depth: float = 5.0
    acc_n: float = 0.08
    acc_w: float = 0.00004
    gyr_n: float = 0.004
    gyr_w: float = 2.0e-6
    g_norm: float = 9.81007
    # Fixed-shape capacities (jit-static).
    max_features: int = 512          # Landmark slots in the sliding-window solver.
    max_imu_per_interval: int = 64   # IMU readings per camera interval (per slot).
    # Robust loss scale for projection factors (CauchyLoss(1.0), optimizer.cpp:106).
    cauchy_scale: float = 1.0
    # Online camera-IMU time-offset (td) estimation. When True the solver
    # estimates a single td state jointly with the window (VINS-Fusion's
    # ProjectionTdFactor idea: the observation at reported time t was really
    # taken at t + td, so ray_corrected = ray - td * vel). The reference has
    # no td estimation (docs/analysis-report.md:408-418). Default OFF
    # pending the 140 s multiseed A/B gate (ROUND2/3 flip protocol).
    estimate_td: bool = False
    td_init: float = 0.0   # seconds; prior belief of the offset
    td_max: float = 0.08   # hard clamp on |td| (seconds)
    # td memory model (probed in scripts/dev_td_probe.py /
    # dev_td_data_probe.py). Full FEJ memory on td (td_prior_forget=1.0)
    # anchors the offset at its early wrong estimate (measured: 0->3 ms
    # creep in 3 s against a 10 ms truth, prior td-information ~7e6). And
    # td rides a near-flat (poses <-> time-shift) valley whenever velocity
    # is locally constant — the anchor-depth lift absorbs a first-order
    # time shift — so with no anchor at all the joint solve leaks a
    # truth-initialized td 9.5 -> 0.5 ms over ~20 slow frames even though
    # a td-only cost scan still points at the truth. Resolution: td memory
    # lives in a CONSTANT-strength random-walk prior inside the solver
    # (H[td,td] += td_rw_info, anchored at the last solved value) rather
    # than the accumulated marginalization prior; the prior's td column is
    # cleared each step (forget=0). td_fuse_info optionally adds an outer
    # observability-gated fusion I_w/(I_w + C); 0 disables (gain 1).
    td_prior_forget: float = 0.0
    td_fuse_info: float = 3.0e6
    # Excitation gate knee: mean per-obs td curvature (whitened/s)^2
    # below which td updates are quadratically suppressed. Measured on
    # the synthetic figure run: constant-velocity stretches sit at
    # ~1e3-8e3, excited stretches at ~1e4-3e4 (dev_td_probe.py).
    td_gate_curv: float = 1.0e4
    td_rw_info: float = 0.0  # legacy joint-solve anchor; inert (TD_JOINT_GATE=0)

    @property
    def gravity(self) -> np.ndarray:
        return np.asarray([0.0, 0.0, self.g_norm], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class VIOConfig:
    """Top-level config (Config, config.h:85-100)."""

    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    estimator: EstimatorConfig = dataclasses.field(default_factory=EstimatorConfig)
    frame_skip: int = 0
    start_frame: int = 0
    end_frame: int = -1
    dataset_path: str = ""

    def replace(self, **kwargs) -> "VIOConfig":
        return dataclasses.replace(self, **kwargs)


def _strip_opencv_yaml(text: str) -> str:
    """Make OpenCV-flavored YAML digestible by PyYAML."""
    text = re.sub(r"^%YAML[^\n]*\n", "", text)
    text = re.sub(r"^---[^\n]*\n", "", text)
    # Replace the opencv-matrix tag; the mapping payload (rows/cols/dt/data)
    # parses fine as a plain dict.
    text = text.replace("!!opencv-matrix", "")
    return text


def _as_matrix(node) -> np.ndarray:
    """Accept either an opencv-matrix mapping or a flat list."""
    if isinstance(node, dict) and "data" in node:
        rows = int(node.get("rows", 0)) or 1
        cols = int(node.get("cols", 0)) or len(node["data"])
        return np.asarray(node["data"], dtype=np.float64).reshape(rows, cols)
    return np.asarray(node, dtype=np.float64)


def load_config(path: str) -> VIOConfig:
    """Load a reference-format YAML config file into a VIOConfig.

    Honors both intrinsics naming schemes and the opencv-matrix extrinsics,
    mirroring ``Config::loadFromYaml`` (src/utility/config.cpp:15-140).
    """
    import yaml

    with open(path, "r") as f:
        raw = yaml.safe_load(_strip_opencv_yaml(f.read()))

    model_type = str(raw.get("model_type", MODEL_PINHOLE)).upper()
    width = int(raw.get("image_width", 752))
    height = int(raw.get("image_height", 480))

    proj = raw.get("projection_parameters", {}) or {}
    distn = raw.get("distortion_parameters", {}) or {}

    if model_type == MODEL_KANNALA_BRANDT:
        fx = float(proj.get("mu", proj.get("fx", 460.0)))
        fy = float(proj.get("mv", proj.get("fy", fx)))
        cx = float(proj.get("u0", proj.get("cx", width * 0.5)))
        cy = float(proj.get("v0", proj.get("cy", height * 0.5)))
        dist = tuple(
            float(proj.get(k, distn.get(k, 0.0))) for k in ("k2", "k3", "k4", "k5")
        )
        xi = 0.0
    elif model_type == MODEL_MEI:
        fx = float(proj.get("gamma1", proj.get("fx", 460.0)))
        fy = float(proj.get("gamma2", proj.get("fy", fx)))
        cx = float(proj.get("u0", proj.get("cx", width * 0.5)))
        cy = float(proj.get("v0", proj.get("cy", height * 0.5)))
        dist = tuple(float(distn.get(k, 0.0)) for k in ("k1", "k2", "p1", "p2"))
        xi = float(raw.get("mirror_parameters", {}).get("xi", proj.get("xi", 0.0)))
    else:  # PINHOLE (and SCARAMUZZA handled separately below)
        fx = float(proj.get("fx", proj.get("mu", 460.0)))
        fy = float(proj.get("fy", proj.get("mv", fx)))
        cx = float(proj.get("cx", proj.get("u0", width * 0.5)))
        cy = float(proj.get("cy", proj.get("v0", height * 0.5)))
        dist = tuple(float(distn.get(k, 0.0)) for k in ("k1", "k2", "p1", "p2"))
        xi = 0.0

    r_ic = np.eye(3)
    t_ic = np.zeros(3)
    if "extrinsicRotation" in raw:
        r_ic = _as_matrix(raw["extrinsicRotation"]).reshape(3, 3)
    if "extrinsicTranslation" in raw:
        t_ic = _as_matrix(raw["extrinsicTranslation"]).reshape(3)

    camera = CameraConfig(
        model_type=model_type,
        width=width,
        height=height,
        focal_length=float(fx),
        fx=fx,
        fy=fy,
        cx=cx,
        cy=cy,
        dist=dist,
        xi=xi,
        r_ic=tuple(r_ic.reshape(-1).tolist()),
        t_ic=tuple(t_ic.tolist()),
    )

    tracker = TrackerConfig(
        max_cnt=int(raw.get("max_cnt", 150)),
        min_dist=int(raw.get("min_dist", 30)),
        f_threshold=float(raw.get("F_threshold", 1.0)),
        equalize=bool(raw.get("equalize", 1)),
        fisheye=bool(raw.get("fisheye", 0)),
        lk_window_size=int(raw.get("lk_window_size", 21)),
        lk_pyramid_levels=int(raw.get("lk_pyramid_levels", 3)),
        lk_iterations=int(raw.get("lk_iterations", 30)),
        lk_eps=float(raw.get("lk_eps", 0.01)),
        f_threshold_edge_factor=float(raw.get("f_threshold_edge_factor", 0.0)),
        # Slot capacity follows max_cnt (rounded up to a multiple of 32 for
        # TPU lane alignment) so configs with large budgets (kitti360
        # max_cnt=500) pass validation without hand-setting max_points.
        max_points=max(TrackerConfig.max_points,
                       -(-int(raw.get("max_cnt", 150)) // 32) * 32),
    )

    estimator = EstimatorConfig(
        num_iterations=int(raw.get("max_num_iterations", 10)),
        solver_time=float(raw.get("max_solver_time", 0.05)),
        min_parallax=float(raw.get("keyframe_parallax", 10.0)),
        init_depth=float(raw.get("init_depth", 5.0)),
        acc_n=float(raw.get("acc_n", 0.08)),
        acc_w=float(raw.get("acc_w", 0.00004)),
        gyr_n=float(raw.get("gyr_n", 0.004)),
        gyr_w=float(raw.get("gyr_w", 2.0e-6)),
        g_norm=float(raw.get("g_norm", 9.81007)),
        estimate_td=bool(raw.get("estimate_td", 0)),
        td_init=float(raw.get("td", 0.0)),
    )

    return VIOConfig(
        camera=camera,
        tracker=tracker,
        estimator=estimator,
        frame_skip=int(raw.get("frame_skip", 0)),
        start_frame=int(raw.get("start_frame", 0)),
        end_frame=int(raw.get("end_frame", -1)),
        dataset_path=str(raw.get("dataset_path", "")),
    )


def validate_config(cfg: VIOConfig) -> list[str]:
    """Positivity / sanity checks mirroring ``ConfigManager::validateConfiguration``
    (src/config/config_manager.cpp:63-123). Returns a list of problems (empty = ok)."""
    problems = []
    cam = cfg.camera
    if cam.width <= 0 or cam.height <= 0:
        problems.append("camera image size must be positive")
    if cam.fx <= 0 or cam.fy <= 0:
        problems.append("camera focal length must be positive")
    if cam.focal_length <= 0:
        problems.append("camera focal_length must be positive")
    est = cfg.estimator
    if est.num_iterations <= 0:
        problems.append("estimator num_iterations must be positive")
    if min(est.acc_n, est.gyr_n, est.acc_w, est.gyr_w) <= 0:
        problems.append("IMU noise parameters must be positive")
    if est.g_norm <= 0:
        problems.append("gravity norm must be positive")
    if est.init_depth <= 0:
        problems.append("init_depth must be positive")
    trk = cfg.tracker
    if trk.max_cnt <= 0:
        problems.append("tracker max_cnt must be positive")
    if trk.min_dist <= 0:
        problems.append("tracker min_dist must be positive")
    if trk.max_points < trk.max_cnt:
        problems.append("tracker max_points must be >= max_cnt")
    if trk.f_threshold <= 0:
        problems.append("tracker F_threshold must be positive")
    return problems
