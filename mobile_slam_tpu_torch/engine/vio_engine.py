"""VIOEngine — push-style streaming VIO API (torch twin of the synchronous
subset of mobile_slam_tpu.engine.vio_engine).

Push IMU readings and grayscale frames; each ``process_frame`` runs the
tracker and the estimator on the engine's device (the card unless the
caller passes ``device="cpu"``) and returns a 4x4 camera pose with the
status machine of the reference engine (INITIALIZING -> TRACKING,
estimator rebuilds on divergence or scale runaway, cooldown after repeated
failures). ``process_features`` is the feature-level entry point that
skips the tracker. Initialization runs on the host through the port's
numpy ``init`` stack.

Not ported yet: pipelined streaming, the packed-transfer paths,
``measure_device_step`` and map points.
"""

from __future__ import annotations

import enum
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mobile_slam_tpu_torch.config import NUM_SLOTS, VIOConfig, validate_config
from mobile_slam_tpu_torch.init.alignment import HostFrame, NpPreintegration
from mobile_slam_tpu_torch.init.initializer import try_initialize
from mobile_slam_tpu_torch.engine import estimator as est
from mobile_slam_tpu_torch.frontend import tracker as trk
from mobile_slam_tpu_torch.models.cameras.base import make_camera

W = NUM_SLOTS
INIT_TIMEOUT_S = 15.0
MAX_CONSECUTIVE_FAILURES = 5
COOLDOWN_FRAMES = 30
MAX_IMU_DT = 0.5
MIN_IMU_DT = 1e-4


class Status(enum.IntEnum):
    NOT_CONFIGURED = 0
    INITIALIZING = 1
    TRACKING = 2
    LOST = 3
    COOLDOWN = 4


class FrameResult(NamedTuple):
    ok: bool
    pose: Optional[np.ndarray]     # 4x4 world-from-camera
    status: Status
    num_features: int
    is_keyframe: bool


def _np_quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def require_device(device) -> torch.device:
    """``torch.device(device)``; raises for a CUDA device on a machine
    without one (no path falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return dev


def set_full_precision() -> None:
    """Full-fp32 matmuls and convolutions: the estimator's whitened systems
    span ~1e15 and the image ops feed sub-pixel math, so TF32 is wrong here."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class VIOEngine:
    """Push-mode VIO engine, one instance per camera stream."""

    DEPTH_RUNAWAY_FACTOR = 3.0
    VEL_RUNAWAY_FACTOR = 2.0
    DEPTH_EMA_RATE = 0.005

    def __init__(self, cfg: VIOConfig, *, device="cuda", dtype=torch.float32):
        set_full_precision()
        problems = validate_config(cfg)
        if problems:
            raise ValueError(f"invalid config: {problems}")
        self.cfg = cfg
        self.device = require_device(device)
        self.dtype = dtype
        self.camera = make_camera(cfg.camera, dtype=dtype, device=self.device)
        self.params = est.make_params(cfg, dtype=dtype, device=self.device)
        self._gravity_np = np.asarray(cfg.estimator.gravity, np.float64)
        self.reset()

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype or self.dtype, device=self.device)

    def reset(self) -> None:
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        self.state = est.init_state(self.cfg, self.params)
        self.tracker_state = trk.init_tracker_state(
            self.cfg.tracker, self.cfg.camera.height, self.cfg.camera.width,
            dtype=self.dtype, device=self.device)
        self._depth_ema: Optional[float] = None
        self._vel_ema = 0.05
        self.status = Status.INITIALIZING
        self.host_frames: list[HostFrame] = []
        self.window_ts = np.zeros(W)
        self._t0: Optional[float] = None
        self._first_frame_time: Optional[float] = None
        self._last_frame_ts: Optional[float] = None
        self._last_imu: Optional[np.ndarray] = None
        self._pending_imu: list[np.ndarray] = []
        self._consecutive_failures = 0
        self._cooldown_remaining = 0
        self._last_imu_tail = np.zeros(6)
        self._banned_ids = torch.full((self.cfg.estimator.max_features,), -1,
                                      dtype=torch.int32, device=self.device)
        self.params = self.params._replace(gravity=self._t(self._gravity_np))

    def _rebuild_estimator(self) -> None:
        """Estimator rebuild on failure; the tracker state survives."""
        old_td = float(self.state.td)
        if not math.isfinite(old_td):
            old_td = float(self.cfg.estimator.td_init)
        self.state = est.init_state(self.cfg, self.params)
        self.state = self.state._replace(td=self._t(old_td))
        self._depth_ema = None
        self._vel_ema = 0.05
        self.host_frames = []
        self.window_ts = np.zeros(W)
        self._first_frame_time = None
        self.status = Status.INITIALIZING
        self.params = self.params._replace(gravity=self._t(self._gravity_np))

    # ------------------------------------------------------------------
    # IMU handling
    # ------------------------------------------------------------------

    def push_imu(self, ts: float, acc, gyr) -> None:
        self._pending_imu.append(np.concatenate(
            [[ts], np.asarray(acc, float), np.asarray(gyr, float)]))

    def _drain_imu(self, frame_ts: float):
        """Samples in (last_frame_ts, frame_ts], dt-gated, with linear
        interpolation at the frame timestamp."""
        take, keep = [], []
        for s in self._pending_imu:
            (take if s[0] <= frame_ts else keep).append(s)
        nxt = keep[0] if keep else None
        self._pending_imu = keep
        dts, accs, gyrs = [], [], []
        prev_ts = self._last_frame_ts
        for s in take:
            dt = s[0] - prev_ts if prev_ts is not None else 0.005
            if dt < MIN_IMU_DT or dt > MAX_IMU_DT:
                prev_ts = s[0]
                self._last_imu = s
                continue
            dts.append(dt)
            accs.append(s[1:4])
            gyrs.append(s[4:7])
            prev_ts = s[0]
            self._last_imu = s
        if (self._last_imu is not None and nxt is not None
                and prev_ts is not None and prev_ts < frame_ts):
            t0, t1 = self._last_imu[0], nxt[0]
            if t1 > t0:
                a = (frame_ts - t0) / (t1 - t0)
                interp = (1 - a) * self._last_imu[1:] + a * nxt[1:]
                dt = frame_ts - prev_ts
                if MIN_IMU_DT <= dt <= MAX_IMU_DT:
                    dts.append(dt)
                    accs.append(interp[0:3])
                    gyrs.append(interp[3:6])
                    self._last_imu = np.concatenate([[frame_ts], interp])
        return (np.asarray(dts), np.asarray(accs).reshape(-1, 3),
                np.asarray(gyrs).reshape(-1, 3))

    # ------------------------------------------------------------------
    # Frame processing
    # ------------------------------------------------------------------

    def process_frame(self, image, frame_ts: float,
                      imu_override=None) -> FrameResult:
        """Full image path: track features, then run the estimator.

        imu_override: optional (dts, accs, gyrs) host arrays used instead
        of draining the engine's IMU buffer (the serving layer replays
        frames whose IMU slice a chunk already drained)."""
        img = self._t(np.asarray(image))
        if self._t0 is None:
            self._t0 = frame_ts
        self.tracker_state, tout = trk.detect_and_track(
            self.tracker_state, img, frame_ts - self._t0, self.camera,
            self.cfg.tracker, self.cfg.camera.focal_length,
            generator=self._gen, banned_ids=self._banned_ids)
        feats = (tout.ids, tout.obs, tout.uv, tout.vel, tout.valid)
        return self._process_tracked(frame_ts, feats, imu_override)

    def process_features(self, frame_ts: float, ids, rays, uv=None, vel=None,
                         valid=None) -> FrameResult:
        """Feature-level entry point (bypasses the tracker): ``ids`` (n,),
        unit-z ``rays`` (n, 3), optional ``uv``/``vel`` (n, 2) and
        ``valid`` (n,), padded here to the tracker's slot count."""
        k_pad = self.cfg.tracker.max_points
        n = len(ids)
        if n > k_pad:
            raise ValueError(f"too many features: {n} > {k_pad}")

        def pad(a, shape):
            out = np.zeros((k_pad,) + shape)
            if n:
                out[:n] = a
            return self._t(out)

        ids_p = np.full(k_pad, -1, np.int32)
        ids_p[:n] = np.asarray(ids, np.int32)
        valid_p = np.zeros(k_pad, bool)
        valid_p[:n] = True if valid is None else np.asarray(valid, bool)
        feats = (torch.as_tensor(ids_p, device=self.device), pad(np.asarray(rays), (3,)),
                 pad(uv if uv is not None else np.zeros((n, 2)), (2,)),
                 pad(vel if vel is not None else np.zeros((n, 2)), (2,)),
                 torch.as_tensor(valid_p, device=self.device))
        if self._t0 is None:
            self._t0 = frame_ts
        # A frame that enters TRACKING through initialization keeps the
        # solver's track count, as the image path does.
        was_tracking = self.status == Status.TRACKING
        res = self._process_tracked(frame_ts, feats)
        if was_tracking and res.status == Status.TRACKING:
            res = res._replace(num_features=int(valid_p.sum()))
        return res

    def _frame_input(self, frame_ts, feats, dts, accs, gyrs):
        ids, obs, uv, vel, valid = feats
        m_pad = self.cfg.estimator.max_imu_per_interval
        m = min(len(dts), m_pad)

        def pad(a, shape):
            out = np.zeros((m_pad,) + shape)
            out[:m] = a[:m]
            return self._t(out)

        return est.FrameInput(
            ts=self._t(frame_ts - self._t0), ids=ids, obs=obs.to(self.dtype),
            uv=uv.to(self.dtype), vel=vel.to(self.dtype), valid=valid,
            imu_dt=pad(dts, ()), imu_acc=pad(accs, (3,)), imu_gyr=pad(gyrs, (3,)),
            imu_cnt=self._t(m, torch.int32))

    def _process_tracked(self, frame_ts, feats, imu_override=None) -> FrameResult:
        if self._first_frame_time is None:
            self._first_frame_time = frame_ts
        if self._cooldown_remaining > 0:
            self._cooldown_remaining -= 1
            self._last_frame_ts = frame_ts
            if self._cooldown_remaining == 0:
                self._rebuild_estimator()
                self._first_frame_time = frame_ts
            return FrameResult(False, None, Status.COOLDOWN, 0, False)

        if imu_override is not None:
            dts, accs, gyrs = imu_override
            dts = np.asarray(dts, float)
            accs = np.asarray(accs, float).reshape(-1, 3)
            gyrs = np.asarray(gyrs, float).reshape(-1, 3)
        else:
            dts, accs, gyrs = self._drain_imu(frame_ts)
        inp = self._frame_input(frame_ts, feats, dts, accs, gyrs)
        self.state, is_kf = est.bookkeeping_step(self.state, inp, self.params)
        is_kf = bool(is_kf)
        if self.status == Status.TRACKING:
            self.window_ts[W - 1] = frame_ts
            result = self._process_tracking(is_kf)
        else:
            fc = int(self.state.frame_count)
            self.window_ts[min(fc, W - 1)] = frame_ts
            result = self._process_initializing(inp, is_kf, frame_ts, dts, accs, gyrs)
        self._last_frame_ts = frame_ts
        return result

    def _record_host_frame(self, frame_ts, ids, obs, dts, accs, gyrs):
        ids_np = ids.cpu().numpy()
        obs_np = obs.cpu().numpy().astype(np.float64)
        points = {int(i): obs_np[k] for k, i in enumerate(ids_np) if i >= 0}
        if self.host_frames:
            last = self._last_imu_tail
            pre = NpPreintegration(last[0:3], last[3:6], dts, accs, gyrs)
        else:
            pre = None
        if len(accs):
            self._last_imu_tail = np.concatenate([accs[-1], gyrs[-1]])
        self.host_frames.append(HostFrame(frame_ts, points, pre))

    def _process_initializing(self, inp, is_kf, frame_ts, dts, accs, gyrs) -> FrameResult:
        self._record_host_frame(frame_ts, inp.ids, inp.obs, dts, accs, gyrs)
        if (self._first_frame_time is not None
                and frame_ts - self._first_frame_time > INIT_TIMEOUT_S):
            self._rebuild_estimator()
            self._first_frame_time = frame_ts
            return FrameResult(False, None, Status.INITIALIZING, 0, False)

        fc = int(self.state.frame_count)
        if fc == W - 1:
            tab = self.state.table
            table_np = {"fid": tab.fid.cpu().numpy(), "start": tab.start.cpu().numpy(),
                        "obs": tab.obs.cpu().numpy().astype(np.float64),
                        "mask": tab.mask.cpu().numpy()}
            res = try_initialize(self.host_frames, self.window_ts, table_np,
                                 self.cfg.camera.focal_length,
                                 self.cfg.camera.r_ic_mat, self.cfg.camera.t_ic_vec,
                                 self.cfg.estimator.g_norm)
            if res.ok:
                self.state, g_world = est.apply_initialization(
                    self.state, self._t(res.p_cam), self._t(res.q_body),
                    self._t(res.v_world), self._t(res.bg), self._t(res.gravity),
                    self._t(res.scale), self.params)
                self.params = self.params._replace(gravity=g_world)
                self.status = Status.TRACKING
                self.host_frames = []
                return self._process_tracking(is_kf)

        old_ts0 = self.window_ts[0]
        self.state = est.initial_advance_or_slide(self.state, is_kf, self.params)
        if fc == W - 1:
            if is_kf:
                self.window_ts[:-1] = self.window_ts[1:]
                self.host_frames = [f for f in self.host_frames if f.ts > old_ts0]
            else:
                self.window_ts[W - 2] = self.window_ts[W - 1]
        n_feat = int(inp.valid.sum())
        return FrameResult(False, None, Status.INITIALIZING, n_feat, is_kf)

    def _process_tracking(self, is_kf: bool) -> FrameResult:
        self.state, p_out, q_out, diag = est.solve_and_slide(
            self.state, is_kf, self.params, self.cfg.estimator.num_iterations)
        self._banned_ids = diag.culled_ids
        packed = torch.cat([p_out, q_out, torch.stack([
            diag.vel_norm, diag.pos_norm, diag.med_depth,
            diag.state_finite.to(p_out.dtype), diag.last_track_num.to(p_out.dtype)])])
        return self._finalize_tracking(packed.cpu().numpy().astype(np.float64), is_kf)

    def _check_scale_runaway(self, med_depth: float, vel: float = 0.0) -> bool:
        """True when median depth AND |v| both outrun their slow EMAs."""
        if med_depth <= 0:
            return False
        if self._depth_ema is None:
            self._depth_ema = med_depth
            self._vel_ema = max(vel, 0.05)
            return False
        depth_runaway = med_depth > self.DEPTH_RUNAWAY_FACTOR * self._depth_ema
        vel_runaway = vel > self.VEL_RUNAWAY_FACTOR * max(self._vel_ema, 0.05)
        self._depth_ema += self.DEPTH_EMA_RATE * (med_depth - self._depth_ema)
        self._vel_ema += self.DEPTH_EMA_RATE * (vel - self._vel_ema)
        return depth_runaway and vel_runaway

    def _finalize_tracking(self, v: np.ndarray, is_kf: bool) -> FrameResult:
        p_np, q_np = v[:3], v[3:7]
        vel, pos, med_depth = float(v[7]), float(v[8]), float(v[9])
        finite = bool(v[10] > 0.5)
        n_feat = int(v[11])
        if is_kf:
            self.window_ts[:-1] = self.window_ts[1:]
        else:
            self.window_ts[W - 2] = self.window_ts[W - 1]
        scale_runaway = self._check_scale_runaway(med_depth, vel)
        if not finite or vel > 10.0 or pos > 100.0 or scale_runaway:
            self._consecutive_failures += 1
            if self._consecutive_failures >= MAX_CONSECUTIVE_FAILURES:
                self._cooldown_remaining = COOLDOWN_FRAMES
                self.status = Status.COOLDOWN
            else:
                self._rebuild_estimator()
                self.status = Status.LOST
            return FrameResult(False, None, self.status, 0, False)
        if pos > 1e6:
            self._rebuild_estimator()
            return FrameResult(False, None, Status.LOST, 0, False)
        self._consecutive_failures = 0
        self.status = Status.TRACKING
        r_wb = _np_quat_to_rot(q_np)
        pose = np.eye(4)
        pose[:3, :3] = r_wb @ self.cfg.camera.r_ic_mat
        pose[:3, 3] = p_np + r_wb @ self.cfg.camera.t_ic_vec
        return FrameResult(True, pose, Status.TRACKING, n_feat, is_kf)

    def get_status(self) -> Status:
        return self.status

    def get_body_state(self):
        """Latest window-tip body state (p, q, v) as numpy."""
        w = self.state.window
        return (w.p[W - 1].cpu().numpy(), w.q[W - 1].cpu().numpy(),
                w.v[W - 1].cpu().numpy())
