"""VIOEngine — push-style streaming VIO API (torch twin of
mobile_slam_tpu.engine.vio_engine).

Push IMU readings and grayscale frames; each ``process_frame`` runs the
tracker and the estimator on the engine's device (the card unless the
caller passes ``device="cpu"``) and returns a 4x4 camera pose with the
status machine of the reference engine (INITIALIZING -> TRACKING,
estimator rebuilds on divergence or scale runaway, cooldown after repeated
failures). ``process_features`` is the feature-level entry point that
skips the tracker. Initialization runs on the host through the port's
numpy ``init`` stack.

While TRACKING, a frame's input reaches the device as one float32 vector
(``[ts, imu_cnt, imu_dt(M), imu_acc(3M), imu_gyr(3M)]``, plus ``[ids, obs,
uv, vel, valid]`` on the feature path), staged in pinned host memory and
copied with one ``non_blocking`` copy, and the solve's result comes back as
one (14,) float32 vector. ``enable_pipelined_streaming`` returns the pose
of the frame ``depth`` calls back, whose copy to the host was started when
it was dispatched. The keyframe flag is still read on the host each frame
(``solve_and_slide`` picks its marginalization branch there), so a
pipelined frame still synchronizes once.
"""

from __future__ import annotations

import enum
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from mobile_slam_tpu_torch.config import NUM_SLOTS, VIOConfig, validate_config
from mobile_slam_tpu_torch.init.alignment import HostFrame, NpPreintegration
from mobile_slam_tpu_torch.init.initializer import try_initialize
from mobile_slam_tpu_torch.engine import estimator as est
from mobile_slam_tpu_torch.frontend import tracker as trk
from mobile_slam_tpu_torch.models.cameras.base import make_camera
from mobile_slam_tpu_torch.models.state import eligible_mask
from mobile_slam_tpu_torch.utils import logging as slog
from mobile_slam_tpu_torch.utils import rotations as rot

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
    # Timestamp the pose belongs to (set in pipelined streaming, where a
    # call returns the pose of an earlier frame; None = this call's frame).
    ts: Optional[float] = None
    # The camera-IMU time offset (s) after this frame's solve (a tracking
    # result only; it moves only with ``estimate_td`` on).
    td: Optional[float] = None


class _PendingFrame:
    """An in-flight pipelined frame: its packed (14,) result, copied to a
    pinned host tensor with ``non_blocking=True`` at dispatch, and a CUDA
    event recorded after the copy. On the CPU the copy is plain."""

    __slots__ = ("ts", "host", "event")

    def __init__(self, packed: torch.Tensor, ts: float):
        self.ts = ts
        if packed.is_cuda:
            self.host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = packed
            self.event = None

    def resolve(self) -> np.ndarray:
        """The packed result on the host; waits for the copy's event."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy().astype(np.float64)


def _np_quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _map_points_device(table, window, ex_t, ex_q, init_depth):
    """World landmark positions and the rows worth showing: solved, in
    front, moved off the initial depth, finite."""
    good = (eligible_mask(table) & (table.solve_flag == 1) & (table.depth > 0)
            & (torch.abs(table.depth - init_depth) >= 0.01))
    start = torch.clamp(table.start, 0, W - 1).long()
    ray = torch.gather(table.obs, 1, start[:, None, None].expand(-1, 1, 3))[:, 0]
    pts_cam = ray * table.depth[:, None]
    r_wb = rot.quat_to_rot(window.q)[start]
    p_wb = window.p[start]
    r_wc = r_wb @ rot.quat_to_rot(ex_q)
    t_wc = p_wb + torch.einsum("fij,j->fi", r_wb, ex_t)
    pts_w = torch.einsum("fij,fj->fi", r_wc, pts_cam) + t_wc
    good = good & torch.all(torch.isfinite(pts_w), dim=-1)
    return pts_w, good


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

    def __init__(self, cfg: VIOConfig, dtype=torch.float32, *, device="cuda"):
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
        # N-frame-lag streaming (enable_pipelined_streaming); survives
        # reset() so a re-initialized engine keeps its streaming contract.
        self._pipelined = False
        self._pipeline_depth = 1
        self._pending: list[_PendingFrame] = []
        # EMAs (ms) of the stage spans' host durations, keyed by span name:
        # the dispatch stages' host cost, and result_wait the blocking readback.
        self.stage_ms: dict = {}
        self.reset()

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype or self.dtype, device=self.device)

    def _stage_time(self, span: slog.Span) -> None:
        dt_ms = span.seconds * 1e3
        prev = self.stage_ms.get(span.name)
        self.stage_ms[span.name] = dt_ms if prev is None else prev + 0.05 * (dt_ms - prev)

    def get_timing(self) -> dict:
        """Smoothed host durations in ms of the spans ``tracker_dispatch``,
        ``solve_dispatch`` and ``result_wait``."""
        return {k: round(v, 3) for k, v in self.stage_ms.items()}

    def reset(self) -> None:
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        self.state = est.init_state(self.cfg, self.params, self.dtype)
        self.tracker_state = trk.init_tracker_state(
            self.cfg.tracker, self.cfg.camera.height, self.cfg.camera.width,
            dtype=self.dtype, device=self.device)
        self._pending = []
        self._depth_ema: Optional[float] = None
        self._vel_ema = 0.05
        self._last_flat: Optional[torch.Tensor] = None  # last packed feature-path input
        self.status = Status.INITIALIZING
        self.frame_index = 0
        self.host_frames: list[HostFrame] = []
        self.window_ts = np.zeros(W)
        self._t0: Optional[float] = None
        self._first_frame_time: Optional[float] = None
        self._last_frame_ts: Optional[float] = None
        self._last_imu: Optional[np.ndarray] = None
        self._pending_imu: list[np.ndarray] = []
        self._consecutive_failures = 0
        self._cooldown_remaining = 0
        self._last_pose: Optional[np.ndarray] = None
        self._last_imu_tail = np.zeros(6)
        self._banned_ids = torch.full((self.cfg.estimator.max_features,), -1,
                                      dtype=torch.int32, device=self.device)
        self.params = self.params._replace(gravity=self._t(self._gravity_np))

    def _rebuild_estimator(self) -> None:
        """Estimator rebuild on failure; the tracker state survives."""
        old_td = float(self.state.td)
        if not math.isfinite(old_td):
            old_td = float(self.cfg.estimator.td_init)
        self.state = est.init_state(self.cfg, self.params, self.dtype)
        self.state = self.state._replace(td=self._t(old_td))
        self._pending = []  # in-flight pipelined frames used the old state
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
    # Packed transfers (the TRACKING hot loop)
    # ------------------------------------------------------------------

    def _upload(self, flat: np.ndarray) -> torch.Tensor:
        """One host->device copy of a packed float32 vector, from pinned
        memory and ``non_blocking`` on the card."""
        host = torch.from_numpy(flat)
        if self.device.type == "cuda":
            pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            pinned.copy_(host)
            host = pinned.to(self.device, non_blocking=True)
        return host.to(self.dtype)

    def _unflatten_imu(self, flat: torch.Tensor):
        m = self.cfg.estimator.max_imu_per_interval
        return (flat[0], flat[1].to(torch.int32), flat[2:2 + m],
                flat[2 + m:2 + 4 * m].reshape(m, 3), flat[2 + 4 * m:2 + 7 * m].reshape(m, 3))

    def _book_flat(self, state, flat: torch.Tensor):
        """bookkeeping_step on a packed feature-path input."""
        ts, cnt, dt, acc, gyr = self._unflatten_imu(flat)
        k = self.cfg.tracker.max_points
        i = 2 + 7 * self.cfg.estimator.max_imu_per_interval
        ids = torch.round(flat[i:i + k]).to(torch.int32)
        i += k
        obs = flat[i:i + 3 * k].reshape(k, 3)
        i += 3 * k
        uv = flat[i:i + 2 * k].reshape(k, 2)
        i += 2 * k
        vel = flat[i:i + 2 * k].reshape(k, 2)
        i += 2 * k
        valid = flat[i:i + k] > 0.5
        inp = est.FrameInput(ts=ts, ids=ids, obs=obs, uv=uv, vel=vel, valid=valid,
                             imu_dt=dt, imu_acc=acc, imu_gyr=gyr, imu_cnt=cnt)
        return est.bookkeeping_step(state, inp, self.params)

    def _book_dev_feat(self, state, flat: torch.Tensor, ids, obs, uv, vel, valid):
        """bookkeeping_step on a packed IMU input and the tracker's device
        outputs (image path)."""
        ts, cnt, dt, acc, gyr = self._unflatten_imu(flat)
        inp = est.FrameInput(ts=ts, ids=ids, obs=obs.to(self.dtype), uv=uv.to(self.dtype),
                             vel=vel.to(self.dtype), valid=valid, imu_dt=dt,
                             imu_acc=acc, imu_gyr=gyr, imu_cnt=cnt)
        return est.bookkeeping_step(state, inp, self.params)

    def _solve(self, state, is_kf: bool):
        """solve_and_slide with its pose and every host-gate scalar packed
        into one (14,) float32 vector: [p(3), q(4), vel, pos, med_depth,
        finite, kf, n_trk, td]."""
        state, p_out, q_out, diag = est.solve_and_slide(
            state, is_kf, self.params, self.cfg.estimator.num_iterations)
        f32 = torch.float32
        packed = torch.cat([p_out.to(f32), q_out.to(f32), torch.stack([
            diag.vel_norm.to(f32), diag.pos_norm.to(f32), diag.med_depth.to(f32),
            diag.state_finite.to(f32), diag.is_keyframe.to(f32),
            diag.last_track_num.to(f32), state.td.to(f32)])])
        return state, packed, diag

    # ------------------------------------------------------------------
    # Frame processing
    # ------------------------------------------------------------------

    def process_frame(self, image, frame_ts: float,
                      imu_override=None) -> FrameResult:
        """Full image path: track features, then run the estimator.

        imu_override: optional (dts, accs, gyrs) host arrays used instead
        of draining the engine's IMU buffer (the serving layer replays
        frames whose IMU slice a chunk already drained)."""
        with slog.span("stream_frame", request=frame_ts):
            with slog.span("tracker_dispatch") as span:
                img = self._t(np.asarray(image))
                if self._t0 is None:
                    self._t0 = frame_ts
                self.tracker_state, tout = trk.detect_and_track(
                    self.tracker_state, img, frame_ts - self._t0, self.camera,
                    self.cfg.tracker, self.cfg.camera.focal_length,
                    generator=self._gen, banned_ids=self._banned_ids)
            self._stage_time(span)
            feats = (tout.ids, tout.obs, tout.uv, tout.vel, tout.valid)
            return self._process_tracked(frame_ts, feats=feats, imu_override=imu_override)

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
            return out

        ids_p = np.full(k_pad, -1, np.int32)
        ids_p[:n] = np.asarray(ids, np.int32)
        valid_p = np.zeros(k_pad, bool)
        valid_p[:n] = True if valid is None else np.asarray(valid, bool)
        host_feat = (ids_p, pad(np.asarray(rays), (3,)),
                     pad(uv if uv is not None else np.zeros((n, 2)), (2,)),
                     pad(vel if vel is not None else np.zeros((n, 2)), (2,)), valid_p)
        return self._process_tracked(frame_ts, host_feat=host_feat)

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

    def _imu_flat(self, frame_ts, dts, accs, gyrs) -> np.ndarray:
        """[ts, imu_cnt, imu_dt(M), imu_acc(3M), imu_gyr(3M)] as float32."""
        m_pad = self.cfg.estimator.max_imu_per_interval
        m = min(len(dts), m_pad)
        flat = np.zeros(2 + 7 * m_pad, np.float32)
        flat[0] = frame_ts - self._t0
        flat[1] = m
        flat[2:2 + m] = dts[:m]
        flat[2 + m_pad:2 + m_pad + 3 * m] = np.ravel(accs[:m])
        flat[2 + 4 * m_pad:2 + 4 * m_pad + 3 * m] = np.ravel(gyrs[:m])
        return flat

    def _process_tracked(self, frame_ts, feats=None, host_feat=None,
                         imu_override=None) -> FrameResult:
        """Shared frame pipeline. Features arrive as device tensors (image
        path: the tracker's outputs) or as padded host arrays (feature path:
        ``host_feat``, packed into the one-copy input while TRACKING)."""
        if self._t0 is None:
            self._t0 = frame_ts
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

        if self.status == Status.TRACKING:
            imu_flat = self._imu_flat(frame_ts, dts, accs, gyrs)
            if host_feat is not None:
                ids_p, obs_p, uv_p, vel_p, valid_p = host_feat
                flat = np.concatenate([
                    imu_flat, ids_p.astype(np.float32), np.ravel(obs_p).astype(np.float32),
                    np.ravel(uv_p).astype(np.float32), np.ravel(vel_p).astype(np.float32),
                    valid_p.astype(np.float32)])
                self._last_flat = self._upload(flat)
                self.state, is_kf = self._book_flat(self.state, self._last_flat)
                n_track = int(valid_p.sum())
            else:
                self.state, is_kf = self._book_dev_feat(self.state, self._upload(imu_flat),
                                                        *feats)
                n_track = None  # image path: the solver's track count covers it
            self._cur_frame_ts = frame_ts  # tags the pipelined pending entry
            self.window_ts[W - 1] = frame_ts
            # The one host read of a tracking frame before its result:
            # solve_and_slide picks its marginalization branch on the host.
            result = self._process_tracking(bool(is_kf))
            if (result.status == Status.TRACKING and not self._pipelined
                    and n_track is not None):
                result = result._replace(num_features=n_track)
            self._last_frame_ts = frame_ts
            self.frame_index += 1
            return result

        if host_feat is not None:
            ids_p, obs_p, uv_p, vel_p, valid_p = host_feat
            feats = (torch.as_tensor(ids_p, device=self.device), self._t(obs_p),
                     self._t(uv_p), self._t(vel_p), torch.as_tensor(valid_p, device=self.device))
        inp = self._frame_input(frame_ts, feats, dts, accs, gyrs)
        self.state, is_kf = est.bookkeeping_step(self.state, inp, self.params)
        is_kf = bool(is_kf)
        self._cur_frame_ts = frame_ts
        fc = int(self.state.frame_count)
        self.window_ts[min(fc, W - 1)] = frame_ts
        result = self._process_initializing(inp, is_kf, frame_ts, dts, accs, gyrs)
        self._last_frame_ts = frame_ts
        self.frame_index += 1
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
        with slog.span("solve_dispatch") as span:
            self.state, packed, diag = self._solve(self.state, is_kf)
        self._stage_time(span)
        # The outlier ban reaches the tracker device to device.
        self._banned_ids = diag.culled_ids
        if not self._pipelined:
            return self._finalize_tracking(packed)
        # N-frame lag: start this frame's result on its way to the host and
        # return the pose of the frame `depth` calls back.
        self._pending.append(_PendingFrame(packed, self._cur_frame_ts))
        if len(self._pending) <= self._pipeline_depth:
            return FrameResult(False, self._last_pose, Status.TRACKING, 0, False)
        return self._finalize_tracking(self._pending.pop(0))

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

    def enable_pipelined_streaming(self, on: bool = True, depth: int = 1) -> None:
        """Toggle N-frame-lag streaming: each TRACKING call returns the pose
        of the frame ``depth`` calls back (``FrameResult.ts`` names it);
        ``flush_all()`` drains the frames still in flight. Failure gates
        also see the state ``depth`` frames late."""
        if not on:
            self.flush_all()
        self._pipelined = on
        self._pipeline_depth = max(1, int(depth))

    def measure_device_step(self, n: int = 50) -> Optional[float]:
        """ms per TRACKING step (bookkeeping + solve) on the last packed
        feature-path input, re-dispatched ``n`` times from the engine's
        state with one synchronize at the end; the engine's state is left
        as it was. None before TRACKING or without a packed frame. The
        step's own host reads (the keyframe flag, the solver's) are inside
        the time."""
        if self._last_flat is None or self.status != Status.TRACKING:
            return None

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        st, kf = self._book_flat(self.state, self._last_flat)
        self._solve(st, bool(kf))
        sync()
        st = self.state
        t0 = time.perf_counter()
        for _ in range(n):
            st, kf = self._book_flat(st, self._last_flat)
            st, _, _ = self._solve(st, bool(kf))
        sync()
        return 1e3 * (time.perf_counter() - t0) / n

    def flush(self) -> Optional[FrameResult]:
        """Drain every in-flight pipelined frame; the last one's result."""
        results = self.flush_all()
        return results[-1] if results else None

    def flush_all(self) -> list:
        """Finalize every in-flight pipelined frame, in dispatch order."""
        pending, self._pending = self._pending, []
        out = []
        for prev in pending:
            out.append(self._finalize_tracking(prev))
            # A gate trip rebuilt the estimator; later pending frames were
            # dispatched against the discarded state: drop them.
            if self.status != Status.TRACKING:
                break
        return out

    def _finalize_tracking(self, packed, ts: Optional[float] = None) -> FrameResult:
        with slog.span("result_wait") as span:
            if isinstance(packed, _PendingFrame):
                ts = packed.ts
                v = packed.resolve()
            else:
                v = packed.cpu().numpy().astype(np.float64)
        self._stage_time(span)
        p_np, q_np = v[:3], v[3:7]
        vel, pos, med_depth = float(v[7]), float(v[8]), float(v[9])
        finite = bool(v[10] > 0.5)
        is_kf = bool(v[11] > 0.5)
        n_feat = int(v[12])
        td = float(v[13])
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
        self._last_pose = pose
        return FrameResult(True, pose, Status.TRACKING, n_feat, is_kf, ts=ts, td=td)

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    def is_initialized(self) -> bool:
        return self.status == Status.TRACKING

    def get_status(self) -> Status:
        return self.status

    def get_map_points(self) -> np.ndarray:
        """(N, 3) world landmarks of the window (none before TRACKING)."""
        if self.status != Status.TRACKING:
            return np.zeros((0, 3))
        pts, good = _map_points_device(self.state.table, self.state.window,
                                       self.params.ex_t, self.params.ex_q,
                                       self.params.init_depth)
        return pts.cpu().numpy()[good.cpu().numpy()]

    def get_tracked_points(self):
        """The active tracker slots for the overlay view: (pixel positions
        (N, 2), track lengths (N,))."""
        ts = self.tracker_state
        act = ts.active.cpu().numpy()
        return ts.pts.cpu().numpy()[act], ts.track_cnt.cpu().numpy()[act]

    def get_body_state(self):
        """Latest window-tip body state (p, q, v) as numpy."""
        w = self.state.window
        return (w.p[W - 1].cpu().numpy(), w.q[W - 1].cpu().numpy(),
                w.v[W - 1].cpu().numpy())
