"""VIOSystem — dataset-driven pull-mode pipeline (torch twin of
mobile_slam_tpu.engine.vio_system).

Reads an EuRoC-layout sequence, drives the port's engine frame by frame
with frame_skip/start/end windowing, logs the camera trajectory in TUM
format, and evaluates ATE/RPE against the mocap ground truth at the end of
the sequence. The engine runs on the card unless the system is given
``device="cpu"``; there is no fallback to the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from mobile_slam_tpu_torch.config import VIOConfig
from mobile_slam_tpu_torch.engine import checkpoint as ckpt
from mobile_slam_tpu_torch.engine.vio_engine import Status, VIOEngine
from mobile_slam_tpu_torch.eval.evaluator import compute_ate, compute_rpe
from mobile_slam_tpu_torch.io import png
from mobile_slam_tpu_torch.io.dataset import EurocDataset
from mobile_slam_tpu_torch.io.trajectory import ResultLogger
from mobile_slam_tpu_torch.utils import rotations as rot


@dataclasses.dataclass
class RunSummary:
    frames_processed: int
    poses_recovered: int
    wall_seconds: float
    fps: float
    ate_rmse: float | None = None
    ate_median: float | None = None
    rpe_trans_rmse: float | None = None
    log_dir: str | None = None


def _rot_to_quat(r: np.ndarray) -> np.ndarray:
    return rot.rot_to_quat(torch.as_tensor(r, dtype=torch.float64)).numpy()


class VIOSystem:
    # Live-view artifact cadence (frames): live.json (map points, IMU
    # window, status, stage times) and frame.png land in the run directory
    # for web/server.py + web/viewer.html to poll.
    LIVE_EVERY = 20
    PROGRESS_EVERY = 100     # frames between progress lines on stderr
    IMU_WINDOW_S = 5.0

    def __init__(self, cfg: VIOConfig, dataset_root: str | None = None,
                 log_root: str = "logs", config_blob: str | None = None,
                 pipelined: bool = False, checkpoint_path: str | None = None,
                 checkpoint_every: int = 200,
                 resume_path: str | None = None, device="cuda"):
        self.cfg = cfg
        self.dataset = EurocDataset(dataset_root or cfg.dataset_path)
        self.engine = VIOEngine(cfg, device=device)
        self.logger = ResultLogger(log_root, config_blob)
        self._imu_window: list[tuple] = []
        # One-frame-lag streaming (poses come back tagged with res.ts),
        # enabled once tracking starts.
        self.pipelined = pipelined
        # Snapshot every checkpoint_every frames once TRACKING; a resume
        # restores the engine and skips the inputs it already consumed.
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        self.resume_path = resume_path

    def _write_live(self, status: Status, frames: int, poses: int,
                    img: np.ndarray | None = None) -> None:
        pts = self.engine.get_map_points()
        uv, cnt = self.engine.get_tracked_points()
        tracks = {"uv": np.asarray(uv, float).round(1).tolist(),
                  "cnt": np.asarray(cnt, int).tolist()}
        if img is not None:
            tmp = os.path.join(self.logger.dir, ".tmp_frame.png")
            png.write_png(tmp, np.asarray(img, np.uint8))
            os.replace(tmp, os.path.join(self.logger.dir, "frame.png"))
        payload = {
            "status": status.name,
            "frames": frames,
            "poses": poses,
            "map_points": np.asarray(pts, float).round(4).tolist(),
            "imu": {
                "ts": [round(s[0], 4) for s in self._imu_window],
                "acc": [[round(v, 4) for v in s[1]] for s in self._imu_window],
                "gyr": [[round(v, 5) for v in s[2]] for s in self._imu_window],
            },
            # Engine tracing hooks: per-stage host wall-time EMAs (ms).
            "stage_ms": self.engine.get_timing(),
            "tracks": tracks,
        }
        tmp = os.path.join(self.logger.dir, ".live.json.tmp")
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, os.path.join(self.logger.dir, "live.json"))

    def process_sequence(self, progress_every: int = PROGRESS_EVERY) -> RunSummary:
        cfg = self.cfg
        ds = self.dataset
        n = len(ds)
        start = max(cfg.start_frame, 0)
        end = n if cfg.end_frame < 0 else min(cfg.end_frame, n)
        stride = cfg.frame_skip + 1

        imu_i = 0
        if self.resume_path:
            ckpt.load_engine(self.resume_path, self.engine)
            last_ts = self.engine._last_frame_ts
            # Skip the inputs the saved engine already consumed: frames up
            # to and including the checkpointed one, and IMU samples up to
            # the last one drained or still pending in the restored queue.
            while start < end and ds.images.ts[start] <= last_ts + 1e-12:
                start += stride
            imu_seen = max([last_ts] + [s[0] for s in self.engine._pending_imu])
            while imu_i < len(ds.imu.ts) and ds.imu.ts[imu_i] <= imu_seen + 1e-12:
                imu_i += 1
            print(f"[vio] resumed from {self.resume_path} at frame {start} "
                  f"(status={self.engine.status.name})", file=sys.stderr)
        t_wall = time.time()
        frames = poses = 0
        est_ts, est_p, est_q = [], [], []

        def log_pose(pose_ts, pose):
            self.logger.add_pose(pose_ts, pose[:3, 3], _rot_to_quat(pose[:3, :3]))
            est_ts.append(pose_ts)
            est_p.append(pose[:3, 3])
            est_q.append(pose[:3, :3].copy())

        for idx in range(start, end, stride):
            ts = ds.images.ts[idx]
            while imu_i < len(ds.imu.ts) and ds.imu.ts[imu_i] <= ts + 1e-12:
                self.engine.push_imu(ds.imu.ts[imu_i], ds.imu.acc[imu_i], ds.imu.gyr[imu_i])
                self._imu_window.append((float(ds.imu.ts[imu_i]), ds.imu.acc[imu_i].tolist(),
                                         ds.imu.gyr[imu_i].tolist()))
                imu_i += 1
            while self._imu_window and self._imu_window[0][0] < ts - self.IMU_WINDOW_S:
                self._imu_window.pop(0)
            img = ds.read_image(idx)
            res = self.engine.process_frame(img, ts)
            if (self.pipelined and not self.engine._pipelined
                    and res.status == Status.TRACKING):
                self.engine.enable_pipelined_streaming(True)
            frames += 1
            if res.ok and res.pose is not None:
                poses += 1
                # The CAMERA pose in TUM format (the evaluator transforms
                # back to the body); pipelined, it belongs to res.ts.
                log_pose(res.ts if res.ts is not None else ts, res.pose)
            if progress_every and frames % progress_every == 0:
                print(f"[vio] frame {idx}/{end} status={res.status.name} "
                      f"poses={poses}", file=sys.stderr)
            if frames % self.LIVE_EVERY == 0:
                self._write_live(res.status, frames, poses, img=img)
            if (self.checkpoint_path and res.status == Status.TRACKING
                    and not self.engine._pipelined
                    and frames % self.checkpoint_every == 0):
                ckpt.save_engine(self.checkpoint_path, self.engine)
                print(f"[vio] checkpoint -> {self.checkpoint_path} (frame {idx})",
                      file=sys.stderr)

        if (self.checkpoint_path and not self.engine._pipelined
                and self.engine.status == Status.TRACKING):
            ckpt.save_engine(self.checkpoint_path, self.engine)
            print(f"[vio] final checkpoint -> {self.checkpoint_path}", file=sys.stderr)

        for tail in self.engine.flush_all():
            if tail.ok and tail.pose is not None:
                poses += 1
                log_pose(tail.ts, tail.pose)

        wall = time.time() - t_wall
        summary = RunSummary(frames_processed=frames, poses_recovered=poses,
                             wall_seconds=wall, fps=frames / max(wall, 1e-9),
                             log_dir=self.logger.dir)
        self.logger.flush()

        if ds.ground_truth is not None and poses > 10:
            gt = ds.ground_truth
            est_ts_np = np.asarray(est_ts)
            # Camera -> body (transformVioToBodyFrame).
            r_ic = cfg.camera.r_ic_mat
            t_ic = cfg.camera.t_ic_vec
            body_p = np.asarray([p - (R @ r_ic.T) @ (r_ic.T @ t_ic)
                                 for p, R in zip(est_p, est_q)])
            ate = compute_ate(est_ts_np, body_p, gt.ts, gt.p, with_scale=True)
            gt_R = rot.quat_to_rot(torch.as_tensor(gt.q, dtype=torch.float64)).numpy()
            est_R = np.asarray([R @ r_ic.T for R in est_q])
            rpe = compute_rpe(est_ts_np, body_p, est_R, gt.ts, gt.p, gt_R, delta=1.0)
            summary.ate_rmse = ate.rmse
            summary.ate_median = ate.median
            summary.rpe_trans_rmse = rpe.trans_rmse
            self.logger.save_evaluation({
                "ate_rmse_m": ate.rmse, "ate_mean_m": ate.mean,
                "ate_median_m": ate.median, "ate_std_m": ate.std,
                "ate_min_m": ate.min, "ate_max_m": ate.max,
                "rpe_trans_rmse_m": rpe.trans_rmse,
                "rpe_rot_rmse_deg": rpe.rot_rmse_deg,
                "poses": poses, "frames": frames, "fps": summary.fps,
            })
            # Plots need matplotlib; a machine without it skips them.
            try:
                self._save_plots(body_p, est_ts_np, gt)
            except ImportError as exc:
                print(f"[vio] plot generation skipped: {exc}", file=sys.stderr)
        return summary

    def _save_plots(self, body_p, est_ts, gt) -> None:
        """trajectory.png (SIM3-aligned vs mocap) + error.png (per-pose
        translation error over time) in logs/<ts>/."""
        from mobile_slam_tpu_torch.eval.evaluator import associate, umeyama_alignment
        from mobile_slam_tpu_torch.eval.visualizer import _mpl, plot_trajectory_3d

        ia, ib = associate(est_ts, gt.ts)
        if len(ia) < 3:
            return
        s, R, t = umeyama_alignment(body_p[ia], gt.p[ib])
        aligned = s * (body_p[ia] @ R.T) + t
        fig = plot_trajectory_3d(
            aligned, gt_positions=gt.p[ib],
            save=os.path.join(self.logger.dir, "trajectory.png"),
            title="VIO vs ground truth (SIM3-aligned)")
        plt = _mpl(True)
        plt.close(fig)
        err = np.linalg.norm(aligned - gt.p[ib], axis=1)
        fig2, ax = plt.subplots(figsize=(8, 3))
        ax.plot(est_ts[ia] - est_ts[ia][0], err, lw=1.0)
        ax.set_xlabel("t [s]")
        ax.set_ylabel("translation error [m]")
        ax.set_title(f"ATE per pose (rmse {np.sqrt(np.mean(err**2)):.3f} m)")
        fig2.savefig(os.path.join(self.logger.dir, "error.png"), dpi=130,
                     bbox_inches="tight")
        plt.close(fig2)
