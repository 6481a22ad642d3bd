"""Offline trajectory evaluation with optional plots.

Loads a logs/<ts>/ run directory (TUM trajectory and the run's config
copy) or a TUM file, and a ground-truth CSV (EuRoC); applies the
camera-to-body transform when the run's config is there, associates by
timestamp, aligns with Umeyama Sim(3), and prints ATE and RPE at 1 s and
5 s, as the repo's scripts/evaluation/compare_trajectories.py prints them.
Matplotlib is imported only to save or show the plots; without it,
``--save`` fails with a message saying so.

    python -m mobile_slam_tpu_torch.tools.compare_trajectories logs/<ts> \\
        --gt data/.../mocap0/data.csv [--save out.png] [--no-display]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mobile_slam_tpu_torch.config import load_config
from mobile_slam_tpu_torch.eval.evaluator import (associate, compute_ate, compute_rpe,
                                                  umeyama_alignment)
from mobile_slam_tpu_torch.io.dataset import load_ground_truth_csv
from mobile_slam_tpu_torch.io.trajectory import read_tum


def quat_to_rot_np(q):
    """(..., 4) wxyz quaternions -> (..., 3, 3) rotation matrices."""
    w, x, y, z = np.moveaxis(np.asarray(q, float), -1, 0)
    r = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return r.reshape(np.asarray(q).shape[:-1] + (3, 3))


def _plot(p, gt, ts, ate_rmse, args, display):
    try:
        import matplotlib
    except ImportError:
        if args.save:
            sys.exit(f"--save {args.save}: matplotlib is not installed, so no plot is drawn")
        print("no display: matplotlib is not installed", file=sys.stderr)
        return
    if not display:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ia, ib = associate(ts, gt.ts, args.max_diff)
    s, R, t = umeyama_alignment(p[ia], gt.p[ib])
    aligned = s * (p[ia] @ R.T) + t
    fig = plt.figure(figsize=(12, 5))
    ax = fig.add_subplot(121, projection="3d")
    ax.plot(*gt.p[ib].T, label="ground truth", lw=1)
    ax.plot(*aligned.T, label="VIO (aligned)", lw=1)
    ax.legend()
    ax.set_title("3D trajectory")
    ax2 = fig.add_subplot(122)
    ax2.plot(gt.p[ib][:, 0], gt.p[ib][:, 1], label="gt", lw=1)
    ax2.plot(aligned[:, 0], aligned[:, 1], label="vio", lw=1)
    ax2.axis("equal")
    ax2.legend()
    ax2.set_title(f"top view — ATE rmse {ate_rmse:.3f} m")
    if args.save:
        fig.savefig(args.save, dpi=130, bbox_inches="tight")
        print(f"saved plot to {args.save}")
    if display:
        plt.show()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir", help="logs/<ts>/ directory or TUM file")
    ap.add_argument("--gt", required=True, help="ground-truth CSV (EuRoC)")
    ap.add_argument("--save", default=None)
    ap.add_argument("--no-display", action="store_true")
    ap.add_argument("--max-diff", type=float, default=0.01)
    args = ap.parse_args(argv)

    traj_path = args.run_dir
    cfg = None
    if os.path.isdir(args.run_dir):
        traj_path = os.path.join(args.run_dir, "trajectory_pose.txt")
        cfg_path = os.path.join(args.run_dir, "config.yaml")
        if os.path.exists(cfg_path):
            cfg = load_config(cfg_path)

    ts, p_cam, q_cam = read_tum(traj_path)
    gt = load_ground_truth_csv(args.gt)

    # Camera -> body transform when the run's config (extrinsics) is known.
    if cfg is not None:
        R_wb = quat_to_rot_np(q_cam) @ cfg.camera.r_ic_mat.T
        p = p_cam - np.einsum("nij,j->ni", R_wb, cfg.camera.t_ic_vec)
        est_R = R_wb
    else:
        p = p_cam
        est_R = quat_to_rot_np(q_cam)

    ate = compute_ate(ts, p, gt.ts, gt.p, with_scale=True, max_diff=args.max_diff)
    gt_R = quat_to_rot_np(gt.q)
    print(f"ATE: rmse {ate.rmse:.4f} m  mean {ate.mean:.4f}  median "
          f"{ate.median:.4f}  std {ate.std:.4f}  max {ate.max:.4f}  "
          f"(n={ate.num_pairs})")
    for delta in (1.0, 5.0):
        rpe = compute_rpe(ts, p, est_R, gt.ts, gt.p, gt_R, delta=delta,
                          max_diff=args.max_diff)
        print(f"RPE d={delta:.0f}s: trans rmse {rpe.trans_rmse:.4f} m  "
              f"rot rmse {rpe.rot_rmse_deg:.3f} deg  (n={rpe.num_pairs})")

    display = not args.no_display and bool(os.environ.get("DISPLAY"))
    if args.save or display:
        _plot(p, gt, ts, ate.rmse, args, display)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
