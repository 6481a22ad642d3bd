"""Offline visualization, the port's copy of
mobile_slam_tpu.eval.visualizer: the reference's Pangolin viewer
(src/utility/visualizer.cpp: trajectory, camera frustum) and its IMU
time-series graph rendered to a matplotlib figure or PNG, and a run
directory's trajectory (``plot_run_dir``). matplotlib is imported at the
first plot. ``VIOSystem._save_plots`` draws with it; on a
machine without matplotlib the run skips its plots.
"""

from __future__ import annotations

import numpy as np


def _mpl(no_display: bool):
    import matplotlib
    import os

    if no_display or not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory_3d(
    positions: np.ndarray,            # (N, 3)
    map_points: np.ndarray | None = None,   # (M, 3)
    gt_positions: np.ndarray | None = None,
    camera_pose: np.ndarray | None = None,  # 4x4 for the frustum
    save: str | None = None,
    no_display: bool = True,
    title: str = "VIO trajectory",
):
    """Trajectory + map-point cloud + camera frustum (Visualizer parity)."""
    plt = _mpl(no_display)
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot(*np.asarray(positions).T, lw=1.2, label="VIO")
    if gt_positions is not None:
        ax.plot(*np.asarray(gt_positions).T, lw=1.0, alpha=0.7,
                label="ground truth")
    if map_points is not None and len(map_points):
        mp = np.asarray(map_points)
        ax.scatter(mp[:, 0], mp[:, 1], mp[:, 2], s=2, alpha=0.4,
                   label=f"map ({len(mp)} pts)")
    if camera_pose is not None:
        _draw_frustum(ax, np.asarray(camera_pose))
    ax.set_title(title)
    ax.legend()
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    if save:
        fig.savefig(save, dpi=130, bbox_inches="tight")
    return fig


def _draw_frustum(ax, pose, scale=0.15):
    corners = np.array([
        [0, 0, 0], [1, 0.6, 1.5], [-1, 0.6, 1.5],
        [0, 0, 0], [1, -0.6, 1.5], [-1, -0.6, 1.5],
        [0, 0, 0],
    ]) * scale
    pts = corners @ pose[:3, :3].T + pose[:3, 3]
    ax.plot(*pts.T, lw=1.0, color="red")


def plot_imu_series(
    ts: np.ndarray, acc: np.ndarray, gyr: np.ndarray,
    save: str | None = None, no_display: bool = True,
):
    """Accelerometer/gyroscope time series (IMUGraphVisualizer parity)."""
    plt = _mpl(no_display)
    fig, (a1, a2) = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    for i, lbl in enumerate("xyz"):
        a1.plot(ts, np.asarray(acc)[:, i], lw=0.7, label=f"acc {lbl}")
        a2.plot(ts, np.asarray(gyr)[:, i], lw=0.7, label=f"gyr {lbl}")
    a1.set_ylabel("m/s²")
    a2.set_ylabel("rad/s")
    a2.set_xlabel("t [s]")
    a1.legend(ncol=3)
    a2.legend(ncol=3)
    a1.set_title("IMU")
    if save:
        fig.savefig(save, dpi=130, bbox_inches="tight")
    return fig


def plot_run_dir(run_dir: str, gt_csv: str | None = None,
                 save: str | None = None):
    """Visualize a logs/<ts>/ run directory's trajectory (and the ground
    truth of an EuRoC ``data.csv``)."""
    from mobile_slam_tpu_torch.io.trajectory import read_tum

    ts, p, q = read_tum(f"{run_dir}/trajectory_pose.txt")
    gt_p = None
    if gt_csv:
        from mobile_slam_tpu_torch.io.dataset import load_ground_truth_csv

        gt_p = load_ground_truth_csv(gt_csv).p
    return plot_trajectory_3d(p, gt_positions=gt_p, save=save)
