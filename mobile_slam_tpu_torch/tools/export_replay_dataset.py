"""Export a synthetic sequence as a browser-servable replay dataset.

Writes rendered frames (8-bit grayscale PNG, ``frames/NNNNN.png``), the
IMU CSV (``imu.csv``) and ``manifest.json`` under ``out_dir``: the files
``web/test-replay.html`` replays through the viewer server's ``--data``,
with the manifest keys and values of the repo's
scripts/export_replay_dataset.py. That script writes PGM where OpenCV is
missing; this one always writes PNG (io/png.py), and the manifest names
the files written.

    python -m mobile_slam_tpu_torch.tools.export_replay_dataset out_dir \\
        [--duration=20] [--size=256]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from mobile_slam_tpu_torch.config import CameraConfig
from mobile_slam_tpu_torch.eval import simulation as sim
from mobile_slam_tpu_torch.io import png
from mobile_slam_tpu_torch.models.cameras.base import make_camera

R_IC = np.array([[0.0, 0.0, 1.0],
                 [-1.0, 0.0, 0.0],
                 [0.0, -1.0, 0.0]])
T_IC = np.array([0.045, 0.073, -0.044])


def _flag(argv, name, default):
    return next((a.split("=")[1] for a in argv if a.startswith(f"--{name}=")), default)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    out = argv[0] if argv else "data/replay"
    duration = float(_flag(argv, "duration", 20.0))
    size = int(_flag(argv, "size", 256))
    os.makedirs(os.path.join(out, "frames"), exist_ok=True)

    scale = size / 512.0
    cam_cfg = CameraConfig(
        model_type="KANNALA_BRANDT", width=size, height=size,
        focal_length=190.97847715128717 * scale,
        fx=190.97847715128717 * scale, fy=190.9733070521226 * scale,
        cx=254.93170605935475 * scale, cy=256.8974428996504 * scale,
        dist=(0.0034823894022493434, 0.0007150348452162257,
              -0.0020532361418706202, 0.00020293673591811182),
        r_ic=tuple(R_IC.reshape(-1)), t_ic=tuple(T_IC),
    )
    cam = make_camera(cam_cfg, torch.float64, device="cpu")
    scfg = sim.SimConfig(duration=duration, cam_rate=20.0, imu_rate=200.0,
                         num_landmarks=900, max_features=150,
                         acc_noise=0.02, gyr_noise=0.002,
                         acc_bias=(0.01, -0.005, 0.015),
                         gyr_bias=(0.001, -0.0005, 0.0008), seed=7)
    data = sim.simulate(scfg, cam, R_IC, T_IC)

    frames = []
    for fi in range(len(data.frames)):
        img = sim.render_frame(data, fi, cam, R_IC, T_IC)
        name = f"frames/{fi:05d}.png"
        png.write_png(os.path.join(out, name), img)
        frames.append({"ts": round(float(data.cam_ts[fi]), 6), "file": name})
        if fi % 50 == 0:
            print(f"  rendered {fi}/{len(data.frames)}", file=sys.stderr)

    with open(os.path.join(out, "imu.csv"), "w") as f:
        f.write("#ts,ax,ay,az,gx,gy,gz\n")
        for i in range(len(data.imu_ts)):
            a, g = data.imu_acc[i], data.imu_gyr[i]
            f.write(f"{data.imu_ts[i]:.6f},{a[0]:.6f},{a[1]:.6f},{a[2]:.6f},"
                    f"{g[0]:.6f},{g[1]:.6f},{g[2]:.6f}\n")

    manifest = {
        "name": f"synthetic room ({duration:.0f}s, {size}x{size} fisheye)",
        "frames": frames,
        "imu_csv": "imu.csv",
        "profile": "tum_vi",
        "config": {
            "camera": {
                "model_type": "KANNALA_BRANDT",
                "width": size, "height": size,
                "focal_length": cam_cfg.focal_length,
                "fx": cam_cfg.fx, "fy": cam_cfg.fy,
                "cx": cam_cfg.cx, "cy": cam_cfg.cy,
                "dist": list(cam_cfg.dist),
                "r_ic": list(R_IC.reshape(-1)),
                "t_ic": list(T_IC),
            },
            "tracker": {"max_cnt": 120, "min_dist": max(10, int(20 * scale)),
                        "fisheye": True, "max_points": 160},
        },
        "ground_truth": [
            {"ts": round(float(t), 6), "p": [round(float(v), 5) for v in p]}
            for t, p in zip(data.cam_ts, data.gt_p)
        ],
    }
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    print(f"exported {len(frames)} frames to {out}/ (serve: python -m "
          f"mobile_slam_tpu_torch.web.server --run logs/x --data {out})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
