"""Write a synthetic EuRoC-layout sequence from the port's simulation (the
torch port's counterpart of scripts/make_synthetic_dataset.py).

Writes ``<out>/mav0/{cam0,imu0,mocap0}``: rendered 8-bit PNG frames (the
port's own encoder, no OpenCV), the IMU CSV and the ground-truth CSV, with
the same ``SimConfig``, CSV headers and 1.4e9 s epoch as the reference
script, so the file-driven entry point (``python -m
mobile_slam_tpu_torch.cli``) runs without a download.

    python -m mobile_slam_tpu_torch.io.synthetic --out DIR --duration S [--seed 7] [--noise]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from mobile_slam_tpu_torch.config import load_config
from mobile_slam_tpu_torch.eval import simulation as sim
from mobile_slam_tpu_torch.io import png
from mobile_slam_tpu_torch.models.cameras.base import make_camera

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "tum_vi_room1.yaml")
T_EPOCH = 1.4e9  # a realistic absolute epoch, seconds


def sim_config(duration: float, seed: int = 7, noise: bool = False) -> sim.SimConfig:
    kw = {}
    if noise:
        kw = dict(acc_noise=0.02, gyr_noise=0.002, acc_bias=(0.01, -0.005, 0.015),
                  gyr_bias=(0.001, -0.0005, 0.0008))
    return sim.SimConfig(duration=duration, num_landmarks=900, max_features=150,
                         seed=seed, **kw)


def write_sequence(out: str, scfg: sim.SimConfig) -> sim.SimData:
    """Simulate ``scfg`` with the camera of configs/tum_vi_room1.yaml and
    write the sequence under ``out``; returns the simulation."""
    cfg = load_config(CONFIG)
    cam = make_camera(cfg.camera, dtype=torch.float64, device="cpu")
    data = sim.simulate(scfg, cam, cfg.camera.r_ic_mat, cfg.camera.t_ic_vec)

    base = os.path.join(out, "mav0")
    for sub in (os.path.join("cam0", "data"), "imu0", "mocap0"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)

    def ns(t):
        return int(round((T_EPOCH + t) * 1e9))

    with open(os.path.join(base, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for i in range(len(data.imu_ts)):
            g, a = data.imu_gyr[i], data.imu_acc[i]
            f.write(f"{ns(data.imu_ts[i])},{g[0]},{g[1]},{g[2]},{a[0]},{a[1]},{a[2]}\n")

    with open(os.path.join(base, "mocap0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],px,py,pz,qw,qx,qy,qz\n")
        for i in range(len(data.cam_ts)):
            p, q = data.gt_p[i], data.gt_q[i]
            f.write(f"{ns(data.cam_ts[i])},{p[0]},{p[1]},{p[2]},"
                    f"{q[0]},{q[1]},{q[2]},{q[3]}\n")

    with open(os.path.join(base, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for fi in range(len(data.cam_ts)):
            t_ns = ns(data.cam_ts[fi])
            img = sim.render_frame(data, fi, cam, cfg.camera.r_ic_mat, cfg.camera.t_ic_vec)
            png.write_png(os.path.join(base, "cam0", "data", f"{t_ns}.png"), img)
            f.write(f"{t_ns},{t_ns}.png\n")
            if fi % 50 == 0:
                print(f"rendered {fi}/{len(data.cam_ts)}", file=sys.stderr)
    return data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--duration", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--noise", action="store_true", help="add IMU noise/biases")
    args = ap.parse_args(argv)
    data = write_sequence(args.out, sim_config(args.duration, args.seed, args.noise))
    print(f"dataset written to {args.out} "
          f"({len(data.cam_ts)} frames, {len(data.imu_ts)} IMU samples)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
