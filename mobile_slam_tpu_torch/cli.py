"""Command-line entry point of the torch port (twin of mobile_slam_tpu.cli):
load and validate a YAML config, run the dataset sequence through
VIOSystem, print the evaluation.

    python -m mobile_slam_tpu_torch.cli <config.yaml> [--cpu] [--frames=N]
        [--pipelined] [--checkpoint=PATH] [--checkpoint-every=N] [--resume=PATH]

The run is on the card; ``--cpu`` runs it on the CPU. Without ``--cpu`` on
a machine with no card it raises: it does not fall back.
"""

from __future__ import annotations

import sys

USAGE = ("usage: python -m mobile_slam_tpu_torch.cli <config.yaml> [--cpu] "
         "[--frames=N] [--pipelined] [--checkpoint=PATH] [--checkpoint-every=N] "
         "[--resume=PATH]")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(USAGE, file=sys.stderr)
        return 2

    from mobile_slam_tpu_torch.config import load_config, validate_config
    from mobile_slam_tpu_torch.engine.vio_system import VIOSystem

    cfg_path = argv[0]
    cfg = load_config(cfg_path)
    problems = validate_config(cfg)
    if problems:
        print(f"invalid config: {problems}", file=sys.stderr)
        return 1
    ckpt_path = resume_path = None
    ckpt_every = 200
    for a in argv:
        if a.startswith("--frames="):
            cfg = cfg.replace(end_frame=int(a.split("=")[1]))
        elif a.startswith("--checkpoint="):
            ckpt_path = a.split("=", 1)[1]
        elif a.startswith("--checkpoint-every="):
            ckpt_every = int(a.split("=")[1])
        elif a.startswith("--resume="):
            resume_path = a.split("=", 1)[1]
    pipelined = "--pipelined" in argv
    if pipelined and ckpt_path:
        print("[cli] warning: --checkpoint is not written under --pipelined "
              "(snapshots are taken only between synchronous frames)", file=sys.stderr)

    print(f"[cli] dataset: {cfg.dataset_path}", file=sys.stderr)
    print(f"[cli] camera: {cfg.camera.model_type} "
          f"{cfg.camera.width}x{cfg.camera.height} "
          f"focal={cfg.camera.focal_length:.1f}", file=sys.stderr)

    with open(cfg_path) as f:
        blob = f.read()
    system = VIOSystem(cfg, config_blob=blob, pipelined=pipelined,
                       checkpoint_path=ckpt_path, checkpoint_every=ckpt_every,
                       resume_path=resume_path,
                       device="cpu" if "--cpu" in argv else "cuda")
    print(f"[cli] device: {system.engine.device}", file=sys.stderr)
    s = system.process_sequence()
    print(f"[cli] {s.poses_recovered}/{s.frames_processed} poses, "
          f"{s.fps:.1f} fps, log: {s.log_dir}", file=sys.stderr)
    if s.ate_rmse is not None:
        print(f"[cli] ATE RMSE {s.ate_rmse:.4f} m  median "
              f"{s.ate_median:.4f} m  RPE(1s) {s.rpe_trans_rmse:.4f} m",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
