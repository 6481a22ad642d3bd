"""Where the image path synchronizes the host with the card.

Runs ``ChunkedImageServer`` on the bench configuration and sequence with
``torch.cuda.set_sync_debug_mode("warn")`` around one streaming TRACKING
frame and around one whole chunk, and prints the synchronizing call sites
(the innermost three frames of this package on the stack) with their
counts. Each sync stalls the host until the card drains and rules out
capturing the frame in a CUDA graph.

    python -m mobile_slam_tpu_torch.probes.sync_sites [--chunk 5]
"""

from __future__ import annotations

import argparse
import collections
import traceback
import warnings

import torch

from mobile_slam_tpu_torch.engine import example
from mobile_slam_tpu_torch.engine.serving import ChunkedImageServer
from mobile_slam_tpu_torch.engine.vio_engine import Status, set_full_precision
from mobile_slam_tpu_torch.eval import simulation as sim
from mobile_slam_tpu_torch.models.cameras.base import make_camera


class SyncSites:
    """Counts host synchronizations by call site while active."""

    def __init__(self):
        self.sites = collections.Counter()

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if "mobile_slam_tpu_torch" in f.filename]
        self.sites[" <- ".join(
            f"{f.filename.split('mobile_slam_tpu_torch/')[-1]}:{f.lineno}"
            for f in reversed(stack[-3:]))] += 1

    def __enter__(self):
        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._ctx.__exit__(*exc)


def run(device="cuda", chunk: int = 5, seconds: float = 4.0) -> dict:
    """{"stream": Counter of one streaming TRACKING frame, "chunk": Counter
    of one chunk of ``chunk`` frames}."""
    set_full_precision()
    cfg = example.bench_config()
    cam = make_camera(cfg.camera, dtype=torch.float64, device="cpu")
    data = sim.simulate(example.bench_sim_config(seconds), cam, cfg.camera.r_ic_mat,
                        cfg.camera.t_ic_vec)
    server = ChunkedImageServer(cfg, device=device, chunk_size=chunk, stable_frames=4)
    out, imu_i = {}, 0
    for fi in range(len(data.frames)):
        ts = data.cam_ts[fi]
        while imu_i < len(data.imu_ts) and data.imu_ts[imu_i] <= ts + 1e-9:
            server.push_imu(data.imu_ts[imu_i], data.imu_acc[imu_i], data.imu_gyr[imu_i])
            imu_i += 1
        img = sim.render_frame(data, fi, cam, example.R_IC, cfg.camera.t_ic_vec)
        streaming = server.mode == "stream" and server.engine.status == Status.TRACKING
        # The second chunk, from its first buffered frame to the call that runs it.
        chunking = server.mode == "chunked" and server.n_chunks == 1
        if (streaming and "stream" not in out) or chunking:
            with SyncSites() as s:
                server.process_frame(img, ts)
            if streaming:
                out["stream"] = s.sites
            else:
                out.setdefault("chunk", collections.Counter()).update(s.sites)
        else:
            server.process_frame(img, ts)
        if server.n_chunks == 2:
            return out
    raise RuntimeError("the sequence ended before two chunks ran")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk", type=int, default=5)
    args = ap.parse_args()
    res = run(chunk=args.chunk)
    for name, n in (("stream", 1), ("chunk", args.chunk)):
        sites = res[name]
        print(f"== {name}: {sum(sites.values())} host syncs over {n} frame(s)")
        for site, count in sites.most_common():
            print(f"{count:5d}  {site}")


if __name__ == "__main__":
    main()
