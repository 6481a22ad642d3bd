"""Chunked image serving with rebuild-and-continue recovery (torch twin of
mobile_slam_tpu.engine.serving).

The server streams frames through ``VIOEngine.process_frame`` until the
engine has tracked ``stable_frames`` frames in a row, then buffers
``chunk_size`` frames at a time and runs each buffer through the chunked
image step (engine/chunked.py), where no host gate intervenes. When a
chunk lands, its per-frame ``ok`` flags reach the host in one copy. A
failed TAIL (the last ``recover_tail`` or more frames all gated) means
the carried state is bad now: the server rebuilds the estimator (the
tracker state survives, as in the reference engine), replays the failed
frames through the streaming engine from their host-retained images and
IMU slices until initialization succeeds again, then resumes chunked
serving. Mid-chunk glitches that recover by themselves cost only their own
frames.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mobile_slam_tpu_torch.engine import chunked
from mobile_slam_tpu_torch.engine.vio_engine import Status, VIOEngine
from mobile_slam_tpu_torch.utils import logging as slog


class ServeResult(NamedTuple):
    """Per-frame serving output (body frame, for evaluation/logging)."""

    ts: float
    ok: bool
    p: np.ndarray        # (3,) body position (world)
    q: np.ndarray        # (4,) body quaternion wxyz
    is_keyframe: bool
    chunked: bool        # True if produced by the chunked step


class ChunkedImageServer:
    """Image-path serving in chunks, with failure recovery.

    Modes:
      * stream  — per-frame ``VIOEngine.process_frame`` (initialization and
                  re-initialization; the engine's own LOST / COOLDOWN /
                  rebuild machinery runs here).
      * chunked — ``chunk_size``-frame chunks through the chunked image
                  step; entered after ``stable_frames`` consecutive
                  TRACKING results.

    Runs on the card unless given ``device="cpu"``.
    """

    def __init__(self, cfg, dtype=torch.float32, chunk_size: int = 50,
                 recover_tail: int = 6, stable_frames: int = 3, *, device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.chunk_size = int(chunk_size)
        self.recover_tail = int(recover_tail)
        self.stable_frames = int(stable_frames)
        self.engine = VIOEngine(cfg, device=device, dtype=dtype)
        self._step = chunked.make_chunked_image_step(
            self.engine.params, cfg.estimator.num_iterations, cfg.tracker,
            self.engine.camera, cfg.camera.focal_length)
        self._mode = "stream"
        self._carry: Optional[chunked.ImageChunkCarry] = None
        self._buf: list[chunked.ImageFrameInput] = []
        self._buf_ts: list[float] = []
        self._stable = 0
        self._replaying = False
        # Counters; the times are the spans' (``chunk``, ``recover``: utils/logging.py).
        self.n_chunks = 0
        self.n_recoveries = 0
        self.frames_chunked = 0   # real (not padding) frames through chunks
        self.frames_streamed = 0  # engine.process_frame calls, replays included

    # -- IMU ------------------------------------------------------------

    def push_imu(self, ts: float, acc, gyr) -> None:
        self.engine.push_imu(ts, acc, gyr)

    # -- frames ----------------------------------------------------------

    def process_frame(self, image: np.ndarray, ts: float) -> list[ServeResult]:
        """Feed one grayscale frame; returns 0..chunk_size results (chunked
        results arrive in bursts when a chunk completes)."""
        if self._mode == "stream":
            return self._process_stream(image, ts)
        return self._process_chunked(image, ts)

    def _process_stream(self, image, ts, imu_override=None) -> list[ServeResult]:
        res = self.engine.process_frame(np.asarray(image), ts,
                                        imu_override=imu_override)
        self.frames_streamed += 1
        out = []
        if res.ok:
            p, q, _ = self.engine.get_body_state()
            out.append(ServeResult(ts, True, p, q, bool(res.is_keyframe),
                                   chunked=False))
        if res.status == Status.TRACKING:
            self._stable += 1
            # While a failed chunk tail replays, the engine keeps streaming;
            # the switch to chunks happens once, after the replay.
            if self._stable >= self.stable_frames and not self._replaying:
                self._enter_chunked()
        else:
            self._stable = 0
        return out

    def _enter_chunked(self) -> None:
        eng = self.engine
        d0 = float(eng._depth_ema or 0.0)
        f32 = dict(dtype=torch.float32, device=eng.device)
        self._carry = chunked.ImageChunkCarry(
            est_state=eng.state, tracker_state=eng.tracker_state,
            banned_ids=eng._banned_ids, gen=eng._gen,
            depth_ema=torch.full((), d0, **f32),
            vel_ema=torch.full((), float(eng._vel_ema), **f32),
            # Rings seeded with the streaming baselines, so that a
            # compounding runaway right after (re)initialization trips
            # within GROWTH_WINDOW frames of chunk entry.
            lag_depth=torch.full((chunked.GROWTH_WINDOW,), d0, **f32),
            lag_vel=torch.full((chunked.GROWTH_WINDOW,), float(eng._vel_ema), **f32),
            lag_i=torch.zeros((), dtype=torch.int32, device=eng.device))
        self._buf, self._buf_ts = [], []
        self._mode = "chunked"

    def _frame_input(self, image, ts) -> chunked.ImageFrameInput:
        """The frame's input, kept on the host (a failed tail replays it)."""
        eng = self.engine
        dts, accs, gyrs = eng._drain_imu(ts)
        eng._last_frame_ts = ts
        m_pad = self.cfg.estimator.max_imu_per_interval
        m = min(len(dts), m_pad)
        dt_p = np.zeros(m_pad)
        acc_p = np.zeros((m_pad, 3))
        gyr_p = np.zeros((m_pad, 3))
        dt_p[:m] = dts[:m]
        acc_p[:m] = accs[:m]
        gyr_p[:m] = gyrs[:m]

        def t(a):
            return torch.as_tensor(a, dtype=self.dtype)

        return chunked.ImageFrameInput(
            img=t(np.asarray(image)), ts=t(ts - eng._t0), imu_dt=t(dt_p),
            imu_acc=t(acc_p), imu_gyr=t(gyr_p),
            imu_cnt=torch.tensor(m, dtype=torch.int32))

    def _process_chunked(self, image, ts) -> list[ServeResult]:
        self._buf.append(self._frame_input(image, ts))
        self._buf_ts.append(ts)
        if len(self._buf) < self.chunk_size:
            return []
        return self._run_chunk()

    def _run_chunk(self, n_real: Optional[int] = None) -> list[ServeResult]:
        n_real = n_real if n_real is not None else len(self._buf)
        with slog.span("chunk", index=self.n_chunks, frames=n_real):
            with slog.span("chunk.upload"):
                batch = chunked.stack_image_inputs(self._buf, self.engine.device)
            with slog.span("chunk.step"):
                self._carry, (p, q, ok, kf) = self._step(self._carry, batch)
            # One device -> host copy for the whole chunk: the host waits
            # here for the chunk's device work.
            with slog.span("chunk.readback"):
                out = torch.cat([p.to(torch.float64), q.to(torch.float64),
                                 ok[:, None].to(torch.float64),
                                 kf[:, None].to(torch.float64)], dim=1).cpu().numpy()
        self.n_chunks += 1
        self.frames_chunked += n_real
        ok_np = out[:, 7] > 0.5
        results = [
            ServeResult(self._buf_ts[k], bool(ok_np[k]), out[k, 0:3], out[k, 3:7],
                        bool(out[k, 8] > 0.5), chunked=True)
            for k in range(n_real)
        ]
        inputs, in_ts = self._buf, self._buf_ts
        self._buf, self._buf_ts = [], []

        # Failed tail => the carried state is bad now: rebuild + re-init,
        # then replay the failed frames through the streaming engine (their
        # images and drained IMU slices are still on the host), so that the
        # re-initialization consumes the tail instead of discarding it.
        tail = 0
        for k in range(n_real - 1, -1, -1):
            if ok_np[k]:
                break
            tail += 1
        if tail >= self.recover_tail:
            with slog.span("recover", frames=tail):
                self._recover()
                k0 = n_real - tail
                self._replaying = True
                # The replay runs from the post-chunk tracker state, which
                # already saw these frames: the first replayed frame arrives
                # with a backwards timestamp and re-seeds the tracks (the
                # tracker's dt guard zeroes its velocities), as in the
                # reference.
                try:
                    for k in range(k0, n_real):
                        inp = inputs[k]
                        cnt = int(inp.imu_cnt)
                        override = (inp.imu_dt[:cnt].numpy(), inp.imu_acc[:cnt].numpy(),
                                    inp.imu_gyr[:cnt].numpy())
                        replay = self._process_stream(inp.img.numpy(), in_ts[k],
                                                      imu_override=override)
                        results[k] = (replay[0] if replay else
                                      results[k]._replace(ok=False, chunked=False))
                finally:
                    self._replaying = False
            if self._stable >= self.stable_frames:
                self._enter_chunked()
        return results

    def _recover(self) -> None:
        """Rebuild-and-continue: the tracker state, the outlier bans and the
        RANSAC generator come back from the chunk carry; the estimator state
        is refreshed from the carry BEFORE the rebuild, so that the learned
        td is read from the live state, then restarts."""
        eng = self.engine
        eng.tracker_state = self._carry.tracker_state
        eng._banned_ids = self._carry.banned_ids
        eng._gen = self._carry.gen
        eng.state = self._carry.est_state
        eng._rebuild_estimator()
        eng._consecutive_failures = 0
        eng._cooldown_remaining = 0
        self._carry = None
        self._stable = 0
        self._mode = "stream"
        self.n_recoveries += 1

    def flush(self) -> list[ServeResult]:
        """Process a partly filled chunk (end of sequence): padded to
        chunk_size by repeating its last frame; padded outputs are
        dropped."""
        if self._mode != "chunked" or not self._buf:
            return []
        n_real = len(self._buf)
        while len(self._buf) < self.chunk_size:
            self._buf.append(self._buf[-1])
            self._buf_ts.append(self._buf_ts[-1])
        return self._run_chunk(n_real=n_real)

    @property
    def mode(self) -> str:
        return self._mode
