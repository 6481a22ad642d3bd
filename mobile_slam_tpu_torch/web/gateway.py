"""VIO WebSocket gateway on the port's engine (torch twin of
web/vio_gateway.py).

The browser client (web/js/app.js + vio-client.js) streams binary IMU
batches and grayscale frames over a WebSocket; this gateway owns one
``VIOEngine`` per connection, on the card unless started with
``--device cpu``, and answers with pose / status / map-point JSON. The
wire protocol is the reference gateway's, byte for byte, so the same web
client drives either.

Worker-parity behaviours (web/js/vio-worker.js):
  * stale-IMU discard (> 0.5 s older than the last frame)
  * frame-gap reset (> 1.5 s between frames)
  * map points with every 10th frame while tracking
  * the tuned configuration profiles of web/js/app.js, selected by name

Binary protocol (little-endian):
  0x02 IMU batch:  u8 type, u8 pad, u16 count, count x 7 float64
                   [ts, ax, ay, az, gx, gy, gz]
  0x03 frame:      u8 type, u8 pad, u16 width, u16 height, u16 pad2,
                   float64 ts, width*height u8 grayscale
Text messages are JSON: configure / reset / get_map_points / dispose. A
``configure`` may switch on online camera-IMU time-offset estimation with
``"config": {"estimator": {"estimate_td": true}}``.

Run:  python -m mobile_slam_tpu_torch.web.gateway [--port 8765] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import socket
import struct
import sys
import threading
import time

import numpy as np

from mobile_slam_tpu_torch.config import (CameraConfig, EstimatorConfig,
                                          TrackerConfig, VIOConfig)
from mobile_slam_tpu_torch.web import ws

MSG_IMU = 0x02
MSG_FRAME = 0x03

STALE_IMU_S = 0.5    # vio-worker.js:108-121
FRAME_GAP_S = 1.5    # vio-worker.js:245-251
MAP_POINTS_EVERY = 10


def _profiles():
    """Tuned configuration profiles (web/js/app.js:39-149). Camera
    intrinsics for the mobile profiles come from the client (FOV estimate,
    app.js:218-335) and are merged over these bases."""
    return {
        # 30 fps phone camera, tight solver budget (app.js:74-79).
        "mobile_default": dict(
            tracker=dict(max_cnt=100, min_dist=25, f_threshold=1.5,
                         equalize=True, lk_window_size=15,
                         lk_pyramid_levels=2, lk_iterations=20),
            estimator=dict(num_iterations=6, min_parallax=10.0,
                           acc_n=0.1, gyr_n=0.01, acc_w=1e-3, gyr_w=1e-4,
                           max_features=256, max_imu_per_interval=16),
        ),
        "mobile_highend": dict(
            tracker=dict(max_cnt=150, min_dist=20, f_threshold=1.0,
                         equalize=True, lk_window_size=21,
                         lk_pyramid_levels=3, lk_iterations=30),
            estimator=dict(num_iterations=8, min_parallax=10.0,
                           acc_n=0.08, gyr_n=0.004, acc_w=4e-4, gyr_w=2e-5,
                           max_features=384, max_imu_per_interval=16),
        ),
        "tum_vi": dict(
            camera=dict(model_type="KANNALA_BRANDT", width=512, height=512,
                        focal_length=190.97847715128717,
                        fx=190.97847715128717, fy=190.9733070521226,
                        cx=254.93170605935475, cy=256.8974428996504,
                        dist=(0.0034823894022493434, 0.0007150348452162257,
                              -0.0020532361418706202,
                              0.00020293673591811182),
                        r_ic=(0.0, 0.0, 1.0, -1.0, 0.0, 0.0, 0.0, -1.0, 0.0),
                        t_ic=(0.045, 0.073, -0.044)),
            tracker=dict(max_cnt=150, min_dist=20, fisheye=True,
                         max_points=160),
            estimator=dict(num_iterations=2, acc_n=0.04, gyr_n=0.004,
                           acc_w=4e-4, gyr_w=2e-5, max_features=384,
                           max_imu_per_interval=16),
        ),
        "euroc": dict(
            camera=dict(model_type="PINHOLE", width=752, height=480,
                        focal_length=460.0,
                        fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                        dist=(-0.28340811, 0.07395907, 0.00019359,
                              1.76187114e-05)),
            tracker=dict(max_cnt=150, min_dist=30, max_points=192),
            estimator=dict(num_iterations=2, acc_n=0.08, gyr_n=0.004,
                           acc_w=4e-5, gyr_w=2e-6, max_features=384,
                           max_imu_per_interval=16),
        ),
    }


def build_config(profile: str, overrides: dict) -> VIOConfig:
    """The named profile with the client's per-section overrides merged
    over it, as the port's ``VIOConfig``."""
    base = _profiles().get(profile)
    if base is None:
        raise ValueError(f"unknown profile '{profile}'")
    merged = {k: dict(v) for k, v in base.items()}
    for section, vals in (overrides or {}).items():
        merged.setdefault(section, {}).update(vals or {})
    cam_kw = merged.get("camera", {})
    if "model_type" not in cam_kw:
        # Mobile profiles: pinhole from the client's FOV-estimated focal.
        cam_kw.setdefault("model_type", "PINHOLE")
        cam_kw.setdefault("width", 640)
        cam_kw.setdefault("height", 480)
        f = cam_kw.get("fx", 500.0)
        cam_kw.setdefault("fx", f)
        cam_kw.setdefault("fy", f)
        cam_kw.setdefault("focal_length", f)
        cam_kw.setdefault("cx", cam_kw["width"] / 2.0)
        cam_kw.setdefault("cy", cam_kw["height"] / 2.0)
        # The client rotates the W3C device frame into the VIO body frame
        # (imu.js); the extrinsics here are camera-from-body for a phone
        # held portrait.
        cam_kw.setdefault("r_ic", (1.0, 0.0, 0.0,
                                   0.0, -1.0, 0.0,
                                   0.0, 0.0, -1.0))
        cam_kw.setdefault("t_ic", (0.0, 0.0, 0.0))
    cam_kw.setdefault("focal_length", cam_kw.get("fx", 500.0))
    for key in ("dist", "r_ic", "t_ic"):
        if key in cam_kw and isinstance(cam_kw[key], list):
            cam_kw[key] = tuple(cam_kw[key])
    return VIOConfig(
        camera=CameraConfig(**cam_kw),
        tracker=TrackerConfig(**merged.get("tracker", {})),
        estimator=EstimatorConfig(**merged.get("estimator", {})),
    )


class ClientSession:
    """One connected client: owns a ``VIOEngine`` on ``device`` once
    configured. ``last_result`` is the engine's ``FrameResult`` of the last
    frame (its ``td`` field carries the time-offset estimate, which the wire
    protocol does not); ``thread`` is the thread that runs the session."""

    def __init__(self, conn: ws.WebSocketConnection, device="cuda"):
        self.conn = conn
        self.device = device
        self.engine = None
        self.frame_count = 0
        self.last_frame_ts = None
        self.last_result = None
        self.thread = threading.current_thread()

    # -- message handling -------------------------------------------------

    def run(self) -> None:
        while True:
            is_text, payload = self.conn.recv()
            if payload is None:
                return
            try:
                if is_text:
                    if self._handle_text(json.loads(payload)):
                        return
                else:
                    self._handle_binary(payload)
            except Exception as e:  # report, keep session alive
                self._send({"type": "error", "message": str(e)})

    def _send(self, obj: dict) -> None:
        self.conn.send(json.dumps(obj))

    def _handle_text(self, msg: dict) -> bool:
        t = msg.get("type")
        if t == "configure":
            from mobile_slam_tpu_torch.engine.vio_engine import VIOEngine

            cfg = build_config(msg.get("profile", "mobile_default"),
                               msg.get("config", {}))
            # Raises on a machine without the requested device: the error
            # goes to the client and no engine falls back to the CPU.
            self.engine = VIOEngine(cfg, device=self.device)
            self.frame_count = 0
            self.last_frame_ts = None
            self._send({"type": "configured", "ok": True,
                        "profile": msg.get("profile", "mobile_default"),
                        "width": cfg.camera.width,
                        "height": cfg.camera.height})
        elif t == "reset":
            if self.engine is not None:
                self.engine.reset()
            self.last_frame_ts = None
            self._send({"type": "reset_done"})
        elif t == "get_map_points":
            self._send_map_points()
        elif t == "dispose":
            self._send({"type": "disposed"})
            return True
        else:
            self._send({"type": "error", "message": f"unknown type {t}"})
        return False

    def _handle_binary(self, payload: bytes) -> None:
        if self.engine is None:
            self._send({"type": "error", "message": "not configured"})
            return
        kind = payload[0]
        if kind == MSG_IMU:
            (count,) = struct.unpack_from("<H", payload, 2)
            arr = np.frombuffer(payload, "<f8", count * 7, offset=4)
            arr = arr.reshape(count, 7)
            for s in arr:
                # Stale-IMU discard (vio-worker.js:108-121).
                if (self.last_frame_ts is not None
                        and s[0] < self.last_frame_ts - STALE_IMU_S):
                    continue
                self.engine.push_imu(s[0], s[1:4], s[4:7])
        elif kind == MSG_FRAME:
            w, h = struct.unpack_from("<HH", payload, 2)
            (ts,) = struct.unpack_from("<d", payload, 8)
            # A writable copy: the engine wraps the array as a tensor.
            img = np.frombuffer(payload, np.uint8, w * h, offset=16).reshape(h, w).copy()
            self._process_frame(img, ts)
        else:
            self._send({"type": "error", "message": f"bad binary {kind}"})

    def _process_frame(self, img: np.ndarray, ts: float) -> None:
        # Frame-gap reset (vio-worker.js:245-251).
        if (self.last_frame_ts is not None
                and ts - self.last_frame_ts > FRAME_GAP_S):
            self.engine.reset()
        self.last_frame_ts = ts
        t0 = time.perf_counter()
        res = self.engine.process_frame(img, ts)
        proc_ms = (time.perf_counter() - t0) * 1e3
        self.frame_count += 1
        self.last_result = res
        self._send({
            "type": "result",
            "ok": bool(res.ok),
            "ts": res.ts if res.ts is not None else ts,
            "status": res.status.name,
            "pose": None if res.pose is None
                    else [round(float(v), 6) for v in res.pose.reshape(-1)],
            "num_features": int(res.num_features),
            "is_keyframe": bool(res.is_keyframe),
            "proc_ms": round(proc_ms, 2),
        })
        if res.ok and self.frame_count % MAP_POINTS_EVERY == 0:
            self._send_map_points()

    def _send_map_points(self) -> None:
        pts = (np.zeros((0, 3)) if self.engine is None
               else self.engine.get_map_points())
        self._send({"type": "map_points",
                    "points": np.asarray(pts, float).round(4).tolist()})


def serve(port: int, ready_event: threading.Event | None = None,
          sock: socket.socket | None = None, *, device="cuda",
          sessions: list | None = None) -> None:
    """Accept clients on ``port`` (or on the bound ``sock``), one handler
    thread and ``ClientSession`` each, their engines on ``device``. Each
    session is appended to ``sessions`` when given (its ``thread`` can be
    joined after the client's ``dispose``). Returns once the listening
    socket is shut down (``sock.shutdown(socket.SHUT_RDWR)``)."""
    if sock is None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("0.0.0.0", port))
    sock.listen(4)
    print(f"[gateway] ws://0.0.0.0:{sock.getsockname()[1]}/ (engines on {device})",
          file=sys.stderr)
    if ready_event is not None:
        ready_event.set()
    while True:
        try:
            client, addr = sock.accept()
        except OSError:
            return
        client.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

        def handle(c=client, a=addr):
            try:
                conn = ws.accept_handshake(c)
                session = ClientSession(conn, device=device)
                if sessions is not None:
                    sessions.append(session)
                session.run()
            except (ws.WebSocketError, OSError) as e:
                print(f"[gateway] {a}: {e}", file=sys.stderr)
            finally:
                try:
                    c.close()
                except OSError:
                    pass

        threading.Thread(target=handle, daemon=True).start()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--device", default="cuda",
                    help="device of every session's engine (default: the card)")
    args = ap.parse_args(argv)
    from mobile_slam_tpu_torch.engine.vio_engine import require_device

    require_device(args.device)
    serve(args.port, device=args.device)


if __name__ == "__main__":
    main()
