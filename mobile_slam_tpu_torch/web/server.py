"""Viewer server on the port (torch twin of web/server.py).

Serves the repo's viewer (web/viewer.html, web/js/*, read as files) plus a
trajectory.json built from a logs/<ts>/ run directory that the port's
``VIOSystem`` writes (re-read on every request, so a running session can be
followed live: trajectory_pose.txt, live.json, frame.png), and accepts
POST /log for remote debug logging.

HTTPS: mobile getUserMedia / Generic Sensor need a secure context, so the
server prefers TLS — real certificates if given, a generated self-signed
localhost pair otherwise — with ``--no-tls`` for plain HTTP.

    python -m mobile_slam_tpu_torch.web.server --run logs/<ts> [--port 8080]
        [--map points.npy] [--cert c.pem --key k.pem | --no-tls]
"""

from __future__ import annotations

import argparse
import json
import os
import ssl
import subprocess
import sys
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

from mobile_slam_tpu_torch.io.trajectory import read_tum

# The repo's web client: viewer.html and js/*, served as static files.
WEB_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "web")

RUN_DIR = None
MAP_FILE = None
DATA_DIR = None


def build_payload() -> dict:
    """The viewer's trajectory.json from the run directory: the TUM
    trajectory, map points (``--map`` file, else live.json's), and
    live.json's IMU window, status and counters."""
    traj = []
    map_pts = []
    live = {}
    path = os.path.join(RUN_DIR, "trajectory_pose.txt")
    if os.path.exists(path):
        _, p, _ = read_tum(path)
        traj = p.tolist()
    if MAP_FILE and os.path.exists(MAP_FILE):
        map_pts = np.load(MAP_FILE).tolist()
    live_path = os.path.join(RUN_DIR, "live.json")
    if os.path.exists(live_path):
        try:
            with open(live_path) as f:
                live = json.load(f)
        except (OSError, json.JSONDecodeError):
            live = {}
    if not map_pts:
        map_pts = live.get("map_points", [])
    return {"trajectory": traj, "map_points": map_pts,
            "imu": live.get("imu", {}), "status": live.get("status", ""),
            "frames": live.get("frames", 0), "poses": live.get("poses", 0),
            "tracks": live.get("tracks", {})}


class Handler(BaseHTTPRequestHandler):
    def _send(self, code, body, ctype="text/html"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    MIME = {".html": "text/html", ".js": "application/javascript",
            ".json": "application/json", ".css": "text/css",
            ".png": "image/png", ".pgm": "application/octet-stream",
            ".csv": "text/csv"}

    def do_GET(self):
        if self.path in ("/", "/viewer.html"):
            with open(os.path.join(WEB_DIR, "viewer.html"), "rb") as f:
                self._send(200, f.read())
        elif self.path.startswith("/trajectory.json"):
            body = json.dumps(build_payload()).encode()
            self._send(200, body, "application/json")
        elif self.path.startswith("/frame.png"):
            # Latest camera frame from the run dir (track-overlay panel).
            full = os.path.join(RUN_DIR, "frame.png")
            if os.path.isfile(full):
                with open(full, "rb") as f:
                    self._send(200, f.read(), "image/png")
            else:
                self._send(404, b"no frame yet")
        else:
            # Static files under web/ and the replay dataset under --data;
            # a path that leaves its root is refused.
            rel = self.path.lstrip("/").split("?", 1)[0]
            roots = [WEB_DIR] + ([DATA_DIR] if DATA_DIR else [])
            for root in roots:
                full = os.path.realpath(os.path.join(root, rel))
                if not full.startswith(os.path.realpath(root) + os.sep):
                    continue
                if os.path.isfile(full):
                    ext = os.path.splitext(full)[1]
                    with open(full, "rb") as f:
                        self._send(200, f.read(),
                                   self.MIME.get(ext, "application/octet-stream"))
                    return
            self._send(404, b"not found")

    def do_POST(self):
        if self.path == "/log":
            n = int(self.headers.get("Content-Length", 0))
            msg = self.rfile.read(n).decode(errors="replace")
            print(f"[remote-log] {msg}", file=sys.stderr)
            self._send(200, b"ok", "text/plain")
        else:
            self._send(404, b"not found")

    def log_message(self, *a):
        pass


def ensure_self_signed(cert_dir: str) -> tuple[str, str]:
    """Generate (once) and return a self-signed localhost cert/key pair."""
    cert = os.path.join(cert_dir, "cert.pem")
    key = os.path.join(cert_dir, "key.pem")
    if not (os.path.exists(cert) and os.path.exists(key)):
        os.makedirs(cert_dir, exist_ok=True)
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048",
             "-keyout", key, "-out", cert, "-days", "365", "-nodes",
             "-subj", "/CN=localhost"],
            check=True, capture_output=True)
    return cert, key


def make_server(run_dir: str, port: int = 8080,
                map_file: str | None = None,
                data_dir: str | None = None,
                tls: bool = False,
                certfile: str | None = None,
                keyfile: str | None = None) -> HTTPServer:
    """Build the viewer HTTPServer (importable for in-process embedding).
    With ``tls`` the socket is TLS-wrapped; certificates default to a
    generated self-signed localhost pair under web/.certs/."""
    global RUN_DIR, MAP_FILE, DATA_DIR
    RUN_DIR = run_dir
    MAP_FILE = map_file
    DATA_DIR = data_dir
    srv = HTTPServer(("0.0.0.0", port), Handler)
    if tls:
        if not (certfile and keyfile):
            certfile, keyfile = ensure_self_signed(os.path.join(WEB_DIR, ".certs"))
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(certfile, keyfile)
        srv.socket = ctx.wrap_socket(srv.socket, server_side=True)
    return srv


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", required=True, help="logs/<ts> directory")
    ap.add_argument("--map", default=None, help="optional .npy map points")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--data", default=None,
                    help="replay dataset dir (served for test-replay.html)")
    ap.add_argument("--cert", default=None, help="TLS certificate (PEM)")
    ap.add_argument("--key", default=None, help="TLS private key (PEM)")
    ap.add_argument("--no-tls", action="store_true",
                    help="serve plain HTTP (mobile camera/IMU need HTTPS)")
    args = ap.parse_args(argv)
    srv = make_server(args.run, args.port, args.map, args.data,
                      tls=not args.no_tls, certfile=args.cert,
                      keyfile=args.key)
    scheme = "http" if args.no_tls else "https"
    print(f"viewer at {scheme}://localhost:{args.port}/  (run dir: {args.run})")
    srv.serve_forever()


if __name__ == "__main__":
    main()
