"""The port's phone entry point on the CPU: the WebSocket gateway
(mobile_slam_tpu_torch/web/gateway.py) and its framing (web/ws.py's copy)
against the reference gateway (web/vio_gateway.py, web/ws.py) and the web
client's constants; the viewer server; the failure detector and the
logging utilities against their JAX counterparts.

Everything runs in this process (the gateway in a thread, clients on
127.0.0.1). Each session ends with ``dispose``, and its handler thread is
joined before the test returns, so that no thread is inside torch when the
interpreter exits.
"""

import dataclasses
import json
import os
import re
import socket
import struct
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import _torch_parity  # noqa: F401  (one torch thread per worker)

from mobile_slam_tpu.frontend import failure_detector as jfd
from mobile_slam_tpu.models import state as jstate
from mobile_slam_tpu_torch.config import CameraConfig
from mobile_slam_tpu_torch.engine.vio_engine import Status
from mobile_slam_tpu_torch.eval import simulation as sim
from mobile_slam_tpu_torch.frontend import failure_detector as fd
from mobile_slam_tpu_torch.io.trajectory import ResultLogger
from mobile_slam_tpu_torch.models import state as tstate
from mobile_slam_tpu_torch.models.cameras.base import make_camera
from mobile_slam_tpu_torch.utils import logging as slog
from mobile_slam_tpu_torch.utils import rotations as rot
from mobile_slam_tpu_torch.web import gateway, server
from mobile_slam_tpu_torch.web import ws as tws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "web"))

import vio_gateway  # noqa: E402  (web/vio_gateway.py, the reference)
import ws as jws  # noqa: E402  (web/ws.py)

JOIN_S = 60.0

# The client's configure of tests/test_vio_gateway.py (CONFIG_MSG), with
# online time-offset estimation switched on.
CAMERA = {"model_type": "PINHOLE", "width": 192, "height": 192,
          "focal_length": 150.0, "fx": 150.0, "fy": 150.0, "cx": 96.0, "cy": 96.0,
          "r_ic": [0.0, 0, 1, -1, 0, 0, 0, -1, 0], "t_ic": [0.0, 0, 0]}
CONFIG_MSG = {
    "type": "configure", "profile": "mobile_default",
    "config": {
        "camera": CAMERA,
        "tracker": {"max_cnt": 60, "min_dist": 14, "max_points": 96,
                    "lk_window_size": 15, "lk_pyramid_levels": 2},
        "estimator": {"max_features": 128, "max_imu_per_interval": 16,
                      "num_iterations": 4, "estimate_td": True},
    },
}


# ---------------------------------------------------------------------------
# Configuration and wire constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("camera", [False, True], ids=["profile", "camera_override"])
@pytest.mark.parametrize("profile", ["mobile_default", "mobile_highend", "tum_vi", "euroc"])
def test_build_config_matches_reference(profile, camera):
    overrides = {"camera": dict(CAMERA)} if camera else {}
    got = gateway.build_config(profile, json.loads(json.dumps(overrides)))
    want = vio_gateway.build_config(profile, json.loads(json.dumps(overrides)))
    assert type(got).__module__.startswith("mobile_slam_tpu_torch")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert gateway._profiles()[profile] == vio_gateway._profiles()[profile]


def test_wire_constants_match_reference_and_client():
    names = ("MSG_IMU", "MSG_FRAME", "STALE_IMU_S", "FRAME_GAP_S", "MAP_POINTS_EVERY")
    for name in names:
        assert getattr(gateway, name) == getattr(vio_gateway, name), name
    with open(os.path.join(REPO, "web", "js", "vio-client.js")) as f:
        client = f.read()
    assert re.search(r"setUint8\(0,\s*0x02\)", client) and gateway.MSG_IMU == 0x02
    assert re.search(r"setUint8\(0,\s*0x03\)", client) and gateway.MSG_FRAME == 0x03
    with open(os.path.join(REPO, "web", "js", "vio-worker.js")) as f:
        worker = f.read()
    for name in ("STALE_IMU_S", "FRAME_GAP_S"):
        m = re.search(name + r"\s*=\s*([\d.]+)", worker)
        assert m and float(m.group(1)) == getattr(gateway, name), name


# ---------------------------------------------------------------------------
# RFC 6455 framing across the two copies
# ---------------------------------------------------------------------------

@pytest.fixture(params=["port_client", "port_server"])
def ws_pair(request):
    """(client, server) connections: the port's ws as one side and
    web/ws.py as the other."""
    cli_mod, srv_mod = (tws, jws) if request.param == "port_client" else (jws, tws)
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    out = {}

    def accept():
        c, _ = srv.accept()
        out["server"] = srv_mod.accept_handshake(c)

    t = threading.Thread(target=accept, daemon=True)
    t.start()
    client = cli_mod.connect("127.0.0.1", srv.getsockname()[1])
    t.join(5)
    yield client, out["server"]
    client.sock.close()
    out["server"].sock.close()
    srv.close()


def test_ws_text_and_large_binary(ws_pair):
    client, server_conn = ws_pair
    client.send("hello")
    assert server_conn.recv() == (True, b"hello")
    blob = os.urandom(300_000)          # over 64 KiB: the 64-bit length
    client.send(blob)
    assert server_conn.recv() == (False, blob)
    server_conn.send(blob[:70_000])     # 16-bit length, server -> client
    assert client.recv() == (False, blob[:70_000])


def test_ws_ping_is_answered(ws_pair):
    client, server_conn = ws_pair
    server_conn._send_frame(0x9, b"x")   # ping
    client.send("after-ping")           # the client answers on its recv path
    assert server_conn.recv() == (True, b"after-ping")
    server_conn.send("reply")
    assert client.recv() == (True, b"reply")


def test_ws_fragmented_message(ws_pair):
    client, server_conn = ws_pair
    mask = b"\x01\x02\x03\x04"

    def frag(fin, opcode, data):
        hdr = bytes([(0x80 if fin else 0) | opcode, 0x80 | len(data)]) + mask
        client.sock.sendall(hdr + bytes(b ^ mask[i % 4] for i, b in enumerate(data)))

    frag(False, 0x1, b"frag")
    frag(True, 0x0, b"mented")
    assert server_conn.recv() == (True, b"fragmented")


# ---------------------------------------------------------------------------
# The gateway
# ---------------------------------------------------------------------------

class Gateway:
    """The port's gateway in a thread on an ephemeral port, its sessions
    recorded; ``close`` joins every handler thread and the server."""

    def __init__(self, device):
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.sessions = []
        ready = threading.Event()
        self.thread = threading.Thread(
            target=gateway.serve, args=(self.port, ready, self.sock),
            kwargs=dict(device=device, sessions=self.sessions), daemon=True)
        self.thread.start()
        assert ready.wait(5)

    def connect(self):
        return tws.connect("127.0.0.1", self.port)

    def dispose(self, conn):
        """``dispose`` -> ``disposed``, then the session's thread ends."""
        conn.send(json.dumps({"type": "dispose"}))
        assert _recv_json(conn, "disposed")["type"] == "disposed"
        conn.close()
        for s in self.sessions:
            s.thread.join(JOIN_S)
            assert not s.thread.is_alive()

    def close(self):
        self.sock.shutdown(socket.SHUT_RDWR)
        self.sock.close()
        self.thread.join(JOIN_S)
        assert not self.thread.is_alive()


@pytest.fixture
def cpu_gateway():
    g = Gateway("cpu")
    yield g
    g.close()


def _imu_msg(samples):
    arr = np.ascontiguousarray(samples, "<f8")
    return struct.pack("<BBH", gateway.MSG_IMU, 0, len(arr)) + arr.tobytes()


def _frame_msg(img, ts):
    h, w = img.shape
    return (struct.pack("<BBHHHd", gateway.MSG_FRAME, 0, w, h, 0, ts)
            + np.ascontiguousarray(img, np.uint8).tobytes())


def _recv_json(conn, want_type=None, allow_error=False, limit=50):
    for _ in range(limit):
        is_text, payload = conn.recv()
        assert payload is not None, "gateway closed the connection"
        assert is_text
        msg = json.loads(payload)
        if msg.get("type") == "error" and not allow_error:
            raise AssertionError(f"gateway error: {msg['message']}")
        if want_type is None or msg.get("type") == want_type:
            return msg
    raise AssertionError(f"no {want_type} message")


def test_error_before_configure_and_unknown_profile(cpu_gateway):
    conn = cpu_gateway.connect()
    conn.send(_frame_msg(np.zeros((8, 8), np.uint8), 0.0))
    assert _recv_json(conn, allow_error=True) == {"type": "error",
                                                 "message": "not configured"}
    conn.send(json.dumps({"type": "configure", "profile": "nope"}))
    msg = _recv_json(conn, allow_error=True)
    assert msg["type"] == "error" and "nope" in msg["message"]
    assert cpu_gateway.sessions[0].engine is None
    cpu_gateway.dispose(conn)


def test_cuda_configure_without_a_card_reports_error():
    """A gateway on the card refuses to configure where there is none: the
    client gets the error, and no engine is built on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = Gateway("cuda")
    try:
        conn = g.connect()
        conn.send(json.dumps(CONFIG_MSG))
        msg = _recv_json(conn, allow_error=True)
        assert msg["type"] == "error" and "cuda" in msg["message"].lower()
        assert g.sessions[0].engine is None
        g.dispose(conn)
    finally:
        g.close()


@pytest.fixture(scope="module")
def world():
    """The small world of tests/test_vio_gateway.py (192x192, 10 Hz)."""
    r_ic = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    cam = make_camera(CameraConfig(**{k: tuple(v) if isinstance(v, list) else v
                                       for k, v in CAMERA.items()}),
                      dtype=torch.float64, device="cpu")
    scfg = sim.SimConfig(duration=9.0, cam_rate=10.0, imu_rate=100.0,
                         num_landmarks=500, max_features=60, seed=3)
    data = sim.simulate(scfg, cam, r_ic, np.zeros(3))
    return data, cam, r_ic


def test_full_session_on_cpu(cpu_gateway, world):
    """configure (mobile_default over the small camera, td on) -> IMU and
    frames until TRACKING and two map_points messages -> a stale IMU sample
    dropped -> a frame gap resets to INITIALIZING -> reset empties the map
    -> dispose."""
    data, cam, r_ic = world
    conn = cpu_gateway.connect()
    conn.send(json.dumps(CONFIG_MSG))
    msg = _recv_json(conn, "configured")
    assert msg == {"type": "configured", "ok": True, "profile": "mobile_default",
                   "width": 192, "height": 192}
    session = cpu_gateway.sessions[0]
    assert session.engine.device.type == "cpu"
    assert float(session.engine.params.td_enable) == 1.0

    imu = np.column_stack([data.imu_ts, data.imu_acc, data.imu_gyr])
    imu_i, statuses, poses, maps, tds = 0, [], [], 0, []
    last_ts = None
    for fi, ts in enumerate(data.cam_ts):
        j = int(np.searchsorted(data.imu_ts, ts + 1e-9))
        if j > imu_i:
            conn.send(_imu_msg(imu[imu_i:j]))
            imu_i = j
        conn.send(_frame_msg(sim.render_frame(data, fi, cam, r_ic, np.zeros(3)), ts))
        res = _recv_json(conn, "result")
        last_ts = ts
        statuses.append(res["status"])
        assert res["ts"] == ts and res["proc_ms"] > 0
        if res["ok"]:
            P = np.asarray(res["pose"]).reshape(4, 4)
            np.testing.assert_allclose(P[:3, :3] @ P[:3, :3].T, np.eye(3), atol=1e-4)
            assert np.linalg.det(P[:3, :3]) > 0 and np.all(P[3] == [0, 0, 0, 1])
            poses.append(P)
            td = session.last_result.td
            assert np.isfinite(td) and abs(td) <= 0.08
            tds.append(td)
        if res["ok"] and (fi + 1) % gateway.MAP_POINTS_EVERY == 0:
            m = _recv_json(conn, "map_points")
            assert len(m["points"]) > 0
            assert np.isfinite(np.asarray(m["points"])).all()
            maps += 1
            if maps == 2:
                break
    assert "TRACKING" in statuses and statuses[0] == "INITIALIZING"
    assert maps == 2, f"{maps} map_points messages over {len(statuses)} frames"

    # A stale IMU sample (> 0.5 s before the last frame) is dropped, a fresh
    # one queued; the get_map_points answer shows the batch was handled.
    stale = np.r_[last_ts - 0.6, imu[imu_i, 1:]]
    fresh = imu[imu_i]
    conn.send(_imu_msg(np.stack([stale, fresh])))
    conn.send(json.dumps({"type": "get_map_points"}))
    assert len(_recv_json(conn, "map_points")["points"]) > 0
    queued = [s[0] for s in session.engine._pending_imu]
    assert fresh[0] in queued and stale[0] not in queued

    # A frame gap over 1.5 s resets the engine: the frame after it
    # initializes anew.
    gap_ts = last_ts + gateway.FRAME_GAP_S + 0.5
    conn.send(_frame_msg(sim.render_frame(data, fi + 1, cam, r_ic, np.zeros(3)), gap_ts))
    res = _recv_json(conn, "result")
    assert res["status"] == "INITIALIZING" and not res["ok"]
    assert session.engine.status == Status.INITIALIZING

    conn.send(json.dumps({"type": "reset"}))
    _recv_json(conn, "reset_done")
    conn.send(json.dumps({"type": "get_map_points"}))
    assert _recv_json(conn, "map_points")["points"] == []
    cpu_gateway.dispose(conn)


# ---------------------------------------------------------------------------
# The viewer server
# ---------------------------------------------------------------------------

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.read()


def test_viewer_server_follows_a_run_directory(tmp_path):
    """A run directory written by the port's ResultLogger: trajectory.json
    grows between two polls, live.json's payload passes through, and the
    repo's viewer page and client scripts are served."""
    logger = ResultLogger(str(tmp_path / "logs"))
    for i in range(10):
        logger.add_pose(i * 0.05, [0.1 * i, 0.05 * i, 0.0], [1.0, 0, 0, 0])
    logger.flush()
    srv = server.make_server(logger.dir, port=0)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        d1 = json.loads(_get(port, "/trajectory.json")[1])
        assert len(d1["trajectory"]) == 10
        for i in range(10, 25):
            logger.add_pose(i * 0.05, [0.1 * i, 0.05 * i, 0.0], [1.0, 0, 0, 0])
        logger.flush()
        live = {"status": "TRACKING", "frames": 30, "poses": 25,
                "map_points": [[1.0, 2.0, 3.0]], "imu": {"ts": [0.0]}}
        with open(os.path.join(logger.dir, "live.json"), "w") as f:
            json.dump(live, f)
        d2 = json.loads(_get(port, "/trajectory.json")[1])
        assert len(d2["trajectory"]) == 25, "the server did not re-read the run dir"
        np.testing.assert_allclose(d2["trajectory"][24], [2.4, 1.2, 0.0])
        assert d2["status"] == "TRACKING" and d2["map_points"] == live["map_points"]
        status, body = _get(port, "/")
        with open(os.path.join(REPO, "web", "viewer.html"), "rb") as f:
            assert status == 200 and body == f.read()
        status, body = _get(port, "/js/vio-client.js")
        assert status == 200 and b"setUint8(0, 0x03)" in body
        with pytest.raises(urllib.error.HTTPError):
            _get(port, "/../README.md")
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(JOIN_S)


# ---------------------------------------------------------------------------
# Failure detector and logging
# ---------------------------------------------------------------------------

def _fd_cases():
    """(name, window edits, last_p scale) for the nominal state and each
    threshold of tests/test_factors.py's TestFailureDetector."""
    q_rot = rot.quat_boxplus(torch.tensor([1.0, 0, 0, 0], dtype=torch.float64),
                             torch.tensor([0.0, 0.0, 1.2], dtype=torch.float64)).numpy()
    return [("nominal", {}, 1.0, None),
            ("big_acc_bias", {"ba": [3.0, 0, 0]}, 1.0, "big_acc_bias"),
            ("big_gyr_bias", {"bg": [0, 1.5, 0]}, 1.0, "big_gyr_bias"),
            ("big_translation", {"p": [6.0, 0, 0]}, 0.0, "big_translation"),
            ("big_z", {"p": [0, 0, 1.5]}, 0.0, "big_z"),
            ("big_rotation", {"q": list(q_rot)}, 1.0, "big_rotation")]


@pytest.mark.parametrize("name,edits,last_scale,fires", _fd_cases(),
                         ids=[c[0] for c in _fd_cases()])
def test_failure_detector_matches_reference(name, edits, last_scale, fires):
    wj = jstate.init_window(max_imu=8, dtype=jnp.float64)
    tj = jstate.init_feature_table(16, dtype=jnp.float64)
    wt = tstate.init_window(8, dtype=torch.float64, device="cpu")
    tt = tstate.init_feature_table(16, dtype=torch.float64, device="cpu")
    fid = np.full(16, -1, np.int32)
    fid[:5] = np.arange(5)
    tj = tj._replace(fid=jnp.asarray(fid))
    tt = tt._replace(fid=torch.as_tensor(fid))
    last_p, last_q = np.array(wj.p[-1]) * last_scale, np.array(wj.q[-1])
    for field, val in edits.items():
        wj = wj._replace(**{field: getattr(wj, field).at[-1].set(jnp.asarray(val))})
        a = getattr(wt, field).clone()
        a[-1] = torch.as_tensor(val, dtype=torch.float64)
        wt = wt._replace(**{field: a})
    want = jfd.detect_failure(wj, tj, jnp.asarray(last_p), jnp.asarray(last_q))
    got = fd.detect_failure(wt, tt, torch.as_tensor(last_p), torch.as_tensor(last_q))
    for f in fd.FailureReport._fields:
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    assert bool(got.failed) == (fires is not None)
    if fires:
        assert bool(getattr(got, fires))
    assert int(got.tracked_features) == 5


def test_logging_levels_and_frame_profiler(capsys):
    """Leveled logging, and per-stage times, which the span recorder (the
    frame profiler's successor) keeps for each stage span."""
    slog.info("hello from the port")
    slog.debug("hidden at the INFO level")
    err = capsys.readouterr().err
    assert "[INFO] test_torch_gateway.py:" in err and "hello from the port" in err
    assert "hidden" not in err
    rec = slog.Recorder()
    with rec.tracing():
        for _ in range(3):
            with rec.span("stream_frame"), rec.span("track"):
                time.sleep(0.002)
    spans = rec.drain()
    assert [s.name for s in spans] == ["track", "stream_frame"] * 3
    assert all(s.seconds >= 0.002 for s in spans)


def test_device_trace_on_cpu_writes_a_trace(tmp_path):
    """The trace holds the profiler's ops and the program's spans on a track
    of their own, on one clock: a span encloses the op run inside it."""
    with slog.device_trace(str(tmp_path / "trace"), device="cpu") as prof:
        with slog.span("outer_stage", index=7):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert not slog.RECORDER.on and slog.drain() == []
    path = tmp_path / "trace" / "trace.json"
    assert path.is_file()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    spans = [e for e in events if e.get("name") == "outer_stage"]
    assert mm and len(spans) == 1
    span = spans[0]
    assert span["ph"] == "X" and span["pid"] == slog.SPAN_TRACK and span["args"]["index"] == 7
    assert span["ts"] <= mm[0]["ts"] <= mm[0]["ts"] + mm[0]["dur"] <= span["ts"] + span["dur"]
    assert prof.key_averages() is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            with slog.device_trace(str(tmp_path / "none"), device="cuda"):
                pass
