"""Minimal dependency-free WebSocket (RFC 6455) server/client transport —
the port's copy of web/ws.py, so that the port's gateway imports nothing
from the JAX package's side of the repo.

The browser streams binary frames and IMU over a WebSocket to the host
gateway (mobile_slam_tpu_torch/web/gateway.py), which owns the engine.
This module is the framing layer — handshake, mask/unmask, fragmentation,
ping/pong, close — enough for browsers and for an in-process client; no
package beyond numpy.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct

import numpy as np

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = (
    0x0, 0x1, 0x2, 0x8, 0x9, 0xA)


class WebSocketError(Exception):
    pass


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise WebSocketError("connection closed")
        buf += chunk
    return buf


def _apply_mask(payload: bytes, mask: bytes) -> bytes:
    """XOR ``payload`` with the 4-byte ``mask`` repeated (RFC 6455 §5.3), as
    one numpy operation: a 640x480 frame is 300 KB, one Python-level step
    per byte in a loop."""
    n = len(payload)
    if not n:
        return b""
    data = np.frombuffer(payload, np.uint8)
    key = np.frombuffer(mask * ((n + 3) // 4), np.uint8)[:n]
    return (data ^ key).tobytes()


class WebSocketConnection:
    """One established WebSocket. `is_client` controls masking (clients
    MUST mask, servers MUST NOT — RFC 6455 §5.3)."""

    def __init__(self, sock: socket.socket, is_client: bool = False):
        self.sock = sock
        self.is_client = is_client

    # -- frame layer ----------------------------------------------------

    def _send_frame(self, opcode: int, payload: bytes) -> None:
        header = bytearray([0x80 | opcode])
        n = len(payload)
        mask_bit = 0x80 if self.is_client else 0x00
        if n < 126:
            header.append(mask_bit | n)
        elif n < (1 << 16):
            header.append(mask_bit | 126)
            header += struct.pack(">H", n)
        else:
            header.append(mask_bit | 127)
            header += struct.pack(">Q", n)
        if self.is_client:
            mask = os.urandom(4)
            header += mask
            payload = _apply_mask(payload, mask)
        self.sock.sendall(bytes(header) + payload)

    def _recv_frame(self):
        b0, b1 = _recv_exact(self.sock, 2)
        fin = bool(b0 & 0x80)
        opcode = b0 & 0x0F
        masked = bool(b1 & 0x80)
        n = b1 & 0x7F
        if n == 126:
            (n,) = struct.unpack(">H", _recv_exact(self.sock, 2))
        elif n == 127:
            (n,) = struct.unpack(">Q", _recv_exact(self.sock, 8))
        mask = _recv_exact(self.sock, 4) if masked else None
        payload = _recv_exact(self.sock, n) if n else b""
        if mask:
            payload = _apply_mask(payload, mask)
        return fin, opcode, payload

    # -- message layer --------------------------------------------------

    def send(self, data: bytes | str) -> None:
        if isinstance(data, str):
            self._send_frame(OP_TEXT, data.encode())
        else:
            self._send_frame(OP_BINARY, bytes(data))

    def recv(self):
        """Next data message as (is_text, payload). Handles continuation
        frames and answers pings transparently. Returns (None, None) on
        close."""
        opcode0 = None
        buf = b""
        while True:
            fin, opcode, payload = self._recv_frame()
            if opcode == OP_PING:
                self._send_frame(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                try:
                    self._send_frame(OP_CLOSE, b"")
                except OSError:
                    pass
                return None, None
            if opcode in (OP_TEXT, OP_BINARY):
                opcode0 = opcode
                buf = payload
            elif opcode == OP_CONT:
                buf += payload
            else:
                raise WebSocketError(f"unexpected opcode {opcode}")
            if fin:
                return opcode0 == OP_TEXT, buf

    def close(self) -> None:
        try:
            self._send_frame(OP_CLOSE, b"")
        except OSError:
            pass
        self.sock.close()


def accept_handshake(sock: socket.socket) -> WebSocketConnection:
    """Server side: read the HTTP Upgrade request, answer 101."""
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(4096)
        if not chunk:
            raise WebSocketError("client hung up during handshake")
        data += chunk
        if len(data) > 65536:
            raise WebSocketError("oversized handshake")
    head = data.split(b"\r\n\r\n", 1)[0].decode("latin-1")
    key = None
    for line in head.split("\r\n")[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            if k.strip().lower() == "sec-websocket-key":
                key = v.strip()
    if not key:
        sock.sendall(b"HTTP/1.1 400 Bad Request\r\n\r\n")
        raise WebSocketError("not a websocket upgrade")
    accept = base64.b64encode(
        hashlib.sha1((key + GUID).encode()).digest()).decode()
    sock.sendall(
        ("HTTP/1.1 101 Switching Protocols\r\n"
         "Upgrade: websocket\r\n"
         "Connection: Upgrade\r\n"
         f"Sec-WebSocket-Accept: {accept}\r\n\r\n").encode())
    return WebSocketConnection(sock, is_client=False)


def connect(host: str, port: int, path: str = "/") -> WebSocketConnection:
    """Client side (the tests and in-process clients use it)."""
    sock = socket.create_connection((host, port))
    key = base64.b64encode(os.urandom(16)).decode()
    sock.sendall(
        (f"GET {path} HTTP/1.1\r\n"
         f"Host: {host}:{port}\r\n"
         "Upgrade: websocket\r\n"
         "Connection: Upgrade\r\n"
         f"Sec-WebSocket-Key: {key}\r\n"
         "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(4096)
        if not chunk:
            raise WebSocketError("server hung up during handshake")
        data += chunk
    status = data.split(b"\r\n", 1)[0]
    if b"101" not in status:
        raise WebSocketError(f"handshake rejected: {status!r}")
    expected = base64.b64encode(
        hashlib.sha1((key + GUID).encode()).digest()).decode()
    if expected.encode() not in data:
        raise WebSocketError("bad Sec-WebSocket-Accept")
    return WebSocketConnection(sock, is_client=True)
