"""Wire protocol for the motion serving daemon.

One frame = an 8-byte little-endian prefix ``(header_len, payload_len)``,
a UTF-8 JSON header, then an optional raw payload.  Audio payloads are
float32 PCM; motion payloads are float32 ``(B, T, C)`` row-major.  The
framing is symmetric — both sides speak it — so the client and tests
reuse these helpers verbatim.

The port's own copy of ``diffsheg_tpu/serving/protocol.py``: the same
frames, so a client of either server speaks to both.  This is the
deployment surface around
:class:`diffsheg_tpu_torch.sampling.live.LiveSession`.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Dict, Optional, Tuple

import numpy as np

_PREFIX = struct.Struct("<II")
MAX_HEADER = 1 << 20          # 1 MiB of JSON is already absurd
MAX_PAYLOAD = 1 << 30         # 1 GiB guards against corrupt prefixes


class ProtocolError(RuntimeError):
    pass


def read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ProtocolError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock: socket.socket, header: Dict,
               payload: bytes = b"") -> None:
    h = json.dumps(header, separators=(",", ":")).encode()
    sock.sendall(_PREFIX.pack(len(h), len(payload)) + h + payload)


def recv_frame(sock: socket.socket) -> Tuple[Dict, bytes]:
    hlen, plen = _PREFIX.unpack(read_exact(sock, _PREFIX.size))
    if hlen > MAX_HEADER or plen > MAX_PAYLOAD:
        raise ProtocolError(f"frame too large ({hlen}, {plen})")
    header = json.loads(read_exact(sock, hlen).decode())
    payload = read_exact(sock, plen) if plen else b""
    return header, payload


def pack_motion(motion: np.ndarray) -> Tuple[Dict, bytes]:
    m = np.ascontiguousarray(motion, dtype=np.float32)
    if m.ndim != 3:
        raise ProtocolError(f"motion must be (B, T, C), got {m.shape}")
    return ({"batch": m.shape[0], "frames": m.shape[1],
             "channels": m.shape[2]}, m.tobytes())


def unpack_motion(header: Dict, payload: bytes) -> np.ndarray:
    shape = (header["batch"], header["frames"], header["channels"])
    want = int(np.prod(shape)) * 4
    if len(payload) != want:
        raise ProtocolError(
            f"motion payload {len(payload)} bytes, shape {shape} needs {want}")
    return np.frombuffer(payload, dtype=np.float32).reshape(shape)


def pack_audio(samples: np.ndarray,
               samples_16k: Optional[np.ndarray] = None) -> Tuple[Dict, bytes]:
    a = np.ascontiguousarray(np.ravel(samples), dtype=np.float32)
    if samples_16k is None:
        return {"type": "audio", "n": a.size, "n16": 0}, a.tobytes()
    b = np.ascontiguousarray(np.ravel(samples_16k), dtype=np.float32)
    return ({"type": "audio", "n": a.size, "n16": b.size},
            a.tobytes() + b.tobytes())


def unpack_audio(header: Dict, payload: bytes
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    n, n16 = int(header["n"]), int(header.get("n16", 0))
    if len(payload) != (n + n16) * 4:
        raise ProtocolError(
            f"audio payload {len(payload)} bytes for n={n} n16={n16}")
    flat = np.frombuffer(payload, dtype=np.float32)
    a = flat[:n]
    return a, (flat[n:] if n16 else None)
