"""Streaming speech-to-motion serving daemon.

Counterpart of ``diffsheg_tpu/serving/server.py``: a threaded TCP server
around :class:`diffsheg_tpu_torch.sampling.live.LiveSession`, one
connection = one live session; the client pushes captured audio chunks
and receives motion frames as each window becomes ready, with the same
numerics as the in-process session.

Protocol (framing in :mod:`diffsheg_tpu_torch.serving.protocol`):

  client -> {"type": "start", "speakers": [1,3], "seed": 0,
             "window_frames": 0, "overlap": 0, "retain": true}
  server -> {"type": "ready", "batch": B, "channels": C,
             "window": n_poses, "fps": fps, "sr": mel_sr,
             "hubert": bool}
  client -> {"type": "audio", "n": .., "n16": ..} + f32 payload   (repeat)
  server -> {"type": "motion", ...} + f32 (B,T,C) payload  (T may be 0)
  client -> {"type": "finish"}
  server -> {"type": "done", ...} + f32 full-session motion payload

Any server-side failure answers {"type": "error", "message": ...} and
closes the connection; other sessions are unaffected.  A session's
``seed`` is its noise, ``GeneratorNoise(seed, device)``.

Resource bounds against misbehaving clients: ``max_sessions`` caps
concurrent connections, ``max_batch`` the speakers (device batch) of a
session, ``idle_timeout`` reaps silent clients, ``max_stream_seconds``
caps a retaining session's stream (and a ``retain=False`` session's
backlog), and custom window geometries — each a new generator with its
own copy of the weights — are refused unless the operator opts in with
``client_geometry`` (the generator cache then holds at most
``max_cached_geometries``).

PyTorch's grad mode and current CUDA device are per thread: each handler
thread enters ``torch.no_grad()`` and the server's device itself.
"""

from __future__ import annotations

import contextlib
import socket
import socketserver
import threading
import time
import traceback
from typing import Optional

import numpy as np
import torch

from diffsheg_tpu_torch.device import DeviceLike, resolve_device
from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
from diffsheg_tpu_torch.sampling.live import LiveSession
from diffsheg_tpu_torch.serving import protocol as proto


class MotionServer:
    """Own the model and configuration and serve live sessions over TCP.

    ``model`` is any model of ``models/factory.py::build_denoiser``
    (``cfg.model`` describes it); sessions run on ``device``
    (default: the GPU).  Window generators are cached per (window,
    overlap) and shared across sessions — a generator is pure (the RePaint
    tails are threaded through arguments), so a reconnect with the same
    geometry reuses its cast weights and its fast-path weights.
    """

    def __init__(self, cfg, model, hubert_extractor=None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_sessions: int = 8, max_batch: int = 64,
                 idle_timeout: float = 600.0,
                 client_geometry: bool = False,
                 max_cached_geometries: int = 8,
                 max_stream_seconds: float = 3600.0, log=print,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model
        self.hubert_fe = hubert_extractor
        self.max_batch = max_batch
        self.idle_timeout = idle_timeout
        self.client_geometry = client_geometry
        self.max_cached_geometries = max_cached_geometries
        self.max_stream_seconds = max_stream_seconds
        self.log = log
        self._slots = threading.BoundedSemaphore(max_sessions)
        self._active = 0                   # live handler threads
        self._active_lock = threading.Lock()
        self._gens: dict = {}              # (window, overlap) -> generator
        self._pinned: set = set()          # prewarmed keys, never evicted
        self._gens_lock = threading.Lock()
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                outer._handle(self.request)

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server((host, port), _Handler)

    # -- lifecycle -----------------------------------------------------------
    @property
    def address(self):
        """(host, port) actually bound (port=0 picks a free one)."""
        return self._server.server_address

    def serve_forever(self):
        self.log(f"[serve] listening on {self.address[0]}:{self.address[1]}")
        self._server.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self, drain_seconds: float = 5.0):
        """Stop accepting, then give in-flight sessions a bounded grace
        period (handler threads are daemons: without the wait they die
        mid-frame at process exit)."""
        self._server.shutdown()
        deadline = time.monotonic() + drain_seconds
        while time.monotonic() < deadline:
            with self._active_lock:
                if self._active == 0:
                    break
            time.sleep(0.05)
        with self._active_lock:
            if self._active:
                self.log(f"[serve] {self._active} session(s) still active "
                         f"after {drain_seconds:g}s grace, closing anyway")
        self._server.server_close()

    def _thread_context(self):
        """What a thread that touches the model enters first: no autograd
        graph, and the server's device as the current CUDA device."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        if self.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.device))
        return stack

    def _one_hot(self, speakers) -> torch.Tensor:
        return torch.nn.functional.one_hot(
            torch.as_tensor(speakers, dtype=torch.long),
            self.cfg.model.style_dim).float().to(self.device)

    def _create(self, speakers, seed, **kw):
        """A session from the shared generator cache (caller holds
        ``_gens_lock``)."""
        return LiveSession.create(
            self.cfg, self.model, self._one_hot(speakers),
            GeneratorNoise(seed, self.device),
            hubert_extractor=self.hubert_fe, gen_cache=self._gens,
            device=self.device, **kw)

    def prewarm(self, batch_sizes=(1,), window_frames: int = 0,
                overlap: int = 0) -> None:
        """Before accepting clients: build the generator of the geometry
        (the weights cast and moved once, kept from eviction) and run a
        silent two-window session per batch size, which builds the
        fast-path weights and, on the card, the kernels, so the first real
        client meets none of that set-up."""
        with self._thread_context():
            for b in batch_sizes:
                with self._gens_lock:
                    s = self._create([0] * b, 0, window_frames=window_frames,
                                     overlap=overlap)
                    self._pinned.add((s.size, s.overlap))
                frames = s.size + s.step          # two windows' worth
                a16 = (np.zeros(int(np.ceil(frames / s.fps * 16000)),
                                np.float32)
                       if self.hubert_fe is not None else None)
                out = s.push(np.zeros((frames + 1) * s.hop, np.float32), a16)
                self.log(f"[serve] prewarmed batch={b} "
                         f"(window {s.size}, {out.shape[1]} frames)")

    def _evict_geometries(self, just_used) -> None:
        """Bound the generator cache (caller holds ``_gens_lock``):
        client-minted geometries go first in, first out past
        ``max_cached_geometries``; prewarmed keys and the one just used
        stay.  Sessions on an evicted generator keep their reference."""
        keep = self._pinned | {just_used}
        evictable = [k for k in self._gens if k not in keep]
        while evictable and len(self._gens) > self.max_cached_geometries:
            dropped = evictable.pop(0)
            del self._gens[dropped]
            self.log(f"[serve] evicted cached geometry {dropped}")

    # -- one connection = one session -----------------------------------------
    def _handle(self, sock: socket.socket) -> None:
        if not self._slots.acquire(blocking=False):
            # read the client's pending start frame before replying: a
            # close with unread data sends RST, which would discard the
            # queued error frame on the client side
            try:
                sock.settimeout(2.0)
                proto.recv_frame(sock)
            except (OSError, proto.ProtocolError):
                pass
            try:
                proto.send_frame(sock, {"type": "error",
                                        "message": "server at max_sessions"})
            except OSError:
                pass
            return
        with self._active_lock:
            self._active += 1
        try:
            sock.settimeout(self.idle_timeout)
            with self._thread_context():
                self._session_loop(sock)
        except TimeoutError:
            try:
                proto.send_frame(sock, {
                    "type": "error",
                    "message": f"idle for {self.idle_timeout}s, "
                               "closing session"})
            except OSError:
                pass
            self.log("[serve] reaped idle session")
        except proto.ProtocolError as e:
            self.log(f"[serve] protocol error: {e}")
        except Exception as e:  # noqa: BLE001 — report, keep serving
            try:
                proto.send_frame(sock, {"type": "error",
                                        "message": f"{type(e).__name__}: {e}"})
            except OSError:
                pass
            self.log(f"[serve] session failed:\n{traceback.format_exc()}")
        finally:
            with self._active_lock:
                self._active -= 1
            self._slots.release()

    def _refuse(self, sock, message: str) -> None:
        proto.send_frame(sock, {"type": "error", "message": message})

    def _session_loop(self, sock: socket.socket) -> None:
        header, _ = proto.recv_frame(sock)
        if header.get("type") != "start":
            return self._refuse(
                sock, f"expected start, got {header.get('type')!r}")
        cfg = self.cfg
        speakers = header.get("speakers", [0])
        if not isinstance(speakers, list) or not speakers or any(
                not isinstance(s, int) or isinstance(s, bool)
                or not 0 <= s < cfg.model.style_dim for s in speakers):
            return self._refuse(
                sock, f"speakers must be ints in [0, {cfg.model.style_dim}),"
                      f" got {speakers!r}")
        if len(speakers) > self.max_batch:
            return self._refuse(
                sock, f"{len(speakers)} speakers exceeds the server's "
                      f"max_batch={self.max_batch}")
        wf, ov = header.get("window_frames", 0), header.get("overlap", 0)
        if not all(isinstance(v, int) and not isinstance(v, bool)
                   and 0 <= v <= 4 * cfg.data.n_poses for v in (wf, ov)):
            return self._refuse(
                sock, f"window_frames/overlap must be ints in "
                      f"[0, {4 * cfg.data.n_poses}], got ({wf!r}, {ov!r})")
        if (wf, ov) != (0, 0) and not self.client_geometry:
            return self._refuse(
                sock, "this server only serves its default window geometry "
                      "(start with window_frames=0, overlap=0); run it with "
                      "client_geometry enabled (cli serve "
                      "--client-geometry) to accept custom windows")
        # retain=False: bounded-memory streaming — "motion" frames are the
        # only copy, "done" carries the tail, and the stream cap becomes a
        # backlog cap
        retain = header.get("retain", True)
        if not isinstance(retain, bool):
            return self._refuse(sock, f"retain must be a bool, got {retain!r}")
        try:
            with self._gens_lock:
                session = self._create(speakers, int(header.get("seed", 0)),
                                       window_frames=wf,
                                       overlap=ov, retain=retain)
                self._evict_geometries((session.size, session.overlap))
        except ValueError as e:      # degenerate geometry (step <= 0, ...)
            return self._refuse(sock, str(e))
        proto.send_frame(sock, {
            "type": "ready", "batch": len(speakers),
            "channels": session.channels, "window": session.size,
            "fps": cfg.data.fps, "sr": cfg.data.mel_sr,
            "hubert": self.hubert_fe is not None,
        })

        while True:
            header, payload = proto.recv_frame(sock)
            kind = header.get("type")
            if kind == "audio":
                a, a16 = proto.unpack_audio(header, payload)
                secs = a.size / session.sr
                if session.retain:
                    over = (session.duration + secs
                            > self.max_stream_seconds)
                    why = (f"stream exceeds this server's max_stream_seconds"
                           f"={self.max_stream_seconds:g}; finish and start "
                           'a new session (or start with "retain": false '
                           "for open-ended streaming)")
                else:
                    # retain=False is bounded only while windows consume
                    # the audio; bound a stalled session's backlog
                    allowance = ((session.size + 2 * session.step)
                                 / cfg.data.fps + self.max_stream_seconds)
                    over = session.buffered_seconds + secs > allowance
                    why = (f"unconsumed audio backlog exceeds "
                           f"{allowance:.0f}s (live window buffer + "
                           f"max_stream_seconds={self.max_stream_seconds:g})"
                           " — the session is stalled (16 kHz stream "
                           "lagging the mel-rate stream?)")
                if over:
                    return self._refuse(sock, why)
                mh, mp = proto.pack_motion(session.push(a, a16).numpy())
                proto.send_frame(sock, {"type": "motion", **mh}, mp)
            elif kind == "finish":
                mh, mp = proto.pack_motion(session.finish().numpy())
                proto.send_frame(sock, {"type": "done", **mh}, mp)
                return
            else:
                return self._refuse(sock, f"unknown message type {kind!r}")


class MotionClient:
    """Blocking client for :class:`MotionServer`; every socket operation
    carries ``timeout`` seconds."""

    def __init__(self, host: str, port: int, timeout: float = 600.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self.info: Optional[dict] = None

    def start(self, speakers, seed: int = 0, window_frames: int = 0,
              overlap: int = 0, retain: bool = True) -> dict:
        """``retain=False``: a bounded-memory open-ended session; each
        motion frame arrives once and "done" carries only the tail."""
        proto.send_frame(self._sock, {
            "type": "start", "speakers": list(speakers), "seed": seed,
            "window_frames": window_frames, "overlap": overlap,
            "retain": retain})
        header, _ = proto.recv_frame(self._sock)
        if header.get("type") != "ready":
            raise RuntimeError(f"server refused session: {header}")
        self.info = header
        return header

    def push(self, samples: np.ndarray,
             samples_16k: Optional[np.ndarray] = None) -> np.ndarray:
        h, p = proto.pack_audio(samples, samples_16k)
        proto.send_frame(self._sock, h, p)
        header, payload = proto.recv_frame(self._sock)
        if header.get("type") != "motion":
            raise RuntimeError(f"push failed: {header}")
        return proto.unpack_motion(header, payload)

    def finish(self) -> np.ndarray:
        proto.send_frame(self._sock, {"type": "finish"})
        header, payload = proto.recv_frame(self._sock)
        if header.get("type") != "done":
            raise RuntimeError(f"finish failed: {header}")
        return proto.unpack_motion(header, payload)

    def close(self):
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
