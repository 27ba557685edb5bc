"""Serving-capacity probe: N concurrent real-time sessions on one card.

Counterpart of ``examples/serve_capacity.py``.  Starts the port's
``serving.MotionServer`` in-process (BEAT at full width, bf16, no HuBERT,
``jump_n_sample`` 2: the per-layer kernel), connects N ``MotionClient``s
and has each push 100 ms audio chunks at real-time pace for --secs
seconds.  Each session is a thread of the server that launches its own
window's kernels; they share the card window by window, and capacity is
reached when the sessions fall behind real time.  On the port one window
leaves the card idle for most of its time (the host drives each launch),
so the host is expected to saturate first.

Per row (N sessions) this prints one JSON line:
  - ``rt_factor``: aggregate audio-seconds processed per wall-second
    (N when everyone keeps up; < N when the server saturates),
  - ``push_p95_ms`` / ``push_max_ms``: per-push service time across all
    sessions (a push that completes a window blocks for that window's
    compute + queueing; the rest are ~network-only),
  - ``rt_ok``: every session finished its stream within 5% of real time.

Usage: python -m diffsheg_tpu_torch.examples.serve_capacity [--secs 16]
       [--sessions 1,4,8,16] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time

import numpy as np

from diffsheg_tpu_torch.config import beat_config
from diffsheg_tpu_torch.examples import add_device_arg, script_device
from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
from diffsheg_tpu_torch.serving.server import MotionClient, MotionServer


def make_config():
    cfg = beat_config()
    return cfg.replace(
        diffusion=dataclasses.replace(cfg.diffusion, jump_n_sample=2),
        # per-window live dispatches are latency-bound; the per-layer
        # kernel is the serving path here (see live_latency.py)
        model=dataclasses.replace(cfg.model, compute_dtype="bfloat16",
                                  add_hubert=False),
    )


def session_audio(secs: int, chunk_s: float, sr: int) -> np.ndarray:
    """Every session's stream: (n_chunks, chunk) of seeded noise."""
    chunk = int(sr * chunk_s)
    n_chunks = int(secs / chunk_s)
    rng = np.random.RandomState(0)
    return (0.1 * rng.randn(n_chunks, chunk)).astype(np.float32)


def run_row(n_sessions: int, secs: int, chunk_s: float, port: int,
            sr: int, style_dim: int):
    audio = session_audio(secs, chunk_s, sr)
    n_chunks = len(audio)

    results = [None] * n_sessions

    def worker(idx: int):
        services = []
        try:
            with MotionClient("127.0.0.1", port) as cli:
                cli.start(speakers=[idx % style_dim], seed=idx)
                t_start = time.perf_counter()
                for k in range(n_chunks):
                    target = t_start + k * chunk_s
                    now = time.perf_counter()
                    if now < target:
                        time.sleep(target - now)
                    t0 = time.perf_counter()
                    cli.push(audio[k])
                    services.append(time.perf_counter() - t0)
                push_wall = time.perf_counter() - t_start
                t0 = time.perf_counter()
                cli.finish()
                drain = time.perf_counter() - t0
            results[idx] = (push_wall, drain, services)
        except Exception as e:  # surface the root cause, don't mask it
            results[idx] = e

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    errors = [r for r in results if isinstance(r, Exception)]
    if errors:
        raise RuntimeError(
            f"{len(errors)}/{n_sessions} sessions failed; first: "
            f"{errors[0]!r}")

    # a session keeps up when the paced push loop never falls behind the
    # capture cadence: its wall equals the stream length (+ margin); the
    # final drain (tail windows at finish) is reported separately
    walls = [r[0] for r in results]
    drains = [r[1] for r in results]
    services = np.array([s for r in results for s in r[2]])
    audio_secs = n_sessions * secs
    row = {
        "sessions": n_sessions,
        "stream_secs": secs,
        "rt_factor": round(audio_secs / max(walls), 2),
        "push_p50_ms": round(float(np.percentile(services, 50)) * 1e3, 1),
        "push_p95_ms": round(float(np.percentile(services, 95)) * 1e3, 1),
        "push_max_ms": round(float(services.max()) * 1e3, 1),
        "drain_max_ms": round(max(drains) * 1e3, 1),
        "rt_ok": bool(max(walls) <= secs * 1.05),
    }
    print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--secs", type=int, default=16)
    ap.add_argument("--sessions", default="1,4,8,16")
    ap.add_argument("--chunk-ms", type=int, default=100)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = script_device(args.device)

    cfg = make_config()
    model = init_unidiffuser(cfg.model, seed=0)
    sizes = [int(s) for s in args.sessions.split(",")]
    server = MotionServer(cfg, model, max_sessions=max(sizes) + 1,
                          log=lambda *a, **k: None, device=device)
    server.start_background()
    port = server.address[1]
    sr = cfg.data.mel_sr

    try:
        # full-length warmup session: builds every kernel and the fast-path
        # weights a measured session will use (window, continuation and
        # the finish/tail drain), so the rows time steady-state serving
        run_row(1, args.secs, args.chunk_ms / 1e3, port, sr,
                cfg.model.style_dim)
        print("# warmup row above (includes kernel builds); measured rows:",
              flush=True)

        for n in sizes:
            run_row(n, args.secs, args.chunk_ms / 1e3, port, sr,
                    cfg.model.style_dim)
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
