"""Device calibration probe: prove the card is what it claims to be.

Counterpart of ``diffsheg_tpu/utils/calibration.py`` with CUDA semantics.
A timing is trusted only when a computation was timed on the card and its
result was forced back to the host with a bounded wait (a broken device
path shows as a hang).  Three probes, checked against a physical envelope
for the device's name (``torch.cuda.get_device_name``):

1. dispatch: a trivial op on the card with a full readback to the host ->
   round-trip ms, the minimum of 5;
2. compute: ``chain`` chained ``n x n`` bf16 products (``torch.matmul``:
   the JAX probe is an XLA ``dot``, not a Pallas kernel), timed with CUDA
   events around the chain, a small slice read back with a bounded wait
   and its value checked (ones times ``1/n`` ones is exactly 1.0) ->
   sustained TFLOP/s;
3. bandwidth (``doctor --calibrate``): 8 MiB from pageable host memory to
   the card and back -> MB/s each way.

Which program ran where.  JAX decides it by the host CPU a blocking call
burns (:func:`host_cpu_fraction`): a program on the device leaves the host
idle.  On CUDA that does not carry over: ``torch.cuda.synchronize()``
spin-waits, and a host-bound program on the card legitimately burns host
CPU (the port's live and test-stream paths leave the card idle most of a
call).  So the per-program discriminator here is what the card itself
records: :func:`device_activity` runs one call under ``torch.profiler``
with CUDA activity and counts the kernels the card ran.  The limit is
:data:`MIN_DEVICE_KERNELS`: a program that ran no kernel on the card, or
whose outputs are not on the card, did not run there.  The host CPU
fraction is printed beside it with no limit (it is read with a blocking
CUDA event, so a device-bound program shows near 0 and a host-bound one
near 1; both are legitimate).

JAX's load-time signature check (``CPU_AOT_SIGNATURE``, an XLA:CPU
executable behind a TPU label) is JAX-only and has no counterpart here;
:func:`scan_stderr`, its generic fd-level tee of stderr, is kept.

Consumers: ``utils/benchguard.py`` (a benchmark refuses to certify a
throughput number when calibration fails) and ``cli doctor --calibrate``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

# The per-program limit of device_activity(): at least this many kernels
# recorded by the card during one call.  A program whose tensors live on
# the host runs none; any program of the port's on the card runs hundreds.
MIN_DEVICE_KERNELS = 1
# spin kernels before the call in device_activity's profile (not counted)
PROFILE_PAD_KERNELS = 1024


def wait_blocking() -> None:
    """Wait for the current CUDA stream with a blocking event (the host
    thread sleeps rather than spins); no-op before CUDA is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        ev = torch.cuda.Event(blocking=True)
        ev.record()
        ev.synchronize()


def host_cpu_fraction(run_once) -> Tuple[float, float]:
    """Time one synchronous call and return ``(wall_s, host_cpu_frac)``:
    process CPU seconds (all threads) over wall seconds for the call.
    ``run_once`` must block until its result is ready (on CUDA, with
    :func:`wait_blocking`)."""
    c0 = time.process_time()
    t0 = time.perf_counter()
    run_once()
    wall = time.perf_counter() - t0
    cpu = time.process_time() - c0
    return wall, (cpu / wall if wall > 0 else 0.0)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


@dataclasses.dataclass
class DeviceActivity:
    """What one call did: host wall and CPU share, and what the card
    recorded (kernels, their busy time) while it ran."""
    wall_s: float
    host_cpu_frac: float
    kernels: int
    device_busy_s: float
    outputs_on_card: bool

    @property
    def busy_share(self) -> float:
        return self.device_busy_s / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def on_card(self) -> bool:
        return self.kernels >= MIN_DEVICE_KERNELS and self.outputs_on_card

    def line(self) -> str:
        return (f"kernels={self.kernels} (limit >= {MIN_DEVICE_KERNELS}) "
                f"outputs_on_card={self.outputs_on_card} "
                f"wall={self.wall_s * 1e3:.1f} ms "
                f"device_busy={self.busy_share:.3f} "
                f"host_cpu_frac={self.host_cpu_frac:.3f}")


def _busy_seconds(intervals) -> float:
    """Length of the union of (start_us, end_us) intervals, in seconds."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total * 1e-6


def device_activity(call: Callable[[], object]) -> DeviceActivity:
    """Run ``call`` twice: once timed alone (wall and host CPU share,
    waited for with a blocking event), once under ``torch.profiler`` with
    CUDA activity only, counting the kernels the card ran and the union of
    their device intervals.  Memory copies and fills are not kernels.
    Without a card nothing is recorded: no kernel ran on one.  Inside
    the profiled window the call is preceded by
    :data:`PROFILE_PAD_KERNELS` spin kernels, which are not counted: once
    a process has run for a minute or more the profiler loses the first
    device records of a session, more the longer the process has run (on
    an H100: all 3 kernels of a 0.3 ms call from 42 s on, 23 of 6000
    launches at 300 s), so the records it loses are the padding's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = []
    wall, frac = host_cpu_fraction(lambda: (out.append(call()),
                                            wait_blocking()))
    outs = list(_tensors(out[0]))
    on_card = bool(outs) and all(t.is_cuda for t in outs)
    if not torch.cuda.is_available():
        return DeviceActivity(wall, frac, 0, 0.0, on_card)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD_KERNELS):
            torch.cuda._sleep(1)
        call()
        wait_blocking()
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))
               and "spin_kernel" not in e.name]
    busy = _busy_seconds((e.time_range.start, e.time_range.end)
                         for e in kernels)
    return DeviceActivity(wall, frac, len(kernels), busy, on_card)


class StderrScan:
    """Live fd-level TEE of stderr for the duration of a ``with`` block:
    everything still reaches the real stderr in real time while a copy
    accumulates for ``found(pattern)`` / ``count(pattern)``.  Native
    libraries write straight to fd 2, which Python-level ``sys.stderr``
    redirection cannot see; this works at the fd level (dup2 onto a pipe,
    a pump thread tees to the saved fd)."""

    def __init__(self):
        self.text = ""
        self._chunks: list = []

    def found(self, pattern: str) -> bool:
        return pattern in self.text

    def count(self, pattern: str) -> int:
        return self.text.count(pattern)


@contextlib.contextmanager
def scan_stderr():
    scan = StderrScan()
    sys.stderr.flush()
    saved = os.dup(2)
    r, w = os.pipe()
    os.dup2(w, 2)
    os.close(w)  # fd 2 is now the pipe's only write end

    def pump():
        while True:
            try:
                data = os.read(r, 65536)
            except OSError:
                break
            if not data:
                break
            scan._chunks.append(data)
            try:
                os.write(saved, data)  # live tee to the real stderr
            except OSError:
                pass

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    try:
        yield scan
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)  # closes the pipe's write end -> pump sees EOF
        th.join(5.0)
        os.close(saved)
        try:
            os.close(r)
        except OSError:
            pass
        scan.text = b"".join(scan._chunks).decode("utf-8",
                                                  errors="replace")


# Sustained bf16 TFLOP/s envelope per device name, prefix-matched in order
# (the PCIe card before the generic H100 prefix).  Peaks: NVIDIA H100 data
# sheet, dense bf16 tensor-core rate: SXM5 989 TFLOP/s, PCIe 756.  The
# lower bound is loose (a card at a low power limit still passes) while
# staying ~10x above anything a host CPU can reach; the upper bound is the
# peak itself, since a rate above it means the timing path is broken.
_ENVELOPES = {
    "NVIDIA H100 PCIe": (50.0, 760.0),
    "NVIDIA H100": (50.0, 1000.0),
}
_DEFAULT_ENVELOPE = (5.0, 2500.0)


@dataclasses.dataclass
class CalibrationResult:
    ok: bool
    reason: str                      # one line; "" when ok
    backend: str = ""
    device_kind: str = ""
    calib_tflops: float = 0.0        # sustained, chained-product probe
    dispatch_ms: float = 0.0         # trivial-op round trip, min of reps
    h2d_mbps: float = 0.0            # 0.0 when bandwidth probe skipped
    d2h_mbps: float = 0.0

    def json_fields(self) -> dict:
        f = {
            "backend": self.backend,
            "device_kind": self.device_kind,
            "calib_tflops": round(self.calib_tflops, 2),
            "dispatch_ms": round(self.dispatch_ms, 2),
            "valid": self.ok,
        }
        if not self.ok:
            f["invalid_reason"] = self.reason
        return f


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _readback(x, timeout: float) -> Optional[np.ndarray]:
    """``x`` (a tensor, an array-like, or a function returning one) on
    the host, in a daemon thread with a bounded wait.  Returns None on
    timeout (the thread is abandoned: the probe is about to fail)."""
    box: dict = {}

    def go():
        try:
            box["v"] = _host(x() if callable(x) else x)
        except Exception as e:  # noqa: BLE001 — surfaced as a probe failure
            box["e"] = e

    th = threading.Thread(target=go, daemon=True)
    th.start()
    th.join(timeout)
    if th.is_alive():
        return None
    if "e" in box:
        raise box["e"]
    return box["v"]


def envelope_for(device_kind: str) -> Tuple[float, float]:
    for prefix, env in _ENVELOPES.items():
        if device_kind.startswith(prefix):
            return env
    return _DEFAULT_ENVELOPE


def calibrate(n: int = 4096, chain: int = 50, reps: int = 3,
              first_timeout: float = 600.0, timeout: float = 120.0,
              bandwidth: bool = False, allow_cpu: bool = False,
              device=None) -> CalibrationResult:
    """Run the calibration probes on ``device`` (default the card).

    ``device="cpu"``: no envelope to enforce, ``ok`` only with
    ``allow_cpu`` (tests, local smoke runs).  Without a card the result
    is not ok.  ``first_timeout`` bounds the first call (cuBLAS set-up),
    ``timeout`` each later readback.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return CalibrationResult(
            ok=allow_cpu, backend="cpu", device_kind="cpu",
            reason="" if allow_cpu else "backend is cpu — not a GPU "
                                        "measurement")
    if not torch.cuda.is_available():
        return CalibrationResult(
            ok=False, backend="cuda", reason="CUDA is not available")
    kind = torch.cuda.get_device_name(dev)
    res = CalibrationResult(ok=True, reason="", backend="cuda",
                            device_kind=kind)

    def fail(reason: str) -> CalibrationResult:
        res.ok, res.reason = False, reason
        return res

    # --- probe 1: dispatch round trip -----------------------------------
    # (the ops run on this thread, where the CUDA context is current; only
    # the readback waits in the side thread)
    x_small = torch.zeros(8, device=dev)
    if _readback(x_small + 1.0, first_timeout) is None:
        return fail(f"dispatch-probe readback hung >{first_timeout:.0f}s")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        got = _readback(x_small + 1.0, timeout)
        times.append(time.perf_counter() - t0)
        if got is None:
            return fail(f"dispatch readback hung >{timeout:.0f}s")
    res.dispatch_ms = min(times) * 1e3

    # --- probe 2: sustained bf16 product throughput ---------------------
    a = torch.ones(n, n, dtype=torch.bfloat16, device=dev)
    b = torch.full((n, n), 1.0 / n, dtype=torch.bfloat16, device=dev)

    def chained():
        c = a
        for _ in range(chain):
            c = torch.matmul(c, b)
        return c

    if _readback(chained()[:1, :1], first_timeout) is None:
        return fail(f"product readback hung >{first_timeout:.0f}s")
    best, val = float("inf"), None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        c = chained()
        end.record()
        val = _readback(c[:1, :1], timeout)
        if val is None:
            return fail(f"product readback hung >{timeout:.0f}s")
        best = min(best, start.elapsed_time(end) * 1e-3)
    res.calib_tflops = 2.0 * n ** 3 * chain / best / 1e12
    # value check: ones times (1/n)-ones is exactly 1.0 at every link — a
    # device path returning zeros or garbage fails even if timing looks sane
    if not np.all(val == 1.0):
        return fail(f"product value check failed (got {val!r}, want 1.0)")

    lo, hi = envelope_for(kind)
    if not lo <= res.calib_tflops <= hi:
        return fail(f"calibrated {res.calib_tflops:.1f} TFLOP/s outside "
                    f"[{lo:.0f}, {hi:.0f}] envelope for {kind!r} — "
                    + ("impossibly fast: timing path broken"
                       if res.calib_tflops > hi else "too slow"))

    # --- probe 3: host <-> device bandwidth (doctor only) ---------------
    if bandwidth:
        mb = 8.0
        host = torch.from_numpy(
            np.zeros(int(mb * 1024 * 1024 // 4), np.float32))
        t0 = time.perf_counter()
        on_dev = host.to(dev)
        wait_blocking()
        res.h2d_mbps = mb / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        if _readback(on_dev, timeout) is None:
            return fail(f"bandwidth readback hung >{timeout:.0f}s")
        res.d2h_mbps = mb / (time.perf_counter() - t0)
    return res
