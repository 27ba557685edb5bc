"""Spans around the benchmark's own calls, and the reading of a
``torch.profiler`` trace.

:class:`Tracer` records a span as a ``record_function`` range while it is
tracing and does nothing otherwise.  :func:`read_chrome_trace` turns the
profiler's Chrome trace into a :class:`TraceView`: the device's
operations (kernels, copies, sets) with the host time of their launch,
and the benchmark's spans.  Host and device times share the profiler's
clock (microseconds in the file, seconds here).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "bench/"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class DeviceOp:
    name: str
    start: float
    end: float
    launch: Optional[float]   # host time of the launch, if the trace has it


@dataclass
class TraceView:
    ops: List[DeviceOp]
    spans: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)

    def window(self) -> Tuple[float, float]:
        """The traced window: the ``bench/traced`` span."""
        return self.spans["traced"][0]

    def busy_intervals(self, lo: float, hi: float) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, cut to [lo, hi]."""
        out: List[Tuple[float, float]] = []
        for op in sorted(self.ops, key=lambda o: o.start):
            a, b = max(op.start, lo), min(op.end, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy(self, lo: float, hi: float) -> float:
        return sum(b - a for a, b in self.busy_intervals(lo, hi))

    def gaps(self, lo: float, hi: float) -> List[Tuple[float, float]]:
        """The device's idle intervals inside [lo, hi]."""
        out, t = [], lo
        for a, b in self.busy_intervals(lo, hi):
            if a > t:
                out.append((t, a))
            t = b
        if hi > t:
            out.append((t, hi))
        return out

    def launched_in(self, span: str) -> List[DeviceOp]:
        """The device operations launched inside any ``span``."""
        iv = sorted(self.spans.get(span, []))
        starts = [a for a, _ in iv]
        out = []
        for op in self.ops:
            if op.launch is None:
                continue
            i = bisect.bisect_right(starts, op.launch) - 1
            if i >= 0 and op.launch <= iv[i][1]:
                out.append(op)
        return out

    def named(self, patterns) -> List[DeviceOp]:
        return [op for op in self.ops if any(p in op.name for p in patterns)]

    def innermost_span(self, t: float) -> str:
        """The shortest benchmark span open at host time ``t``."""
        best, length = "outside spans", float("inf")
        for name, iv in self.spans.items():
            for a, b in iv:
                if a <= t <= b and b - a < length:
                    best, length = name, b - a
        return best


def read_chrome_trace(path: str) -> TraceView:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches, spans, raw = {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = e["ts"] * 1e-6, e.get("dur", 0) * 1e-6
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            spans.setdefault(e["name"][len(SPAN_PREFIX):], []).append(
                (ts, ts + dur))
        elif cat in DEVICE_CATS:
            raw.append((e["name"], ts, ts + dur,
                        e.get("args", {}).get("correlation")))
    ops = [DeviceOp(n, a, b, launches.get(c)) for n, a, b, c in raw]
    return TraceView(ops, spans)


class Tracer:
    """Spans, and the profiler over the traced part of a run."""

    def __init__(self, enabled: bool, out_dir: str):
        self.enabled = enabled
        self.out_dir = out_dir
        self.active = False
        self._prof = None
        self._traced = None

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(SPAN_PREFIX + name)

    def start(self) -> None:
        import torch
        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        # the profiler can drop a long process's first device records:
        # let a short spin take them, before the traced window opens
        torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
        self.active = True
        self._traced = self.span("traced")
        self._traced.__enter__()

    def stop(self) -> TraceView:
        import torch
        torch.cuda.synchronize()
        self._traced.__exit__(None, None, None)
        self.active = False
        self._prof.__exit__(None, None, None)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        try:
            return read_chrome_trace(path)
        finally:
            os.unlink(path)


def breakdown(view: TraceView) -> dict:
    """The ten device operations that took most time, by name, and the ten
    longest idle gaps, each named by the benchmark span the host was in
    when the gap began."""
    lo, hi = view.window()
    by_name: Dict[str, float] = {}
    for op in view.ops:
        a, b = max(op.start, lo), min(op.end, hi)
        if b > a:
            by_name[op.name] = by_name.get(op.name, 0.0) + b - a
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(view.gaps(lo, hi), key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[view.innermost_span(a), b - a] for a, b in gaps]}
