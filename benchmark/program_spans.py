"""The program's own spans, placed on the device trace's clock.

The port records a span (``diffsheg_tpu_torch/utils/profiling.py``) only
while a profiler records, so in a traced run its records are exactly the
traced clips'.  Their times are ``time.perf_counter_ns()``; the view's
are the profiler's.  :func:`program_view` pairs the records with the
benchmark's spans that wrap the same calls, in start order: the two
``frontend.*`` records of a clip with ``frontend`` and each ``sampler``
record with ``sampler``.  A benchmark span opens before and closes after
the program's span inside it, so the offset (view clock - record clock)
lies at or above every pair's (view start - record start) and at or
below every pair's (view end - record end).  The offset taken is the
largest of the first: the pair whose span opened soonest after the
benchmark's.  It places every record in the view, beside the benchmark's
spans, so ``launched_in`` and ``busy`` read them.  Counts that differ,
or bounds that leave no offset (a record outside its benchmark span),
give None.

Each pair's (view start - record start) is the offset less the host's
time from the benchmark's range to the program's span: 5-67 us on an
NVIDIA H100 80GB HBM3 machine, differing by site (``sampler`` 29-44 us
behind ``frontend.mel``) and from clip to clip (HuBERT's pairs up to 52
us apart), so a median of them, or a limit on their spread, misplaces or
drops the spans.  The largest lies 5-12 us below the least offset that
puts each branch kernel's launch inside its ``launch.fused_branch``
record.

A program without the recorder (an older checkout) has nothing to read:
every function here then returns None.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Tuple

from benchmark.tracing import TraceView

# each benchmark span, and the program spans its calls open
PAIRED = {"frontend": ("frontend.mel", "frontend.hubert"),
          "sampler": ("sampler",)}


def records() -> Optional[list]:
    """The program's span records, or None where it records none."""
    try:
        from diffsheg_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return None
    return recorded_spans() or None


def bounds(view: TraceView, recs) -> Optional[Tuple[float, float]]:
    """The least and the most offset (view clock - record clock, seconds)
    that keep each program span inside the benchmark's span around the
    same call; None where a benchmark span and its program spans differ in
    number."""
    lo, hi = -math.inf, math.inf
    for bench, names in PAIRED.items():
        rs = sorted((r for r in recs if r.name in names),
                    key=lambda r: r.start_ns)
        iv = sorted(view.spans.get(bench, []))
        if not rs or len(rs) != len(iv):
            return None
        for (a, b), r in zip(iv, rs):
            lo = max(lo, a - r.start_ns * 1e-9)
            hi = min(hi, b - r.end_ns * 1e-9)
    return lo, hi


def program_view(view: TraceView) -> Optional[TraceView]:
    """``view`` with the program's spans beside the benchmark's, by name
    (where both have a name, ``sampler``, the benchmark's stays); None
    where the records cannot be placed."""
    recs = records()
    if recs is None:
        return None
    b = bounds(view, recs)
    if b is None or b[0] > b[1]:
        return None
    off = b[0]
    spans: Dict[str, List[Tuple[float, float]]] = {}
    for r in recs:
        spans.setdefault(r.name, []).append(
            (r.start_ns * 1e-9 + off, r.end_ns * 1e-9 + off))
    return TraceView(view.ops, {**spans, **view.spans})


def idle_seconds(view: TraceView, intervals) -> float:
    """The device's idle seconds inside ``intervals`` (sorted or not): one
    pass over the device's busy intervals, then a bisection a span."""
    if not intervals:
        return 0.0
    lo = min(a for a, _ in intervals)
    hi = max(b for _, b in intervals)
    busy = view.busy_intervals(lo, hi)
    starts = [a for a, _ in busy]
    before = [0.0]          # busy seconds before each busy interval
    for a, b in busy:
        before.append(before[-1] + b - a)

    def busy_until(t):      # busy seconds in [lo, t]
        i = bisect.bisect_right(starts, t)
        if i == 0:
            return 0.0
        a, b = busy[i - 1]
        return before[i - 1] + min(b, t) - a

    return sum((b - a) - (busy_until(b) - busy_until(a))
               for a, b in intervals)
