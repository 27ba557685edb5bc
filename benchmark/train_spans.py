"""The program's training spans placed on the device trace's clock.

As ``program_spans.py`` places the serving spans: the port records a span
(``diffsheg_tpu_torch/utils/profiling.py``) only while a profiler
records, so in a traced run its records are the traced steps'.  Each
benchmark span wraps one call that opens one program span inside it: the
generators' ``step`` span the step's ``train.step``, the frontend cell's
``frontend`` span the frontend's ``train.frontend.mel`` (its first span).
Paired in start order, they bound the offset (view clock - record clock)
from below by every pair's (view start - record start) and from above by
every (view end - record end); the largest lower bound is taken, as
``program_spans.py`` takes it.  Where a pair's counts differ, or no
offset fits, or the program records no training spans (an older
checkout), :func:`program_view` gives None.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from benchmark.program_spans import records
from benchmark.tracing import TraceView

# each benchmark span, and the program span its call opens first
PAIRED = {"step": "train.step", "frontend": "train.frontend.mel"}


def program_view(view: TraceView) -> Optional[TraceView]:
    """``view`` with the program's spans beside the benchmark's, or None
    where the records cannot be placed."""
    recs = records()
    if recs is None:
        return None
    lo, hi, paired = -math.inf, math.inf, 0
    for bench, name in PAIRED.items():
        rs = sorted((r for r in recs if r.name == name),
                    key=lambda r: r.start_ns)
        iv = sorted(view.spans.get(bench, []))
        if not rs and not iv:
            continue
        if len(rs) != len(iv):
            return None
        for (a, b), r in zip(iv, rs):
            lo = max(lo, a - r.start_ns * 1e-9)
            hi = min(hi, b - r.end_ns * 1e-9)
        paired += 1
    if not paired or lo > hi:
        return None
    spans: Dict[str, List[Tuple[float, float]]] = {}
    for r in recs:
        spans.setdefault(r.name, []).append(
            (r.start_ns * 1e-9 + lo, r.end_ns * 1e-9 + lo))
    return TraceView(view.ops, {**spans, **view.spans})


def device_seconds_in(view: TraceView, span: str) -> Optional[float]:
    """Device seconds of the operations launched inside the program's
    ``span``: the union of their intervals, so that operations that run at
    once count once; None where there are none or nothing is placed."""
    pv = program_view(view)
    ops = [] if pv is None else pv.launched_in(span)
    if not ops:
        return None
    lo = min(op.start for op in ops)
    hi = max(op.end for op in ops)
    return TraceView(ops).busy(lo, hi)
