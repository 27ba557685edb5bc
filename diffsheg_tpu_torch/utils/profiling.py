"""Stage timing + RTF accounting, device traces, and spans in the program.

Counterpart of ``diffsheg_tpu/utils/profiling.py``.  The reference
measures throughput with ``time.time()`` spans around mel / HuBERT /
sampler and prints ``frames / total_time`` as FPS (reference
trainers/ddpm_beat_trainer.py:1233-1315); :class:`StageTimer` is that
accounting.  :func:`device_trace` is a ``torch.profiler`` context and
:func:`block_until_ready` waits for the tensors' device.

:func:`span` marks a phase of the program where the work happens: a
clip's pipeline call, the mel and HuBERT frontends, the window loop, each
model call and each update between calls, each kernel launch (the names
are listed where :class:`SpanRecorder` is).  A span costs one flag read
unless a ``torch.profiler`` is recording; then it is a
``record_function`` range named ``diffsheg/<name>`` and a
:class:`SpanRecord` in memory (:func:`recorded_spans`).  To see where a
clip's time goes, run any entry point under ``device_trace(dir)`` (or any
``torch.profiler.profile``) and open the Chrome trace: the ``diffsheg/``
ranges sit on the host's row above the kernels they launched, on the
profiler's clock, so each idle gap of the card falls in a named phase.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler


class StageTimer:
    """Accumulates wall-clock per named stage; computes RTF/FPS."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)

    @property
    def total(self) -> float:
        return sum(self.totals.values())

    def fps(self, frames: int) -> float:
        """frames / total pipeline time (ddpm_beat_trainer.py:1315)."""
        return frames / max(self.total, 1e-9)

    def rtf(self, frames: int, fps_native: float) -> float:
        """Real-time factor: generated seconds per wall second."""
        return (frames / fps_native) / max(self.total, 1e-9)

    def report(self) -> Dict[str, float]:
        return dict(self.totals, total=self.total)


@contextlib.contextmanager
def device_trace(logdir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the CPU and, with a card, CUDA
    activity, written to ``logdir`` as a Chrome trace (no-op when logdir
    is None)."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


SPAN_PREFIX = "diffsheg/"


class SpanRecord(NamedTuple):
    """One span: host times from ``time.perf_counter_ns()``; ``parent``
    the index of the enclosing span's record (-1 at the top, or where it
    was dropped) and ``request`` that of the outermost span's, so every
    span of one clip's pipeline call shares it."""

    name: str
    start_ns: int
    end_ns: int          # 0 while the span is open
    parent: int
    request: int


class _Span:
    """An open span: its record and its ``record_function`` range.  The
    record's times are read just before the range opens and closes, a few
    microseconds from the range's own stamps (a range's first call in a
    process spends most of its extra time after its stamp)."""

    __slots__ = ("recorder", "name", "range", "record")

    def __init__(self, recorder: "SpanRecorder", name: str):
        self.recorder, self.name = recorder, name

    def __enter__(self):
        self.range = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self.record = self.recorder._open(self.name)
        self.range.__enter__()

    def __exit__(self, *exc):
        self.recorder._close(self.record)
        self.range.__exit__(*exc)


_OFF = contextlib.nullcontext()


class SpanRecorder:
    """Spans and their records, in a buffer of ``capacity`` records that
    counts what it drops beyond that (``dropped``) rather than grow.  One
    stack of open spans a thread, so sessions that share a generator across
    threads nest their spans apart.  Clear it while no span is open.

    The program's spans (each read by a metric of the benchmark):
    ``pipeline`` (``FusedPipeline.__call__``), ``frontend.mel``,
    ``frontend.hubert``, ``sampler`` (``StreamingGenerator.generate`` /
    ``generate_fused``), ``sampler.call`` (a model call of a sampler
    program), ``sampler.update`` (a step's work outside the model call, an
    undo step), and ``launch.fused_branch``, ``launch.fused_layer``,
    ``launch.linear_attention``, ``launch.ddim_step``,
    ``launch.gemm_tf32x3`` (one kernel launch each, its argument checks
    included); in training ``train.step`` (``train/step.py``: the loss,
    backward and update), ``train.allreduce`` (each cross-process mean in
    it), ``train.frontend.mel`` and ``train.frontend.encoder``
    (``audio/frontend.py``)."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self.dropped = 0
        self._records: List[list] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def span(self, name: str):
        """A context manager: the shared no-op unless a ``torch.profiler``
        is recording (the flag ``record_function`` reads), else a
        ``diffsheg/<name>`` range and a record."""
        if not _profiler._is_profiler_enabled:
            return _OFF
        return _Span(self, name)

    def _open(self, name: str) -> Optional[list]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        parent, request = stack[-1] if stack else (-1, -1)
        with self._lock:
            if len(self._records) < self.capacity:
                index = len(self._records)
                record = [name, 0, 0, parent,
                          index if request < 0 else request]
                self._records.append(record)
            else:
                index, record = -1, None
                self.dropped += 1
        stack.append((index, request if index < 0 else record[4]))
        if record is not None:
            record[1] = time.perf_counter_ns()
        return record

    def _close(self, record: Optional[list]) -> None:
        self._local.stack.pop()
        if record is not None:
            record[2] = time.perf_counter_ns()

    def records(self) -> List[SpanRecord]:
        """The records, in the order the spans opened; not cleared."""
        with self._lock:
            return [SpanRecord(*r) for r in self._records]

    def clear(self) -> None:
        with self._lock:
            self._records = []
            self.dropped = 0


RECORDER = SpanRecorder()
span = RECORDER.span
recorded_spans = RECORDER.records
clear_spans = RECORDER.clear


def block_until_ready(tree) -> None:
    """Wait for the device of every CUDA tensor in ``tree`` (a tensor, or
    nested lists, tuples and dicts of them)."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for d in devices:
        torch.cuda.synchronize(d)
