"""Stage timing + RTF accounting, and device traces.

Counterpart of ``diffsheg_tpu/utils/profiling.py``.  The reference
measures throughput with ``time.time()`` spans around mel / HuBERT /
sampler and prints ``frames / total_time`` as FPS (reference
trainers/ddpm_beat_trainer.py:1233-1315); :class:`StageTimer` is that
accounting.  :func:`device_trace` is a ``torch.profiler`` context and
:func:`block_until_ready` waits for the tensors' device.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch


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
