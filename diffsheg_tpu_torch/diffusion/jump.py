"""RePaint time-travel (jump/resample) schedules as step programs.

Counterpart of ``diffsheg_tpu/diffusion/jump.py``.  The walk is
precomputed into a :class:`StepProgram`; the port's sampler runs it as a
host loop (the JAX package runs it as one ``lax.scan``).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


def jump_schedule(t_T: int, jump_length: int, jump_n_sample: int) -> List[int]:
    """RePaint jump schedule starting from ``t_T`` (t_T itself is not
    walked: the first transition pair is (t_T - 1, t_T - 2))."""
    jumps = {j: jump_n_sample - 1
             for j in range(0, t_T - jump_length, jump_length)}
    t = t_T
    ts: List[int] = []
    while t >= 1:
        t -= 1
        ts.append(t)
        if jumps.get(t, 0) > 0:
            jumps[t] -= 1
            for _ in range(jump_length):
                t += 1
                ts.append(t)
    ts.append(-1)
    _check_times(ts, -1, t_T)
    return ts


def jump_schedule_ddim(time_respacing: int = 25, jump_length: int = 1,
                       jump_n_sample: int = 1) -> List[int]:
    """The DiffSHEG outpainting schedule, starting at 60% of the respaced
    chain (t_T = 15 for ddim25)."""
    t_T = 15 if time_respacing == 25 else int(time_respacing * 0.6)
    return jump_schedule(t_T, jump_length, jump_n_sample)


def generic_jump_schedule(
    t_T: int,
    n_sample: int = 1,
    jump_length: int = 1,
    jump_n_sample: int = 1,
    jump2_length: int = 1,
    jump2_n_sample: int = 1,
    jump3_length: int = 1,
    jump3_n_sample: int = 1,
    start_resampling: int = 10 ** 8,
) -> List[int]:
    """The fully general RePaint walk (reference models/scheduler.py:70-148,
    ``get_schedule_jump``): inline micro-resampling (``n_sample``), three
    nested jump levels and a ``start_resampling`` gate below which
    resampling activates.  A level-1 jump refills the level-2 and level-3
    budgets; a level-2 jump refills level 3.  At the defaults it is
    :func:`jump_schedule`."""

    def budgets(length: int, per_site: int) -> dict:
        return {site: per_site - 1
                for site in range(0, t_T - length, length)}

    lvl1 = budgets(jump_length, jump_n_sample)
    lvl2 = budgets(jump2_length, jump2_n_sample)
    lvl3 = budgets(jump3_length, jump3_n_sample)

    t = t_T
    ts: List[int] = []

    def climb(n: int) -> None:
        nonlocal t
        for _ in range(n):
            t += 1
            ts.append(t)

    while t >= 1:
        t -= 1
        ts.append(t)
        # inline micro-resampling: (n_sample - 1) up/down pairs at t
        if t + 1 < t_T - 1 and t <= start_resampling:
            for _ in range(n_sample - 1):
                climb(1)
                t -= 1
                ts.append(t)
        # innermost level first; outer levels refill the inner budgets
        if lvl3.get(t, 0) > 0 and t <= start_resampling - jump3_length:
            lvl3[t] -= 1
            climb(jump3_length)
        if lvl2.get(t, 0) > 0 and t <= start_resampling - jump2_length:
            lvl2[t] -= 1
            climb(jump2_length)
            lvl3 = budgets(jump3_length, jump3_n_sample)
        if lvl1.get(t, 0) > 0 and t <= start_resampling - jump_length:
            lvl1[t] -= 1
            climb(jump_length)
            lvl2 = budgets(jump2_length, jump2_n_sample)
            lvl3 = budgets(jump3_length, jump3_n_sample)

    ts.append(-1)
    _check_times(ts, -1, t_T)
    return ts


def jump_schedule_paper() -> List[int]:
    """The RePaint paper's schedule: t_T 250, jump_length 10,
    jump_n_sample 10 (reference models/scheduler.py:150-176), for the
    ancestral harmonize loop (``program=`` of the ancestral sampler)."""
    return jump_schedule(250, 10, 10)


def _check_times(times: List[int], t_0: int, t_T: int) -> None:
    if not (times[0] > times[1] and times[-1] == -1
            and all(abs(a - b) == 1 for a, b in zip(times[:-1], times[1:]))
            and all(t_0 <= t <= t_T for t in times)):
        raise ValueError(f"malformed timestep walk {times}")


class StepProgram(NamedTuple):
    """A reverse-process program: ``t`` int32 (S,) — the timestep each
    transition operates at; ``denoise`` bool (S,) — True: DDIM denoise
    t -> t-1, False: undo t-1 -> t."""

    t: np.ndarray
    denoise: np.ndarray

    @property
    def num_model_calls(self) -> int:
        return int(self.denoise.sum())


def make_step_program(times: List[int]) -> StepProgram:
    """Compile a timestep walk into arrays."""
    t_steps, denoise = [], []
    for t_last, t_cur in zip(times[:-1], times[1:]):
        t_steps.append(t_last)
        denoise.append(t_cur < t_last)
    return StepProgram(t=np.asarray(t_steps, dtype=np.int32),
                       denoise=np.asarray(denoise, dtype=bool))


def plain_program(num_steps: int) -> StepProgram:
    """Every respaced step, descending."""
    return StepProgram(t=np.arange(num_steps - 1, -1, -1, dtype=np.int32),
                       denoise=np.ones((num_steps,), dtype=bool))
