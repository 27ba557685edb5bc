"""Timestep respacing (DDIM-N subsequence selection).

Counterpart of ``diffsheg_tpu/diffusion/respace.py``: the respaced
schedule plus ``timestep_map`` (respaced index -> original timestep).
"""

from __future__ import annotations

from typing import Sequence, Set, Tuple, Union

import numpy as np

from diffsheg_tpu_torch.diffusion.schedule import DiffusionSchedule, make_schedule


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """Which original timesteps to retain ('ddimN' fixed stride, or
    per-section fractional striding)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(
                f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]

    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        frac_stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        taken = []
        for _ in range(count):
            taken.append(start_idx + round(cur))
            cur += frac_stride
        all_steps += taken
        start_idx += size
    return set(all_steps)


def make_respaced_schedule(
    base_betas: np.ndarray, use_timesteps,
) -> Tuple[DiffusionSchedule, np.ndarray]:
    """Betas recomputed over a timestep subsequence; returns the respaced
    schedule and the int32 ``timestep_map``."""
    base_betas = np.asarray(base_betas, dtype=np.float64)
    alphas_cumprod = np.cumprod(1.0 - base_betas)
    use = set(int(x) for x in use_timesteps)
    last_acp = 1.0
    new_betas, timestep_map = [], []
    for i, acp in enumerate(alphas_cumprod):
        if i in use:
            new_betas.append(1.0 - acp / last_acp)
            last_acp = acp
            timestep_map.append(i)
    return (make_schedule(np.array(new_betas, dtype=np.float64)),
            np.asarray(timestep_map, dtype=np.int32))
