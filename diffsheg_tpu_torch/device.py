"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` they use ``cuda`` and raise when no card is present, rather
than carrying on quietly on the CPU.
"""

from __future__ import annotations

import os
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is requested but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: diffsheg_tpu_torch entry points run on "
            "the GPU by default; pass device='cpu' to run on the CPU")
    return dev


def world_size() -> int:
    """The number of processes of the run: ``WORLD_SIZE`` or an
    initialised ``torch.distributed`` group."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        world = max(world, torch.distributed.get_world_size())
    return world


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ('float32' or 'bfloat16') -> torch dtype."""
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None
