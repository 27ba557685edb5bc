"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` they use ``cuda`` and raise when no card is present, rather
than carrying on quietly on the CPU.

A run of several processes, one card each, is started by ``torchrun``
(``torchrun --nproc-per-node N -m diffsheg_tpu_torch.cli train ...``):
:func:`init_distributed` joins its process group, the counterpart of
``jax.distributed.initialize``.
"""

from __future__ import annotations

import os
from typing import Optional, Union

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


# what torchrun sets in every process it starts
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT")


def _group() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def world_size() -> int:
    """The number of processes of the run: the initialised
    ``torch.distributed`` group's, else ``WORLD_SIZE`` (a collective then
    fails: the group was not joined), else 1."""
    if _group():
        return torch.distributed.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def process_index() -> int:
    if _group():
        return torch.distributed.get_rank()
    return int(os.environ.get("RANK", "0"))


def local_device() -> torch.device:
    """This process's card: ``cuda:LOCAL_RANK``."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def init_distributed(device: torch.device,
                     backend: Optional[str] = None,
                     timeout_s: float = 1800.0) -> torch.device:
    """Join the process group that ``torchrun``'s variables describe, and
    return the device this process runs on: ``cuda:LOCAL_RANK`` for a
    CUDA ``device``, else ``device``.  The backend is NCCL on CUDA and
    gloo on the CPU unless ``backend`` names one (gloo for processes that
    share one card).  Without those variables (none of them set) the run
    is one process and ``device`` comes back unchanged; with only some of
    them set it raises."""
    have = [v for v in LAUNCH_VARS if v in os.environ]
    if not have:
        return device
    if len(have) != len(LAUNCH_VARS):
        missing = sorted(set(LAUNCH_VARS) - set(have))
        raise RuntimeError(
            f"{', '.join(have)} set without {', '.join(missing)}: start "
            "several processes with torchrun, or unset them for one")
    if device.type == "cuda":
        device = local_device()
        torch.cuda.set_device(device)
    if not _group():
        import datetime
        torch.distributed.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def shutdown_distributed() -> None:
    """Leave the process group, if this process is in one."""
    if _group():
        torch.distributed.destroy_process_group()


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ('float32' or 'bfloat16') -> torch dtype."""
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None
