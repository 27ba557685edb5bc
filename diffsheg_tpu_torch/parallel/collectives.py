"""Cross-process reductions and synchronisation on ``torch.distributed``.

Counterpart of ``diffsheg_tpu/parallel/collectives.py``: the reference's
``AverageMeter.all_reduce`` (trainers/ddpm_beat_trainer.py:1504-1514), the
loss-aware sampler's ``dist.all_gather`` (models/gaussian_diffusion.py:
90-111) and ``dist.barrier`` (runner.py:121-122), for values computed
outside the step (per-process evaluation shards, file staging), and the
few collectives the data-parallel step itself needs.

Every function reads the default process group, which entry points join
through ``device.py::init_distributed``.  With one process each returns
its input, as the JAX package's do.  Host metrics are reduced in float64.  Tensors cross processes on the
group's device: the process's card under NCCL, the CPU under gloo.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from diffsheg_tpu_torch import device


def process_count() -> int:
    """The run's processes (``device.py::world_size``)."""
    return device.world_size()


def process_index() -> int:
    return device.process_index()


def global_rows(local_batch: int) -> Tuple[int, int]:
    """(first global row, global batch) of this process's ``local_batch``
    rows: every process holds an equal, contiguous share of the global
    batch (``data/loader.py``)."""
    return process_index() * local_batch, process_count() * local_batch


def group_device() -> torch.device:
    """Where the default group's collectives run."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str = "barrier") -> None:
    """Cross-process sync point (reference runner.py:122 dist.barrier);
    ``name`` labels it for a reader of the code, as in JAX."""
    if process_count() == 1:
        return
    dist.barrier()


def _allgather(x: np.ndarray) -> np.ndarray:
    """(processes, *x.shape): every process's ``x``, in process order."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(group_device())
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return np.stack([o.cpu().numpy() for o in out])


def all_reduce_mean_metrics(metrics: Dict[str, float],
                            weight: float = 1.0) -> Dict[str, float]:
    """Weighted mean of host-side scalar metrics across processes
    (the AverageMeter.all_reduce replacement)."""
    if process_count() == 1:
        return dict(metrics)
    keys = sorted(metrics)
    local = np.asarray([weight] + [metrics[k] * weight for k in keys],
                       dtype=np.float64)
    summed = _allgather(local).sum(axis=0)
    total_w = max(summed[0], 1e-12)
    return {k: float(summed[i + 1] / total_w) for i, k in enumerate(keys)}


def all_reduce_nanmean_metrics(metrics: Dict[str, float],
                               weight: float = 1.0) -> Dict[str, float]:
    """Weighted mean across processes that ignores non-finite entries
    per metric: a process that saw no clips (weight 0) or computed no
    value for one metric contributes nothing to it; a metric nobody
    measured stays NaN everywhere."""
    if process_count() == 1:
        return dict(metrics)
    keys = sorted(metrics)
    vals = np.asarray([metrics[k] for k in keys], dtype=np.float64)
    ok = np.isfinite(vals)
    local = np.concatenate([np.where(ok, vals * weight, 0.0),
                            np.where(ok, float(weight), 0.0)])
    summed = _allgather(local).sum(axis=0)
    n = len(keys)
    return {k: float(summed[i] / summed[n + i]) if summed[n + i] > 0
            else float("nan")
            for i, k in enumerate(keys)}


def gather_arrays(x: np.ndarray) -> np.ndarray:
    """Concatenate per-process arrays along axis 0; the SAME shape on
    every process."""
    if process_count() == 1:
        return np.asarray(x)
    return np.concatenate(list(_allgather(np.asarray(x))), axis=0)


def gather_arrays_ragged(x: np.ndarray) -> np.ndarray:
    """Like :func:`gather_arrays`, but the leading dims may differ across
    processes (evaluation latents when clips do not divide evenly): pad to
    the largest, gather, trim each.  Trailing dims must match."""
    if process_count() == 1:
        return np.asarray(x)
    x = np.asarray(x)
    counts = _allgather(np.asarray([x.shape[0]], np.int64)).reshape(-1)
    padded = np.zeros((int(counts.max()),) + x.shape[1:], x.dtype)
    padded[: x.shape[0]] = x
    stacked = _allgather(padded)
    return np.concatenate(
        [stacked[p, : counts[p]] for p in range(len(counts))], axis=0)


# -- tensors of the data-parallel step ---------------------------------------

def mean_across_processes_(t: torch.Tensor) -> torch.Tensor:
    """Average ``t`` over the processes, in place; every process ends with
    the same values."""
    if process_count() == 1:
        return t
    buf = t.to(group_device())
    dist.all_reduce(buf)
    buf /= process_count()
    if buf is not t:
        t.copy_(buf)
    return t


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (equal shapes) concatenated along axis 0 in
    process order: the global batch's rows."""
    if process_count() == 1:
        return t
    buf = t.detach().to(group_device()).contiguous()
    out = [torch.empty_like(buf) for _ in range(process_count())]
    dist.all_gather(out, buf)
    return torch.cat(out).to(t.device)


def sum_across_processes(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the processes, differentiable: its gradient
    is the sum of every process's upstream gradient
    (``torch.distributed.nn.functional.all_reduce``).  The group is
    named at each call: that function's default is the group of the time
    torch imported it, which a process that left a group and joined
    another would still reduce over."""
    if process_count() == 1:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t.to(group_device()),
                      group=dist.group.WORLD).to(t.device)
