"""Process mesh, batch placement and fully sharded parameters.

Counterpart of ``diffsheg_tpu/parallel/mesh.py``.  The reference trains
one process per GPU with NCCL DDP (runner.py:80-122); the JAX package lays
the same job out as a ``data`` x ``fsdp`` device mesh.  The port keeps the
reference's layout, one process per card, and the JAX package's mesh
rule over the processes:

  - ``mesh.data_parallel`` x ``mesh.fsdp_parallel`` processes, the data
    degree ``world // fsdp`` when it is -1 (:func:`mesh_shape`);
  - each process takes its contiguous block of every global batch
    (``data/loader.py``) and :func:`shard_batch` moves it to its card;
  - with ``fsdp`` above 1, :func:`shard_params_fsdp` shards the
    parameters (and so the Adam moments) with
    ``torch.distributed.fsdp.fully_shard`` over the ``fsdp`` dimension,
    replicated over ``data`` when both are above 1 (HSDP).  Otherwise
    the step averages the gradients itself (``train/step.py``).

Either way every process holds an equal share of the global batch and
the step computes what one process computes on the whole of it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from diffsheg_tpu_torch.config import MeshConfig
from diffsheg_tpu_torch.parallel.collectives import process_count


def mesh_shape(cfg: Optional[MeshConfig] = None,
               n: Optional[int] = None) -> Tuple[int, int]:
    """(data, fsdp) degrees for ``n`` processes (default: this run's),
    by the JAX package's rule; raises when they do not multiply to ``n``."""
    cfg = cfg or MeshConfig()
    n = process_count() if n is None else n
    fsdp = max(cfg.fsdp_parallel, 1)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // fsdp
    if dp * fsdp != n:
        raise ValueError(f"mesh {dp}x{fsdp} != {n} devices")
    return dp, fsdp


def make_mesh(cfg: Optional[MeshConfig] = None, device_type: str = "cuda"):
    """The (data, fsdp) ``DeviceMesh`` over the initialised process
    group's processes, one card each."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg = cfg or MeshConfig()
    return init_device_mesh(device_type, mesh_shape(cfg),
                            mesh_dim_names=(cfg.data_axis, cfg.fsdp_axis))


def fsdp_sharding(mesh, x: torch.Tensor, min_size: int = 2 ** 14):
    """The dimension ``fully_shard`` splits a parameter along: the first
    axis the ``fsdp`` size divides, for a leaf of at least ``min_size``
    elements (the JAX package's rule); ``None`` (dimension 0, padded)
    otherwise.  Where a parameter lives changes no number."""
    from torch.distributed.tensor import Shard
    n = mesh.shape[-1]
    if n <= 1 or x.numel() < min_size:
        return None
    for d, dim in enumerate(x.shape):
        if dim % n == 0 and dim >= n:
            return Shard(d)
    return None


def shard_batch(batch: Dict[str, np.ndarray],
                device: torch.device) -> Dict[str, torch.Tensor]:
    """The loader's local rows on this process's device: floating fields
    as float32, the rest (int16 audio, int32 labels) as they are."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.floating):
            v = v.astype(np.float32, copy=False)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def is_fsdp(model: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule
    return isinstance(model, FSDPModule)


def shard_params_fsdp(mesh, model: nn.Module,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> nn.Module:
    """Shard ``model``'s parameters over ``mesh``'s ``fsdp`` dimension, in
    place (``fully_shard``; gradients are reduce-scattered as averages
    over every process): on the 1-D ``fsdp`` mesh when the data degree is
    1, else on the 2-D mesh, replicated over ``data``.  With a bf16
    ``compute_dtype`` the gathered weights are cast to it and the
    gradients reduced in f32.  Call before the optimizer is made."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    sub = mesh if mesh.shape[0] > 1 else mesh[mesh.mesh_dim_names[-1]]
    policy = MixedPrecisionPolicy()
    if compute_dtype != torch.float32:
        policy = MixedPrecisionPolicy(param_dtype=compute_dtype,
                                      reduce_dtype=torch.float32,
                                      cast_forward_inputs=False)
    fully_shard(model, mesh=sub, mp_policy=policy,
                shard_placement_fn=lambda p: fsdp_sharding(sub, p))
    return model
