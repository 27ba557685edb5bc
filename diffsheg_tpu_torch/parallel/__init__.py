from diffsheg_tpu_torch.parallel.mesh import (  # noqa: F401
    fsdp_sharding,
    make_mesh,
    mesh_shape,
    shard_batch,
    shard_params_fsdp,
)
from diffsheg_tpu_torch.parallel.collectives import (  # noqa: F401
    all_reduce_mean_metrics,
    barrier,
    gather_arrays,
)
