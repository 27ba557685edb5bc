"""Data layer: memory-mapped caches, the BEAT / SHOW window datasets and
their normalization statistics, the sharded batch loader."""

from diffsheg_tpu_torch.data.cache import (  # noqa: F401
    ArrayCache,
    CacheWriter,
    cache_exists,
)
from diffsheg_tpu_torch.data.beat import (  # noqa: F401
    BEAT_HAND_FREE_CHANNELS,
    BeatDataset,
    BeatStats,
)
from diffsheg_tpu_torch.data.show import (  # noqa: F401
    ShowDataset,
    ShowStats,
    combine_expression,
    extract_gesture,
    inv_standardize,
    reassemble_smplx,
    standardize,
)
from diffsheg_tpu_torch.data.loader import ShardedBatchLoader  # noqa: F401
