"""Data layer: the dataset normalization statistics the export uses."""

from diffsheg_tpu_torch.data.beat import (  # noqa: F401
    BEAT_HAND_FREE_CHANNELS,
    BeatStats,
)
from diffsheg_tpu_torch.data.show import (  # noqa: F401
    ShowStats,
    extract_gesture,
    inv_standardize,
    standardize,
)
