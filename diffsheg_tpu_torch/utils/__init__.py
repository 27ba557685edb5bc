"""Utilities: metric logging, stage timing and device traces, smoothing
filters."""

from diffsheg_tpu_torch.utils.logging import MetricLogger  # noqa: F401
from diffsheg_tpu_torch.utils.filters import motion_temporal_filter  # noqa: F401
from diffsheg_tpu_torch.utils.profiling import StageTimer, device_trace  # noqa: F401
