"""Temporal smoothing filters for generated motion.

Counterpart of ``diffsheg_tpu/utils/filters.py``: the reference smooths
output trajectories with a per-channel gaussian filter (reference
utils/utils.py:128-133, scipy.ndimage.gaussian_filter1d); here it is a
depthwise ``F.conv1d`` with edge replication, on the motion's device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy-compatible gaussian taps: radius = int(truncate * sigma + 0.5)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def motion_temporal_filter(motion: torch.Tensor, sigma: float = 2.5,
                           truncate: float = 4.0) -> torch.Tensor:
    """(..., T, C) -> same, gaussian-smoothed along T with edge replication
    ('nearest' mode, matching the scipy default used by the reference)."""
    kernel = torch.from_numpy(gaussian_kernel1d(sigma, truncate)).to(
        device=motion.device, dtype=motion.dtype)
    radius = (kernel.shape[0] - 1) // 2
    lead, (T, C) = motion.shape[:-2], motion.shape[-2:]
    x = motion.reshape(-1, T, C).transpose(1, 2).reshape(-1, 1, T)
    x = F.pad(x, (radius, radius), mode="replicate")
    # the kernel is symmetric, so conv1d's correlation is the convolution
    out = F.conv1d(x, kernel.view(1, 1, -1))
    return out.reshape(-1, C, T).transpose(1, 2).reshape(*lead, T, C)
