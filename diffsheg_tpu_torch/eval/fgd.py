"""FGD (Frechet Gesture Distance) evaluation driver.

Counterpart of ``diffsheg_tpu/eval/fgd.py``: the frozen feature net
(``eval/fgd_net.py``, on its device) embeds generated and real windows,
and the Frechet distance between Gaussians fitted to the two sets of
latents runs on the host in float64 (``eval/metrics.py``).
:func:`fgd_from_positions` is the BVH-level distance over flattened
forward-kinematics joint positions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from diffsheg_tpu_torch.device import DeviceLike
from diffsheg_tpu_torch.eval.fgd_net import (FgdFeatureNet, FgdNetConfig,
                                             init_fgd_net)
from diffsheg_tpu_torch.eval.metrics import (activation_statistics,
                                             frechet_distance)


class FgdCalculator:
    """Accumulates generated and real latents, then computes FGD.  Without
    ``net`` it embeds with a random net seeded by ``seed`` on ``device``."""

    def __init__(self, cfg: FgdNetConfig, net: Optional[FgdFeatureNet] = None,
                 seed: int = 0, device: DeviceLike = None):
        self.cfg = cfg
        self.net = net if net is not None else init_fgd_net(cfg, seed, device)
        self.device = next(self.net.parameters()).device
        self.reset()

    def reset(self) -> None:
        self._gen: list = []
        self._real: list = []

    @torch.no_grad()
    def embed(self, poses) -> np.ndarray:
        """(B, T, C) windows -> (B, feature_length) latents."""
        x = torch.as_tensor(np.asarray(poses), dtype=torch.float32)
        return self.net(x.to(self.device)).cpu().numpy()

    def update(self, generated, real) -> None:
        self._gen.append(self.embed(generated))
        self._real.append(self.embed(real))

    def compute(self) -> float:
        gen = np.concatenate(self._gen, axis=0)
        real = np.concatenate(self._real, axis=0)
        mu1, s1 = activation_statistics(gen)
        mu2, s2 = activation_statistics(real)
        return frechet_distance(mu1, s1, mu2, s2)


def fgd_from_positions(gen_positions: np.ndarray, real_positions: np.ndarray
                       ) -> float:
    """BVH-level FID: the Frechet distance over flattened world-space joint
    positions per frame (``geometry/bvh.py::forward_kinematics`` output
    reshaped to (T, J*3))."""
    mu1, s1 = activation_statistics(gen_positions)
    mu2, s2 = activation_statistics(real_positions)
    return frechet_distance(mu1, s1, mu2, s2)
