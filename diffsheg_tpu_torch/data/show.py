"""SHOW / TalkSHOW normalization statistics and channel carpentry.

The port's own copy of the statistics part of ``diffsheg_tpu/data/show.py``
(numpy only): the SMPL-X split, :func:`extract_gesture`,
:class:`ShowStats` and (inverse) standardization, which the SHOW export
uses.  Standardization keeps the reference's quirk: the expression *std*
vector's first 3 entries are the jaw *mean* (reference show.py:46-47).
The dataset comes with the training side of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

# SMPL-X layout (show.py:83)
_POSE_SPLITS = (3, 3, 3, 3, 63, 90)       # jaw, leye, reye, global, body, hands
_BODY_SPLITS = (6, 3, 6, 3, 6, 3, 6, 30)  # low1, up1, ..., low4, up4

POSE_DIM_FULL = 165
GESTURE_DIM = 3 + 3 + 3 + 30 + 90         # 129
EXPRESSION_DIM = 3 + 100                  # 103


def split_smplx_pose(pose: np.ndarray) -> Dict[str, np.ndarray]:
    """(..., 165) -> named parts."""
    idx = np.cumsum(_POSE_SPLITS)[:-1]
    jaw, leye, reye, global_orient, body, hands = np.split(pose, idx, axis=-1)
    b_idx = np.cumsum(_BODY_SPLITS)[:-1]
    low1, up1, low2, up2, low3, up3, low4, up4 = np.split(body, b_idx, axis=-1)
    return dict(jaw=jaw, leye=leye, reye=reye, global_orient=global_orient,
                low=(low1, low2, low3, low4), up=(up1, up2, up3, up4),
                hands=hands)


def extract_gesture(pose: np.ndarray) -> np.ndarray:
    """(..., 165) -> (..., 129) upper-body + hands (show.py:83-85)."""
    p = split_smplx_pose(pose)
    up1, up2, up3, up4 = p["up"]
    return np.concatenate([up1, up2, up3, up4, p["hands"]], axis=-1)


@dataclasses.dataclass
class ShowStats:
    """TalkSHOW normalization stats (show.py:42-51)."""

    pose_mean: np.ndarray         # (129,)
    pose_std: np.ndarray
    expression_mean: np.ndarray   # (103,) jaw-mean ++ expression-mean
    expression_std: np.ndarray    # (103,) jaw-MEAN ++ expression-std (quirk)

    @staticmethod
    def from_raw_dict(d: Dict[str, np.ndarray]) -> "ShowStats":
        """From the reference's ``talkshow_mean_std.npy`` dict layout:
        pose_mean/pose_std are 165-d, expression_mean/std 100-d."""
        pose_mean = extract_gesture(d["pose_mean"])
        pose_std = extract_gesture(d["pose_std"])
        jaw_mean = d["pose_mean"][..., :3]
        return ShowStats(
            pose_mean=pose_mean,
            pose_std=pose_std,
            expression_mean=np.concatenate([jaw_mean, d["expression_mean"]],
                                           axis=-1),
            # reference show.py:47 uses pose_mean (not std) for the jaw slot
            expression_std=np.concatenate([jaw_mean, d["expression_std"]],
                                          axis=-1),
        )

    @staticmethod
    def load(path: str) -> "ShowStats":
        d = np.load(path, allow_pickle=True)[()]
        return ShowStats.from_raw_dict(d)

    @property
    def motion_mean(self) -> np.ndarray:
        return np.concatenate([self.pose_mean, self.expression_mean], axis=-1)

    @property
    def motion_std(self) -> np.ndarray:
        return np.concatenate([self.pose_std, self.expression_std], axis=-1)


def standardize(x: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return (x - mean) / std


def inv_standardize(x: np.ndarray, mean: np.ndarray, std: np.ndarray
                    ) -> np.ndarray:
    """(show.py:157-162); used on generated output before export
    (ddpm_show_trainer.py:719-724,913-918)."""
    return x * std + mean
