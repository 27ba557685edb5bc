"""BEAT normalization statistics.

The port's own copy of the statistics part of ``diffsheg_tpu/data/beat.py``
(numpy only): the hand-free channel subset and :class:`BeatStats`, which
the export de-normalizes with.  The cache builder and the window dataset
come with the training side of the port.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


# --remove_hand channel subset: first 7 joints (21 ch) + joints 25-28
# (12 ch) of the spine_neck_141 layout, i.e. everything except fingers
# (reference ddpm_beat_trainer.py:390, runner.py:128-131 dim_pose 141->33).
BEAT_HAND_FREE_CHANNELS = np.r_[0:21, 75:87]


@dataclasses.dataclass
class BeatStats:
    """Normalization statistics (reference datasets/beat.py:81-90)."""

    mean_pose: np.ndarray            # (141,) euler degrees
    std_pose: np.ndarray
    mean_axis_angle: np.ndarray      # (141,)
    std_axis_angle: np.ndarray
    mean_facial: np.ndarray          # (51,)
    std_facial: np.ndarray

    @staticmethod
    def load(stats_dir: str) -> "BeatStats":
        p = lambda *a: os.path.join(stats_dir, *a)
        return BeatStats(
            mean_pose=np.load(p("bvh_rot", "bvh_mean.npy")),
            std_pose=np.load(p("bvh_rot", "bvh_std.npy")),
            mean_axis_angle=np.load(p("axis_angle_mean.npy")),
            std_axis_angle=np.load(p("axis_angle_std.npy")),
            mean_facial=np.load(p("facial52", "json_mean.npy")),
            std_facial=np.load(p("facial52", "json_std.npy")),
        )

    def save(self, stats_dir: str) -> None:
        os.makedirs(os.path.join(stats_dir, "bvh_rot"), exist_ok=True)
        os.makedirs(os.path.join(stats_dir, "facial52"), exist_ok=True)
        p = lambda *a: os.path.join(stats_dir, *a)
        np.save(p("bvh_rot", "bvh_mean.npy"), self.mean_pose)
        np.save(p("bvh_rot", "bvh_std.npy"), self.std_pose)
        np.save(p("axis_angle_mean.npy"), self.mean_axis_angle)
        np.save(p("axis_angle_std.npy"), self.std_axis_angle)
        np.save(p("facial52", "json_mean.npy"), self.mean_facial)
        np.save(p("facial52", "json_std.npy"), self.std_facial)

    @property
    def motion_mean(self) -> np.ndarray:
        """Concatenated axis-angle pose ++ facial stats, matching the
        generated 192-d motion layout (beat.py:92-110 with --axis_angle)."""
        return np.concatenate([self.mean_axis_angle, self.mean_facial])

    @property
    def motion_std(self) -> np.ndarray:
        return np.concatenate([self.std_axis_angle, self.std_facial])
