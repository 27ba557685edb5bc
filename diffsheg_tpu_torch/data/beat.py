"""BEAT normalization statistics and the window dataset.

The port's own copy of part of ``diffsheg_tpu/data/beat.py`` (numpy
only): the hand-free channel subset, :class:`BeatStats` (which the export
de-normalizes with) and :class:`BeatDataset` over a built cache.  The
cache builder is not ported (``cli build-cache`` of the JAX package
writes caches this dataset reads).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from diffsheg_tpu_torch.data.cache import ArrayCache, cache_exists


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


class BeatDataset:
    """Window dataset over a built cache.

    Batches are dicts with keys {pose, pose_axis_angle, mel, facial, sem,
    id, motion} (+ word / emo where the cache has them, + audio with
    ``include_audio``); ``motion`` is the 192-d training target
    cat(pose_axis_angle, facial).  ``hubert_cache_dir``: a cache whose
    field ``hubert`` holds each window's (T', hubert_dim) features,
    resampled to the window's frames (:func:`_interp_frames`).
    """

    def __init__(self, cache_dir: str, stats: Optional[BeatStats] = None,
                 hubert_cache_dir: Optional[str] = None,
                 remove_hand: bool = False, include_audio: bool = False):
        self.cache = ArrayCache(cache_dir)
        self.stats = stats
        self.remove_hand = remove_hand
        self.include_audio = include_audio
        self.hubert = (ArrayCache(hubert_cache_dir)
                       if hubert_cache_dir and cache_exists(hubert_cache_dir)
                       else None)

    def __len__(self) -> int:
        return len(self.cache)

    @property
    def n_poses(self) -> int:
        return int(self.cache.meta.get("n_poses", 34))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        s = self.cache[idx]
        out = dict(s)
        pose_aa = s["pose_axis_angle"]
        if self.remove_hand:
            pose_aa = pose_aa[..., BEAT_HAND_FREE_CHANNELS]
            out["pose_axis_angle"] = pose_aa
            out["pose"] = s["pose"][..., BEAT_HAND_FREE_CHANNELS]
        out["motion"] = np.concatenate([pose_aa, s["facial"]], axis=-1)
        if self.hubert is not None:
            out["hubert"] = hubert_batch(self.hubert, np.asarray([idx]),
                                         pose_aa.shape[0])[0]
        return out

    def batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        keys = ["pose", "pose_axis_angle", "mel", "facial", "sem", "id"]
        keys += [k for k in ("word", "emo") if k in self.cache.fields]
        if self.include_audio and "audio" in self.cache.fields:
            keys.append("audio")
        b = self.cache.batch(indices, keys)
        if self.remove_hand:
            b["pose_axis_angle"] = b["pose_axis_angle"][
                ..., BEAT_HAND_FREE_CHANNELS]
            b["pose"] = b["pose"][..., BEAT_HAND_FREE_CHANNELS]
        b["motion"] = np.concatenate(
            [b["pose_axis_angle"], b["facial"]], axis=-1)
        if self.hubert is not None:
            b["hubert"] = hubert_batch(self.hubert, indices,
                                       b["motion"].shape[1])
        return b


def hubert_batch(cache: ArrayCache, indices: np.ndarray,
                 frames: int) -> np.ndarray:
    """The ``hubert`` field of the samples ``indices``, each resampled to
    ``frames`` (one gather when the cache holds windows of that length).
    The JAX dataset passes the cache's whole sample dict to
    ``_interp_frames`` here, which fails; the port reads the field."""
    if "hubert" not in cache.fields:
        raise ValueError(f"{cache.cache_dir}: a HuBERT cache needs a "
                         f"'hubert' field (has {cache.fields})")
    try:
        feats = cache.gather("hubert", indices)
    except ValueError:                      # ragged: whole clips
        feats = [cache[int(i)]["hubert"] for i in indices]
    else:
        if feats.shape[1] == frames:
            return feats
    return np.stack([_interp_frames(f, frames) for f in feats])


def _interp_frames(feat: np.ndarray, target_len: int) -> np.ndarray:
    """Linear resample (T, C) -> (target_len, C), align_corners=True."""
    T = feat.shape[0]
    if T == target_len:
        return np.asarray(feat)
    pos = np.linspace(0.0, T - 1.0, target_len)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, T - 1)
    w = (pos - lo)[:, None]
    return feat[lo] * (1.0 - w) + feat[hi] * w
