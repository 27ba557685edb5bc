"""SHOW / TalkSHOW statistics, channel carpentry and the window dataset.

The port's own copy of ``diffsheg_tpu/data/show.py`` (the cache builder
is ``data/show_cache.py``): the SMPL-X split, :func:`extract_gesture`,
:func:`combine_expression`, :class:`ShowStats` and (inverse)
standardization, which the SHOW export uses, and :class:`ShowDataset`.
Standardization keeps the reference's quirk: the expression *std*
vector's first 3 entries are the jaw *mean* (reference show.py:46-47).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from diffsheg_tpu_torch.data.beat import hubert_batch
from diffsheg_tpu_torch.data.cache import ArrayCache
from diffsheg_tpu_torch.device import DeviceLike

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


def combine_expression(pose: np.ndarray, expression: np.ndarray) -> np.ndarray:
    """jaw(3) ++ expression(100) -> (..., 103)."""
    jaw = split_smplx_pose(pose)["jaw"]
    return np.concatenate([jaw, expression], axis=-1)


def extract_gesture(pose: np.ndarray) -> np.ndarray:
    """(..., 165) -> (..., 129) upper-body + hands (show.py:83-85)."""
    p = split_smplx_pose(pose)
    up1, up2, up3, up4 = p["up"]
    return np.concatenate([up1, up2, up3, up4, p["hands"]], axis=-1)


def reassemble_smplx(gesture: np.ndarray, expression103: np.ndarray,
                     template: Optional[np.ndarray] = None) -> np.ndarray:
    """Inverse carpentry: the generated channels back in a full 165-d
    SMPL-X pose vector, the other channels from ``template`` or zero (the
    reference leaves this to TalkSHOW's visualizer)."""
    shape = gesture.shape[:-1]
    full = (np.tile(template, shape + (1,)) if template is not None
            else np.zeros(shape + (POSE_DIM_FULL,), dtype=gesture.dtype))
    up = np.split(gesture[..., :39], np.cumsum([3, 3, 3, 30])[:-1], axis=-1)
    full[..., 0:3] = expression103[..., :3]          # jaw
    # the body block starts at 12; lower and upper groups alternate
    off, ups = 12, iter(up)
    for k, size in enumerate(_BODY_SPLITS):
        if k % 2 == 1:
            full[..., off:off + size] = next(ups)
        off += size
    full[..., 75:165] = gesture[..., 39:]            # hands
    return full


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


class ShowDataset:
    """Cache-backed SHOW dataset.

    Cache fields: pose (165), expression (100), mel, mfcc (optional),
    audio, speaker (one-hot 4); ``hubert_cache_dir`` as for
    ``BeatDataset``.  Items: gesture (129, or 39 with ``remove_hand``),
    expression (103), motion (232), mel (the ``audio_feat``: mel, the
    mfcc — the cached field, or on a cache without it computed from the
    window's audio by ``audio/mfcc.py`` on ``device`` — or 'raw' 16 kHz
    audio mean-pooled per frame), speaker.
    """

    def __init__(self, cache_dir: str, stats: ShowStats,
                 hubert_cache_dir: Optional[str] = None,
                 remove_hand: bool = False, audio_feat: str = "mel",
                 n_mfcc: int = 64, device: DeviceLike = None):
        self.cache = ArrayCache(cache_dir)
        self.stats = stats
        self.remove_hand = remove_hand
        self.audio_feat = audio_feat
        self.n_mfcc = n_mfcc
        self.device = device
        self._mfcc_frontend = None
        self.hubert = (ArrayCache(hubert_cache_dir)
                       if hubert_cache_dir else None)

    def __len__(self) -> int:
        return len(self.cache)

    def _aud_feat(self, s: Dict[str, np.ndarray], n_frames: int
                  ) -> np.ndarray:
        if self.audio_feat == "mel":
            return s["mel"].astype(np.float32)
        if self.audio_feat == "mfcc":
            if "mfcc" in s:
                return s["mfcc"].astype(np.float32)
            # a cache built without the field: from the window's audio
            from diffsheg_tpu_torch.audio.wav import resample_poly
            if self._mfcc_frontend is None:
                from diffsheg_tpu_torch.audio.mfcc import MfccFrontend
                self._mfcc_frontend = MfccFrontend(
                    sr=18000, hop=600, n_mfcc=self.n_mfcc, drop_last=False,
                    device=self.device)
            a18 = resample_poly(np.asarray(s["audio"], np.float32), 16000,
                                18000)
            return self._mfcc_frontend(a18[None])[0, :n_frames].cpu().numpy()
        if self.audio_feat == "raw":
            a = np.asarray(s["audio"], dtype=np.float32)
            n = (len(a) // n_frames) * n_frames
            return a[:n].reshape(n_frames, -1).mean(-1, keepdims=True)
        raise ValueError(f"unknown audio_feat {self.audio_feat!r}")

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        s = self.cache[idx]
        gesture = standardize(extract_gesture(s["pose"]),
                              self.stats.pose_mean, self.stats.pose_std)
        expr = standardize(combine_expression(s["pose"], s["expression"]),
                           self.stats.expression_mean,
                           self.stats.expression_std)
        if self.remove_hand:
            gesture = gesture[..., :39]
        out = {
            "gesture": gesture.astype(np.float32),
            "expression": expr.astype(np.float32),
            "motion": np.concatenate([gesture, expr], axis=-1)
                        .astype(np.float32),
            "mel": self._aud_feat(s, gesture.shape[0]),
            "speaker": s["speaker"].astype(np.float32),
        }
        if self.hubert is not None:
            out["hubert"] = hubert_batch(self.hubert, np.asarray([idx]),
                                         gesture.shape[0])[0]
        return out

    def batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        items = [self[int(i)] for i in indices]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}
