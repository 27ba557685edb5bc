"""BEAT: the offline cache builder, statistics and the window dataset.

The port's own copy of ``diffsheg_tpu/data/beat.py`` (reference
datasets/beat.py:24-455 onto the memory-mapped ``data/cache.py`` format):

  build_beat_cache(...)  one pass over a split directory
    - ``bvh_rot`` numeric euler-degree frames (``runtime``'s parser);
    - the 16 kHz waveform ``.npy``;
    - facial52 blendshapes normalized by the statistics
      (``geometry/face.py``);
    - a per-frame semantic score from the ``sem`` TSV, with the BEAT
      session-"b" time offset;
    - speaker id = int(file name prefix) - 1;
    - every modality clamped to the common whole-second duration, then
      (n_poses, stride) windows, or the whole clip for the test split;
    - the mean-pose-difference filter;
    - word / emo per-frame labels where ``<rep>/<id>.npy`` exists, else a
      window-length ``-1`` sentinel;
    - the mel of every window of a clip in one batch and euler ->
      axis-angle for all its frames, both on the builder's device (the
      card unless the caller asks for the CPU), only the results copied
      back; the 16 kHz -> 18 kHz resample stays on the host (scipy);
    - z-normalization with the dataset statistics (stored
      ``(x - mean) / std``).

  compute_beat_stats(...)  mean / std of euler pose, axis-angle pose and
    facial channels over a split.

  BeatDataset
    - memory-mapped random access; numpy dict batches with the keys the
      trainer consumes: pose, pose_axis_angle, mel, facial, sem, id (+ an
      optional HuBERT cache's features resampled to the window length).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, Optional

import numpy as np
import torch

from diffsheg_tpu_torch.data.cache import (ArrayCache, CacheWriter,
                                           cache_exists)
from diffsheg_tpu_torch.device import DeviceLike, resolve_device


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


def parse_numeric_frames(path: str) -> np.ndarray:
    """A whitespace-separated numeric frame file (the preprocessed
    ``bvh_rot`` exports: header-less euler-degree rows) -> (T, C)
    float64."""
    from diffsheg_tpu_torch import runtime
    return runtime.parse_frames_file(path)


def semantic_scores_per_frame(sem_tsv_path: str, n_frames: int, fps: float,
                              time_offset: float = 0.0) -> np.ndarray:
    """Per-frame semantic relevance score from the BEAT ``sem`` TSV
    (columns name/start/end/duration/score/keywords): each frame time
    against every [start, end] interval at once; the first interval that
    holds it wins, 0 elsewhere."""
    rows = []
    with open(sem_tsv_path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 5:
                try:
                    rows.append((float(parts[1]), float(parts[2]),
                                 float(parts[4])))
                except ValueError:
                    continue
    scores = np.zeros(n_frames, dtype=np.float64)
    if not rows:
        return scores
    starts = np.array([r[0] for r in rows])
    ends = np.array([r[1] for r in rows])
    vals = np.array([r[2] for r in rows])
    t = np.arange(n_frames) / fps + time_offset
    inside = (starts[None, :] <= t[:, None]) & (t[:, None] <= ends[None, :])
    first = np.argmax(inside, axis=1)
    has = inside.any(axis=1)
    scores[has] = vals[first[has]]
    return scores


def session_time_offset(clip_id: str) -> float:
    """BEAT 'b'-session annotation offset (reference beat.py:211-215)."""
    parts = clip_id.split("_")
    if parts[-1] == "b":
        return 30.0 if int(parts[-3]) % 2 == 0 else 300.0
    return 0.0


def motion_window_passes_filter(window: np.ndarray, mean_pose: np.ndarray,
                                threshold: float = 0.02) -> bool:
    """Mean-pose-difference filter: drop windows that barely deviate from
    the dataset mean (MotionPreprocessor.check_pose_diff)."""
    return float(np.mean(np.abs(window - mean_pose))) >= threshold


@dataclasses.dataclass
class BeatBuildConfig:
    n_poses: int = 34
    stride: int = 10
    pose_fps: float = 15.0
    audio_sr: int = 16000
    mel_sr: int = 18000
    mel_hop: int = 1200
    n_mels: int = 128
    disable_filtering: bool = False
    pose_rep: str = "bvh_rot"
    audio_rep: str = "wave16k"
    facial_rep: str = "facial52"
    sem_rep: str = "sem"
    # per-frame word-token / emotion-label arrays (<root>/<rep>/<id>.npy,
    # an int a frame), ingested where present, else a -1 sentinel
    word_rep: str = "word"
    emo_rep: str = "emo"


def _mel_windows(audio_windows: np.ndarray, cfg: BeatBuildConfig,
                 n_poses: int, device: DeviceLike = None) -> np.ndarray:
    """Every window's mel in one batch on ``device``: each window
    resampled 16 -> 18 kHz on the host first."""
    from diffsheg_tpu_torch.audio.mel import MelFrontend
    from diffsheg_tpu_torch.audio.wav import resample_poly

    res = np.stack([resample_poly(a, cfg.audio_sr, cfg.mel_sr)
                    for a in audio_windows])
    frontend = MelFrontend(sr=cfg.mel_sr, hop=cfg.mel_hop, n_mels=cfg.n_mels,
                           drop_last=False, device=device)
    return frontend(res)[:, :n_poses].cpu().numpy()


# rotations converted a chunk at a time on the device, to bound its memory
_AA_CHUNK = 1 << 20


def _euler_deg_to_axis_angle(pose_deg: np.ndarray,
                             device: DeviceLike = None) -> np.ndarray:
    """(..., C) euler degrees -> axis-angle, float32 (reference
    beat.py:376-385): radians on the host in float64, cast to float32,
    every joint's XYZ rotation converted on ``device``."""
    from diffsheg_tpu_torch.geometry.rotations import euler_to_axis_angle
    dev = resolve_device(device)
    shape = pose_deg.shape
    flat = torch.from_numpy(
        np.deg2rad(pose_deg).reshape(-1, 3).astype(np.float32))
    out = torch.empty_like(flat)
    with torch.no_grad():
        for i in range(0, flat.shape[0], _AA_CHUNK):
            out[i:i + _AA_CHUNK] = euler_to_axis_angle(
                flat[i:i + _AA_CHUNK].to(dev), "XYZ").cpu()
    return out.numpy().reshape(shape)


def build_beat_cache(
    data_dir: str,
    out_dir: str,
    stats: BeatStats,
    cfg: Optional[BeatBuildConfig] = None,
    is_test: bool = False,
    log=print,
    device: DeviceLike = None,
) -> int:
    """Build the window cache of one split directory; returns the number
    of samples.  The mel and the axis-angle conversion run on ``device``
    (default: the GPU; raises without one)."""
    from diffsheg_tpu_torch.geometry.face import read_face_json
    device = resolve_device(device)
    cfg = cfg or BeatBuildConfig()
    pose_files = sorted(glob.glob(
        os.path.join(data_dir, cfg.pose_rep, "*.bvh")))
    writer = CacheWriter(out_dir, meta={
        "n_poses": cfg.n_poses, "stride": cfg.stride, "is_test": is_test,
        "fps": cfg.pose_fps,
    })
    n_filtered = 0

    for pose_file in pose_files:
        clip_id = os.path.basename(pose_file)[:-4]
        pose = parse_numeric_frames(pose_file)             # (F, 141) degrees

        audio_file = os.path.join(data_dir, cfg.audio_rep, clip_id + ".npy")
        facial_file = os.path.join(data_dir, cfg.facial_rep, clip_id + ".json")
        sem_file = os.path.join(data_dir, cfg.sem_rep, clip_id + ".txt")
        if not (os.path.exists(audio_file) and os.path.exists(facial_file)):
            log(f"[beat-cache] missing audio/facial for {clip_id}, skipped")
            continue
        audio = np.load(audio_file).astype(np.float32)
        facial = read_face_json(facial_file, stats.mean_facial,
                                stats.std_facial)
        offset = session_time_offset(clip_id)
        sem = (semantic_scores_per_frame(sem_file, pose.shape[0],
                                         cfg.pose_fps, offset)
               if os.path.exists(sem_file)
               else np.zeros(pose.shape[0]))
        speaker = int(clip_id.split("_")[0]) - 1

        def _labels(rep):
            path = os.path.join(data_dir, rep, clip_id + ".npy")
            if os.path.exists(path):
                return np.load(path).astype(np.int32)
            return None
        word = _labels(cfg.word_rep)
        emo = _labels(cfg.emo_rep)

        # every modality clamped to the common whole-second duration
        secs = min(pose.shape[0] // int(cfg.pose_fps),
                   len(audio) // cfg.audio_sr,
                   facial.shape[0] // int(cfg.pose_fps))
        n_pose_frames = int(secs * cfg.pose_fps)

        if is_test:     # the test split keeps whole clips
            length, stride = n_pose_frames, n_pose_frames
        else:
            length, stride = cfg.n_poses, cfg.stride
        if n_pose_frames < length:
            continue
        num_windows = (n_pose_frames - length) // stride + 1
        audio_len = int(length / cfg.pose_fps * cfg.audio_sr)

        pose_w, audio_w, facial_w, sem_w = [], [], [], []
        word_w, emo_w = [], []
        for i in range(num_windows):
            s = i * stride
            w = pose[s:s + length]
            if not cfg.disable_filtering and not is_test and \
                    not motion_window_passes_filter(w, stats.mean_pose):
                n_filtered += 1
                continue
            a_s = int(i * stride * cfg.audio_sr / cfg.pose_fps)
            pose_w.append(w)
            audio_w.append(audio[a_s:a_s + audio_len])
            facial_w.append(facial[s:s + length])
            sem_w.append(sem[s:s + length])
            # a window-length sentinel keeps the field fixed-shape
            sentinel = np.full((w.shape[0],), -1, dtype=np.int32)
            word_w.append(word[s:s + length] if word is not None
                          else sentinel)
            emo_w.append(emo[s:s + length] if emo is not None else sentinel)
        if not pose_w:
            continue

        mel = _mel_windows(np.stack(audio_w), cfg, length, device)
        axis_angle = _euler_deg_to_axis_angle(np.stack(pose_w), device)
        for i in range(len(pose_w)):
            writer.add({
                "pose": ((pose_w[i] - stats.mean_pose)
                         / stats.std_pose).astype(np.float32),
                "pose_axis_angle": ((axis_angle[i] - stats.mean_axis_angle)
                                    / stats.std_axis_angle).astype(np.float32),
                "audio": audio_w[i].astype(np.float32),
                "mel": mel[i].astype(np.float32),
                "facial": facial_w[i].astype(np.float32),
                "sem": sem_w[i].astype(np.float32),
                "id": np.asarray([speaker], dtype=np.int32),
                "word": word_w[i],
                "emo": emo_w[i],
            })
        log(f"[beat-cache] {clip_id}: {len(pose_w)} windows")

    writer.finalize()
    log(f"[beat-cache] wrote {len(writer)} samples to {out_dir} "
        f"({n_filtered} filtered)")
    return len(writer)


def compute_beat_stats(data_dir: str, cfg: Optional[BeatBuildConfig] = None,
                       log=print, device: DeviceLike = None) -> BeatStats:
    """Mean / std of euler pose, axis-angle pose (converted on
    ``device``) and facial channels over every clip of a split."""
    from diffsheg_tpu_torch.geometry.face import read_face_json
    device = resolve_device(device)
    cfg = cfg or BeatBuildConfig()
    pose_files = sorted(glob.glob(
        os.path.join(data_dir, cfg.pose_rep, "*.bvh")))
    p_sum = p_sq = f_sum = f_sq = a_sum = a_sq = None
    n_p = n_f = 0
    for pose_file in pose_files:
        clip_id = os.path.basename(pose_file)[:-4]
        pose = parse_numeric_frames(pose_file)
        aa = _euler_deg_to_axis_angle(pose, device)
        facial_file = os.path.join(data_dir, cfg.facial_rep, clip_id + ".json")
        if p_sum is None:
            C = pose.shape[1]
            p_sum, p_sq = np.zeros(C), np.zeros(C)
            a_sum, a_sq = np.zeros(C), np.zeros(C)
        p_sum += pose.sum(0)
        p_sq += (pose ** 2).sum(0)
        a_sum += aa.sum(0)
        a_sq += (aa ** 2).sum(0)
        n_p += pose.shape[0]
        if os.path.exists(facial_file):
            fw = read_face_json(facial_file)
            if f_sum is None:
                f_sum, f_sq = np.zeros(fw.shape[1]), np.zeros(fw.shape[1])
            f_sum += fw.sum(0)
            f_sq += (fw ** 2).sum(0)
            n_f += fw.shape[0]
    if n_p == 0:
        raise ValueError(f"no pose files under {data_dir}/{cfg.pose_rep}")

    def std(sq, s, n):
        return np.sqrt(np.maximum(sq / n - (s / n) ** 2, 1e-12))
    return BeatStats(
        mean_pose=p_sum / n_p, std_pose=std(p_sq, p_sum, n_p),
        mean_axis_angle=a_sum / n_p, std_axis_angle=std(a_sq, a_sum, n_p),
        mean_facial=(f_sum / n_f if n_f else np.zeros(51)),
        std_facial=(std(f_sq, f_sum, n_f) if n_f else np.ones(51)),
    )


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
