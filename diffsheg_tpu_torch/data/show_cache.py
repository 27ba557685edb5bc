"""SHOW / TalkSHOW cache builder.

The port's own copy of ``diffsheg_tpu/data/show_cache.py``: per-sequence
SMPL-X arrays (raw 165-d pose, 100-d expression, 16 kHz audio, speaker id)
windowed into ``n_poses``-frame clips (88 at 30 fps for the shipped
config), the whole clip for the test split; the mel and MFCC conditioning
of every window of a sequence in one batch on the builder's device (the
card unless the caller asks for the CPU), after one host 16 -> 18 kHz
resample; written as the memory-mapped cache that
``data/show.py::ShowDataset`` reads.

Input sources:
  - :func:`iter_npz_dir` — a directory of ``.npz`` files with keys
    {pose, expression, audio, speaker};
  - any iterable of dicts with those keys.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, Iterable, Iterator, Optional

import numpy as np

from diffsheg_tpu_torch.data.cache import CacheWriter
from diffsheg_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class ShowBuildConfig:
    n_poses: int = 88            # training window (reference runner.py:196)
    stride: int = 10
    pose_fps: float = 30.0
    audio_sr: int = 16000
    mel_sr: int = 18000
    mel_hop: int = 600           # mel_sr / fps
    n_mels: int = 128
    n_mfcc: int = 64             # data.audio_feat='mfcc' dims
    num_speakers: int = 4
    speaker_id_offset: int = 20  # reference ids 20..23 -> one-hot 0..3


def iter_npz_dir(path: str) -> Iterator[Dict[str, np.ndarray]]:
    for f in sorted(glob.glob(os.path.join(path, "*.npz"))):
        with np.load(f, allow_pickle=False) as z:
            yield {k: z[k] for k in ("pose", "expression", "audio", "speaker")}


def _features(audio_windows: np.ndarray, cfg: ShowBuildConfig,
              n_poses: int, device: DeviceLike = None):
    """(mel, mfcc) of every window, each (N, n_poses, .): the windows
    resampled 16 -> 18 kHz once on the host, the mel once on ``device``
    and the MFCC from it."""
    from diffsheg_tpu_torch.audio.mfcc import MfccFrontend
    from diffsheg_tpu_torch.audio.wav import resample_poly
    res = np.stack([resample_poly(a, cfg.audio_sr, cfg.mel_sr)
                    for a in audio_windows])
    fe = MfccFrontend(sr=cfg.mel_sr, hop=cfg.mel_hop, n_mels=cfg.n_mels,
                      n_mfcc=cfg.n_mfcc, drop_last=False, device=device)
    mel = fe.mel(res)
    mfcc = fe.from_mel(mel)
    return (mel[:, :n_poses].cpu().numpy(), mfcc[:, :n_poses].cpu().numpy())


def build_show_cache(
    sequences: Iterable[Dict[str, np.ndarray]],
    out_dir: str,
    cfg: Optional[ShowBuildConfig] = None,
    is_test: bool = False,
    log=print,
    device: DeviceLike = None,
) -> int:
    """Window SMPL-X sequences into the ShowDataset cache; returns the
    number of samples.

    Each sequence dict: pose (T, 165), expression (T, 100), audio (N,) at
    16 kHz, speaker a scalar int (raw TalkSHOW id or 0-based).  The mel
    and MFCC run on ``device`` (default: the GPU; raises without one).
    """
    device = resolve_device(device)
    cfg = cfg or ShowBuildConfig()
    writer = CacheWriter(out_dir, meta={
        "n_poses": cfg.n_poses, "stride": cfg.stride, "is_test": is_test,
        "fps": cfg.pose_fps,
    })

    for si, seq in enumerate(sequences):
        pose = np.asarray(seq["pose"], dtype=np.float32)
        expr = np.asarray(seq["expression"], dtype=np.float32)
        audio = np.asarray(seq["audio"], dtype=np.float32)
        spk = int(np.asarray(seq["speaker"]).reshape(()))
        if spk >= cfg.speaker_id_offset:
            spk -= cfg.speaker_id_offset
        one_hot = np.eye(cfg.num_speakers,
                         dtype=np.float32)[spk % cfg.num_speakers]

        T = min(pose.shape[0], expr.shape[0],
                int(len(audio) / cfg.audio_sr * cfg.pose_fps))
        if is_test:
            length, stride = T, T
        else:
            length, stride = cfg.n_poses, cfg.stride
        if T < length:
            log(f"[show-cache] seq {si}: too short ({T} frames), skipped")
            continue

        num_windows = (T - length) // stride + 1
        audio_len = int(length / cfg.pose_fps * cfg.audio_sr)
        p_w, e_w, a_w = [], [], []
        for i in range(num_windows):
            s = i * stride
            a_s = int(s / cfg.pose_fps * cfg.audio_sr)
            p_w.append(pose[s:s + length])
            e_w.append(expr[s:s + length])
            a_w.append(audio[a_s:a_s + audio_len])
        mel, mfcc = _features(np.stack(a_w), cfg, length, device)
        for i in range(num_windows):
            writer.add({
                "pose": p_w[i],
                "expression": e_w[i],
                "mel": mel[i].astype(np.float32),
                "mfcc": mfcc[i].astype(np.float32),
                "speaker": one_hot,
                "audio": a_w[i],
            })
        log(f"[show-cache] seq {si}: {num_windows} windows (speaker {spk})")

    writer.finalize()
    log(f"[show-cache] wrote {len(writer)} samples to {out_dir}")
    return len(writer)


def compute_show_stats(sequences: Iterable[Dict[str, np.ndarray]]
                       ) -> Dict[str, np.ndarray]:
    """Mean / std dict in the reference's ``talkshow_mean_std.npy`` layout
    (pose_mean/std over 165 dims, expression_mean/std over 100), which
    ``data/show.py::ShowStats`` reads."""
    p_sum = p_sq = e_sum = e_sq = None
    n = 0
    for seq in sequences:
        pose = np.asarray(seq["pose"], dtype=np.float64)
        expr = np.asarray(seq["expression"], dtype=np.float64)
        if p_sum is None:
            p_sum, p_sq = np.zeros(pose.shape[1]), np.zeros(pose.shape[1])
            e_sum, e_sq = np.zeros(expr.shape[1]), np.zeros(expr.shape[1])
        m = min(pose.shape[0], expr.shape[0])
        p_sum += pose[:m].sum(0)
        p_sq += (pose[:m] ** 2).sum(0)
        e_sum += expr[:m].sum(0)
        e_sq += (expr[:m] ** 2).sum(0)
        n += m
    if n == 0:
        raise ValueError("no sequences")

    def std(sq, s):
        return np.sqrt(np.maximum(sq / n - (s / n) ** 2, 1e-12))
    return {
        "pose_mean": p_sum / n, "pose_std": std(p_sq, p_sum),
        "expression_mean": e_sum / n, "expression_std": std(e_sq, e_sum),
    }
