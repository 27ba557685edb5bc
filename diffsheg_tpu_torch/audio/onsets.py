"""Audio onset detection for the BeatAlign metric (librosa's algorithm).

The port's own copy of ``diffsheg_tpu/audio/onsets.py``: librosa
``onset_detect``'s published algorithm with its defaults (librosa 0.10):

  1. ``onset_strength``: the dB mel spectrogram (``power_to_db``: 10
     log10, amin 1e-10, floored at max - 80), its positive first
     difference at lag 1 averaged over bands, padded at the start;
  2. ``peak_pick`` with onset_detect's windows from the frame rate
     ``sr / hop``: pre_max = ceil(0.03 fps), post_max = 1, pre_avg =
     ceil(0.10 fps), post_avg = ceil(0.10 fps) + 1, delta 0.07, wait =
     ceil(0.03 fps), on the envelope scaled to [0, 1].

The mel runs through ``audio/mel.py`` on the caller's device (the card
unless the caller asks for the CPU); the envelope and the peak picking
are host numpy.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from diffsheg_tpu_torch.device import DeviceLike


def power_to_db(S: np.ndarray, amin: float = 1e-10,
                top_db: float = 80.0) -> np.ndarray:
    """librosa.power_to_db with ref=1.0: 10*log10(max(S, amin)), floored
    at ``max - top_db``."""
    log_spec = 10.0 * np.log10(np.maximum(S, amin))
    return np.maximum(log_spec, log_spec.max() - top_db)


def onset_strength(mel: np.ndarray, lag: int = 1,
                   center_shift: int = 0) -> np.ndarray:
    """(T, M) power mel -> (T,) onset envelope: the positive lag
    difference of the dB mel averaged over bands, zero-padded by ``lag +
    center_shift`` at the start and cut back to T (``center_shift``:
    librosa's compensation of a centred STFT, ``n_fft // (2 * hop)``)."""
    T = mel.shape[0]
    S = power_to_db(mel)
    flux = np.maximum(S[lag:] - S[:-lag], 0.0).mean(axis=1)
    env = np.concatenate([np.zeros(lag + center_shift), flux])
    return env[:T]


def peak_pick(env: np.ndarray, pre_max: int, post_max: int,
              pre_avg: int, post_avg: int, delta: float,
              wait: int) -> np.ndarray:
    """librosa.util.peak_pick on a 1-D envelope -> onset frame indices:
    the max of ``env[i-pre_max : i+post_max]``, at least the mean of
    ``env[i-pre_avg : i+post_avg]`` + ``delta`` (both windows clipped to
    the array), and more than ``wait`` frames after the last onset."""
    T = len(env)
    onsets = []
    last = -(wait + 1)
    for i in range(T):
        lo_m, hi_m = max(0, i - pre_max), min(T, i + post_max)
        lo_a, hi_a = max(0, i - pre_avg), min(T, i + post_avg)
        if env[i] != env[lo_m:hi_m].max():
            continue
        if env[i] < env[lo_a:hi_a].mean() + delta:
            continue
        if i - last <= wait:
            continue
        onsets.append(i)
        last = i
    return np.asarray(onsets, dtype=np.int64)


def pick_onsets(envelope: np.ndarray, hop_seconds: float,
                delta: float = 0.07) -> np.ndarray:
    """Onset times in seconds, with onset_detect's default windows from
    the frame rate and its ``normalize=True`` (the envelope shifted to min
    0 and scaled to max 1, which calibrates ``delta``)."""
    if len(envelope) == 0:
        return np.zeros((0,))
    envelope = envelope - envelope.min()
    peak = envelope.max()
    if peak > 0:
        envelope = envelope / peak
    fps = 1.0 / hop_seconds
    frames = peak_pick(
        envelope,
        pre_max=int(math.ceil(0.03 * fps)),
        post_max=int(math.ceil(0.00 * fps)) + 1,
        pre_avg=int(math.ceil(0.10 * fps)),
        post_avg=int(math.ceil(0.10 * fps)) + 1,
        delta=delta,
        wait=int(math.ceil(0.03 * fps)),
    )
    return frames * hop_seconds


def audio_onset_times(audio: np.ndarray, sr: int,
                      mel: Optional[np.ndarray] = None,
                      hop: Optional[int] = None,
                      device: DeviceLike = None) -> np.ndarray:
    """Waveform -> onset times in seconds.  Without ``mel`` the (T, 64)
    power mel is computed on ``device`` (default: the GPU; raises without
    one) with a 512-point window (32 ms at 16 kHz: the 2048 default smears
    onsets by ~60 ms) and ``hop`` (default 10 ms frames)."""
    n_fft = 512
    if mel is None:
        from diffsheg_tpu_torch.audio.mel import MelFrontend
        hop = hop or sr // 100
        fe = MelFrontend(sr=sr, n_fft=n_fft, hop=hop, n_mels=64,
                         drop_last=True, device=device)
        mel = fe(np.array(audio, dtype=np.float32)[None])[0].cpu().numpy()
    elif hop is None:
        raise ValueError("hop is required with a precomputed mel")
    env = onset_strength(mel, center_shift=n_fft // (2 * hop))
    return pick_onsets(env, hop / sr)
