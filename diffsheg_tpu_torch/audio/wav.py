"""Host-side audio IO.

The port's own copy of ``diffsheg_tpu/audio/wav.py`` (numpy and scipy only).

The reference uses librosa.load (22.05 kHz default) + librosa.resample
(trainers/ddpm_beat_trainer.py:1236-1240).  This module reads PCM WAV with the
stdlib and resamples with scipy's polyphase filter — no external audio stack.

Note on a reference quirk: the reference feeds the *22.05 kHz* decoded audio
to a HuBERT processor declared at 16 kHz (ddpm_beat_trainer.py:1236,1264).
We resample properly to each consumer's rate (18 kHz mel, 16 kHz HuBERT);
the training caches were built from true 16 kHz audio (datasets/beat.py:188),
so this matches training-time statistics, not the inference bug.
"""

from __future__ import annotations

import wave
from fractions import Fraction
from typing import Tuple

import numpy as np
from scipy.signal import resample_poly as _scipy_resample_poly


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 mono samples in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)

    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        b = (a[:, 0].astype(np.int32)
             | (a[:, 1].astype(np.int32) << 8)
             | (a[:, 2].astype(np.int32) << 16))
        b = np.where(b & 0x800000, b - 0x1000000, b)
        data = b.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported sample width {width}")

    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def resample_poly(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy), rate ratio reduced to lowest terms."""
    if orig_sr == target_sr:
        return y.astype(np.float32)
    frac = Fraction(target_sr, orig_sr).limit_denominator(1000)
    out = _scipy_resample_poly(y.astype(np.float64), frac.numerator, frac.denominator)
    return out.astype(np.float32)
