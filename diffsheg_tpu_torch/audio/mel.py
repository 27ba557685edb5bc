"""Mel spectrogram frontend (librosa-0.9.2-compatible numerics).

Counterpart of ``diffsheg_tpu/audio/mel.py``: n_fft 2048, periodic Hann
window, centred frames with reflect padding, power 2, Slaney mel filters,
fmax = sr / 2.  The JAX package computes the DFT as a matmul on the TPU
(no FFT unit there); here it is ``torch.fft.rfft``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from diffsheg_tpu_torch.device import DeviceLike, resolve_device


F_SP = 200.0 / 3            # Slaney scale: linear below 1 kHz, log above
MIN_LOG_HZ = 1000.0
MIN_LOG_MEL = MIN_LOG_HZ / F_SP
LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(f) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    return np.where(f >= MIN_LOG_HZ,
                    MIN_LOG_MEL + np.log(np.maximum(f, MIN_LOG_HZ)
                                         / MIN_LOG_HZ) / LOGSTEP,
                    f / F_SP)


def _mel_to_hz(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= MIN_LOG_MEL,
                    MIN_LOG_HZ * np.exp(LOGSTEP * (m - MIN_LOG_MEL)), F_SP * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-normalised triangular mel filters from 0 Hz to sr / 2,
    (n_mels, 1 + n_fft//2) float32, as librosa.filters.mel."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_min, mel_max = _hz_to_mel(np.array([0.0, sr / 2.0]))
    hz_pts = _mel_to_hz(np.linspace(mel_min, mel_max, n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights = weights * (2.0 / (hz_pts[2:] - hz_pts[:-2]))[:, None]
    return weights.astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann, the librosa default."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


class MelFrontend:
    """``MelFrontend(sr=18000, hop=1200)(audio)``: audio (B, N) float32 ->
    (B, T, n_mels), the final frame dropped so T = N // hop."""

    def __init__(self, sr: int = 18000, n_fft: int = 2048, hop: int = 1200,
                 n_mels: int = 128, device: DeviceLike = None):
        self.sr, self.n_fft, self.hop, self.n_mels = sr, n_fft, hop, n_mels
        self.device = resolve_device(device)
        self._filters = torch.as_tensor(
            mel_filterbank(sr, n_fft, n_mels).T, device=self.device)  # (F, M)
        self._window = torch.as_tensor(hann_window(n_fft), device=self.device)

    @torch.no_grad()
    def __call__(self, y) -> torch.Tensor:
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        if y.dim() == 1:
            y = y[None]
        half = self.n_fft // 2
        y = F.pad(y[:, None], (half, half), mode="reflect")[:, 0]
        frames = y.unfold(-1, self.n_fft, self.hop) * self._window
        spec = torch.fft.rfft(frames, n=self.n_fft, dim=-1)
        mel = (spec.real ** 2 + spec.imag ** 2) @ self._filters
        return mel[:, :-1]
