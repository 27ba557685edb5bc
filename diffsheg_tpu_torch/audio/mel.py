"""Mel spectrogram frontend (librosa-0.9.2-compatible numerics).

Counterpart of ``diffsheg_tpu/audio/mel.py``: n_fft 2048, periodic Hann
window, centred frames with reflect padding, power 2, Slaney mel filters,
fmax = sr / 2.  The JAX package computes the DFT as a matmul on the TPU
(no FFT unit there); here it is ``torch.fft.rfft``.  :func:`stft_magsq`
is the one STFT of the port: the offline frontend runs it centred, a live
session's fixed window segments uncentred (``sampling/live.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

from diffsheg_tpu_torch.device import DeviceLike, resolve_device
from diffsheg_tpu_torch.utils.profiling import span


F_SP = 200.0 / 3            # Slaney scale: linear below 1 kHz, log above
MIN_LOG_HZ = 1000.0
MIN_LOG_MEL = MIN_LOG_HZ / F_SP
LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(f, htk: bool = False) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    return np.where(f >= MIN_LOG_HZ,
                    MIN_LOG_MEL + np.log(np.maximum(f, MIN_LOG_HZ)
                                         / MIN_LOG_HZ) / LOGSTEP,
                    f / F_SP)


def _mel_to_hz(m, htk: bool = False) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    return np.where(m >= MIN_LOG_MEL,
                    MIN_LOG_HZ * np.exp(LOGSTEP * (m - MIN_LOG_MEL)), F_SP * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None, htk: bool = False,
                   norm: Optional[str] = "slaney") -> np.ndarray:
    """Triangular mel filters, (n_mels, 1 + n_fft//2) float32, as
    librosa.filters.mel: band edges evenly spaced on the Slaney (or, with
    ``htk``, the HTK) mel scale from ``fmin`` to ``fmax`` (default sr /
    2), Slaney area normalisation unless ``norm`` is None."""
    fmax = fmax if fmax is not None else sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_min, mel_max = _hz_to_mel(np.array([fmin, fmax]), htk)
    hz_pts = _mel_to_hz(np.linspace(mel_min, mel_max, n_mels + 2), htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        weights = weights * (2.0 / (hz_pts[2:] - hz_pts[:-2]))[:, None]
    elif norm is not None:
        raise ValueError(f"unsupported mel norm {norm!r}")
    return weights.astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann, the librosa default."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def frame_signal(y: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., N) -> (..., T, frame_length) overlapping frames,
    T = 1 + (N - frame_length) // hop."""
    return y.unfold(-1, frame_length, hop)


def stft_magsq(y: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor,
               center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """|STFT|^2 of (..., N), shape (..., T, 1 + n_fft//2); ``center`` pads
    n_fft // 2 samples each side first (``pad_mode``: 'reflect' or
    'constant', as in the JAX package)."""
    if center:
        half = n_fft // 2
        lead = y.shape[:-1]
        y = F.pad(y.reshape(-1, 1, y.shape[-1]), (half, half),
                  mode=pad_mode).reshape(*lead, -1)
    spec = torch.fft.rfft(frame_signal(y, n_fft, hop) * window, n=n_fft,
                          dim=-1)
    return spec.real ** 2 + spec.imag ** 2


class MelFrontend:
    """``MelFrontend(sr=18000, hop=1200)(audio)``: audio (B, N) float32 ->
    (B, T, n_mels); with ``drop_last`` (the reference's ``mel[..., :-1]``)
    the final frame is dropped so T = N // hop."""

    def __init__(self, sr: int = 18000, n_fft: int = 2048, hop: int = 1200,
                 n_mels: int = 128, drop_last: bool = True,
                 pad_mode: str = "reflect", device: DeviceLike = None):
        self.sr, self.n_fft, self.hop, self.n_mels = sr, n_fft, hop, n_mels
        self.drop_last, self.pad_mode = drop_last, pad_mode
        self.device = resolve_device(device)
        self._filters = torch.as_tensor(
            mel_filterbank(sr, n_fft, n_mels).T, device=self.device)  # (F, M)
        self._window = torch.as_tensor(hann_window(n_fft), device=self.device)

    @torch.no_grad()
    def __call__(self, y) -> torch.Tensor:
        with span("frontend.mel"):
            y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
            if y.dim() == 1:
                y = y[None]
            mel = stft_magsq(y, self.n_fft, self.hop, self._window,
                             pad_mode=self.pad_mode) @ self._filters
            return mel[..., :-1, :] if self.drop_last else mel
