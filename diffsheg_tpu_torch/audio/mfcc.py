"""MFCC frontend (librosa.feature.mfcc numerics, JAX's top_db rule).

Counterpart of ``diffsheg_tpu/audio/mfcc.py``, the SHOW cache's ``mfcc``
field (``data.audio_feat='mfcc'``):

    S    = mel power spectrogram (``audio/mel.py``, Slaney filters)
    db   = power_to_db(S, ref=1.0, amin=1e-10, top_db=80)
    mfcc = dct(db, type=2, norm='ortho')[..., :n_mfcc]

The ``top_db`` floor is taken per sample, as the JAX package does
(librosa takes it over the whole spectrogram).  The DCT-II basis is built
in float64 and applied as one float32 product, on the frontend's device
(the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from diffsheg_tpu_torch.audio.mel import MelFrontend
from diffsheg_tpu_torch.device import DeviceLike


def dct_ii_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II basis, (n_in, n_out) float64: y = x @ M equals
    scipy.fftpack.dct(x, type=2, norm='ortho', axis=-1)[..., :n_out]."""
    n = np.arange(n_in, dtype=np.float64)
    k = np.arange(n_out, dtype=np.float64)
    basis = 2.0 * np.cos(np.pi * (2.0 * n[:, None] + 1.0) * k[None, :]
                         / (2.0 * n_in))
    # ortho: f(0) = sqrt(1/4N), f(k>0) = sqrt(1/2N), on the 2x basis
    scale = np.full(n_out, np.sqrt(1.0 / (2.0 * n_in)))
    scale[0] = np.sqrt(1.0 / (4.0 * n_in))
    return basis * scale[None, :]


def power_to_db(S: torch.Tensor, amin: float = 1e-10,
                top_db: float = 80.0) -> torch.Tensor:
    """librosa.power_to_db with ref=1.0, the ``top_db`` floor per sample
    (the max over every axis but the first)."""
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    if top_db is not None:
        peak = log_spec.amax(dim=tuple(range(1, S.dim())), keepdim=True)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


class MfccFrontend:
    """(B, N) waveform -> (B, T, n_mfcc) MFCCs."""

    def __init__(self, sr: int = 18000, hop: int = 600, n_mels: int = 128,
                 n_mfcc: int = 64, drop_last: bool = True,
                 device: DeviceLike = None):
        self.mel = MelFrontend(sr=sr, hop=hop, n_mels=n_mels,
                               drop_last=drop_last, device=device)
        self.device = self.mel.device
        self.n_mfcc = n_mfcc
        self._dct = torch.as_tensor(dct_ii_matrix(n_mels, n_mfcc),
                                    dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def __call__(self, audio) -> torch.Tensor:
        return self.from_mel(self.mel(audio))

    @torch.no_grad()
    def from_mel(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) mel power spectrogram of ``self.mel`` ->
        (B, T, n_mfcc) MFCCs."""
        return power_to_db(mel) @ self._dct
