"""Polyphase resampling on the device (``scipy.signal.resample_poly``).

Counterpart of ``diffsheg_tpu/audio/resample.py``.  BEAT stores 16 kHz
waveforms but computes mel at 18 kHz, so that hop 1200 lands on the 15 fps
motion rate (reference trainers/ddpm_beat_trainer.py:1244-1249); the cache
builder resamples on the host with scipy (``audio/wav.py``).  The speech
frontend inside the training step (``audio/frontend.py``) needs the same
9/8 resample on the card: the same FIR taps (scipy's Kaiser-5 ``firwin``,
designed on the host) and the same output alignment, so that its mel
matches the cached mel to f32 rounding.

scipy zero-stuffs the input by ``up``, correlates it with the symmetric
``2 * half_len + 1``-tap filter with ``half_len`` samples of left
padding, and keeps every ``down``-th sample; JAX writes that as one
convolution with input dilation ``up``.  A torch convolution has no input
dilation, so the port computes the polyphase form instead of stuffing
zeros: output ``q * up + p`` is a correlation of the input itself, at
stride ``down``, with the taps ``h[k_p + up * s]`` of phase ``p``, and the
``up`` phases are the ``up`` output channels of ONE strided ``conv1d``
(each phase's taps placed at its own offset in a common kernel), then
interleaved.  It reads the input once, keeps no ``up``-times larger
zero-stuffed copy (326 k samples, 1.3 MB in f32, for each 36266-sample
BEAT window at 9/8) and does none of the ``up - 1`` products in every
``up`` with a stuffed zero.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.nn import functional as F


def _reduced(up: int, down: int):
    g = math.gcd(up, down)
    return up // g, down // g


@functools.lru_cache(maxsize=8)
def polyphase_taps(up: int, down: int) -> np.ndarray:
    """The FIR scipy.signal.resample_poly designs by default
    (window=('kaiser', 5.0), cutoff 1/max_rate, half-length 10*max_rate),
    scaled by ``up``."""
    from scipy.signal import firwin

    up, down = _reduced(up, down)
    max_rate = max(up, down)
    half_len = 10 * max_rate
    taps = firwin(2 * half_len + 1, 1.0 / max_rate,
                  window=("kaiser", 5.0)) * up
    return taps.astype(np.float64)


def output_len(n: int, up: int, down: int) -> int:
    up, down = _reduced(up, down)
    return -(-(n * up) // down)


@functools.lru_cache(maxsize=8)
def _phase_kernel(up: int, down: int):
    """(up, 1, L) float64 kernel whose row p holds phase p's taps at its
    offset, and the left pad: output ``q * up + p`` = sum over s' of
    ``kernel[p, 0, s'] * x[q * down + s' - pad]``."""
    h = polyphase_taps(up, down)
    half_len = (len(h) - 1) // 2
    phases = []
    for p in range(up):
        k0 = (half_len - p * down) % up          # first tap that hits a sample
        c = (p * down + k0 - half_len) // up     # the input index it hits
        phases.append((c, h[k0::up]))
    c_min = min(c for c, _ in phases)
    length = max(c - c_min + len(g) for c, g in phases)
    kernel = np.zeros((up, 1, length))
    for p, (c, g) in enumerate(phases):
        kernel[p, 0, c - c_min:c - c_min + len(g)] = g
    return kernel, -c_min


def resample_poly_device(x: torch.Tensor, up: int, down: int
                         ) -> torch.Tensor:
    """(B, N) float -> (B, output_len): scipy.resample_poly semantics, on
    ``x``'s device.  Returns ``x`` itself when ``up == down``."""
    up, down = _reduced(up, down)
    if up == 1 and down == 1:
        return x
    n = x.shape[-1]
    n_out = output_len(n, up, down)
    kernel, pad = _phase_kernel(up, down)
    q = -(-n_out // up)                    # outputs per phase
    need = (q - 1) * down + kernel.shape[-1]
    xp = F.pad(x[:, None, :], (pad, max(need - pad - n, 0)))
    w = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    out = F.conv1d(xp, w, stride=down)[..., :q]          # (B, up, q)
    return out.transpose(1, 2).reshape(x.shape[0], q * up)[:, :n_out]
