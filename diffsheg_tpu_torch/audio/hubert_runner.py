"""Long-audio HuBERT feature extraction with static-shape chunking.

Counterpart of ``diffsheg_tpu/audio/hubert_runner.py``: the conv frontend
is one kernel-400 / stride-320 conv, so long audio is cut into chunks of
``320 * 1000`` samples extended by ``kernel - stride``; every chunk,
including the remainder, is padded to the same length and encoded in one
batch, the remainder's pad frames masked out (a 60 s clip's third chunk
is such a remainder); the frames are stitched, padded or trimmed to
``(N - 80) // 320`` and linearly resampled to the motion frame rate.
:meth:`HubertFeatureExtractor.encode_left_context` is a live session's
encode of one window with left context.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

from diffsheg_tpu_torch.device import DeviceLike, resolve_device, torch_dtype
from diffsheg_tpu_torch.models.factory import random_init_
from diffsheg_tpu_torch.models.hubert import (HubertConfig, HubertModel,
                                              normalize_waveform)
from diffsheg_tpu_torch.utils.profiling import span

KERNEL = 400
STRIDE = 320
CLIP_FRAMES = 1000
CLIP_SAMPLES = STRIDE * CLIP_FRAMES             # 320_000
CHUNK_SAMPLES = CLIP_SAMPLES - STRIDE + KERNEL  # 320_080


def expected_frames(num_samples: int) -> int:
    return (num_samples - (KERNEL - STRIDE)) // STRIDE


def linear_resample(x: torch.Tensor, new_len: int) -> torch.Tensor:
    """F.interpolate(mode='linear', align_corners=True) along axis 1 of
    (B, T, C), weights in f32."""
    B, T, C = x.shape
    if T == new_len:
        return x
    pos = torch.linspace(0.0, T - 1.0, new_len, device=x.device)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=T - 1)
    w = (pos - lo)[None, :, None]
    return x[:, lo] * (1.0 - w) + x[:, hi] * w


class HubertFeatureExtractor:
    """Chunked long-audio speech-encoder runner.  ``model`` defaults to an
    encoder of ``cfg`` (default HuBERT-large; any layout of
    ``models/hubert.py``, WavLM-Large's too) with seeded random weights; it
    is cast to ``cfg.dtype`` and moved to ``device`` (default: the GPU)."""

    def __init__(self, cfg: Optional[HubertConfig] = None,
                 model: Optional[HubertModel] = None, seed: int = 0,
                 device: DeviceLike = None):
        self.cfg = cfg or (model.cfg if model is not None else HubertConfig())
        self.device = resolve_device(device)
        if model is None:
            model = random_init_(HubertModel(self.cfg), seed)
        self.model = model.to(device=self.device,
                              dtype=torch_dtype(self.cfg.dtype)).eval()

    @torch.no_grad()
    def __call__(self, audio_16k, target_frames: Optional[int] = None):
        """audio (N,) or (1, N) float32 at 16 kHz -> (1, T, hidden)."""
        with span("frontend.hubert"):
            audio = torch.as_tensor(audio_16k, dtype=torch.float32,
                                    device=self.device)
            if audio.dim() == 1:
                audio = audio[None]
            n = audio.shape[1]
            exp_t = expected_frames(n)
            plan = [(CLIP_SAMPLES * i,
                     min(CHUNK_SAMPLES, n - CLIP_SAMPLES * i))
                    for i in range(n // CLIP_SAMPLES)]
            rest = CLIP_SAMPLES * (n // CLIP_SAMPLES)
            if n - rest >= KERNEL:
                plan.append((rest, n - rest))
            if not plan:   # shorter than one kernel: no frames
                return torch.zeros(
                    (1, target_frames or 0, self.cfg.hidden_size),
                    device=self.device)
            valid = [(length - KERNEL) // STRIDE + 1 for _, length in plan]
            full = (CHUNK_SAMPLES - KERNEL) // STRIDE + 1
            frame_mask = None
            if any(length < CHUNK_SAMPLES for _, length in plan):
                frame_mask = torch.as_tensor(
                    np.arange(full)[None, :] < np.asarray(valid)[:, None],
                    device=self.device)
            audio = normalize_waveform(audio)
            batch = torch.cat([F.pad(audio[:, s:s + length],
                                     (0, CHUNK_SAMPLES - length))
                               for s, length in plan])
            feats = self.model(batch, frame_mask)         # (chunks, F, H)
            seq = torch.cat([feats[i, :v] for i, v in enumerate(valid)])[None]
            if seq.shape[1] < exp_t:
                seq = F.pad(seq, (0, 0, 0, exp_t - seq.shape[1]))
            else:
                seq = seq[:, :exp_t]
            if target_frames is not None:
                seq = linear_resample(seq, target_frames)
            return seq

    @torch.no_grad()
    def encode_left_context(self, seg, pad_left: int, skip_frames: int,
                            want: int, target_frames: int) -> torch.Tensor:
        """One live window's features with left context (JAX
        ``sampling/live.py:206-243``): ``seg`` (N,) is context ++ window,
        its first ``pad_left`` samples zero padding while the stream is
        younger than the context.  Normalises over the real samples only,
        masks the frames whose receptive field touches the pad
        (``first_valid = ceil(pad_left / STRIDE)``), encodes, keeps frames
        ``[skip_frames, skip_frames + want)`` and resamples them to
        ``target_frames`` -> (1, target_frames, hidden)."""
        seg = torch.as_tensor(seg, dtype=torch.float32, device=self.device)
        n = seg.shape[0]
        valid = (torch.arange(n, device=self.device) >= pad_left).float()
        n_valid = float(max(n - pad_left, 1))
        mean = (seg * valid).sum() / n_valid
        var = (((seg - mean) * valid) ** 2).sum() / n_valid
        segn = (seg - mean) * torch.rsqrt(var + 1e-7) * valid
        first_valid = -(-pad_left // STRIDE)
        mask = (torch.arange(expected_frames(n), device=self.device)
                >= first_valid)[None]
        feats = self.model(segn[None], mask)
        return linear_resample(feats[:, skip_frames:skip_frames + want],
                               target_frames)
