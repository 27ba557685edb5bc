"""The speech frontend inside the training step.

Counterpart of ``diffsheg_tpu/audio/frontend.py``.  The reference extracts
HuBERT features on the host before training (trainers/
ddpm_beat_trainer.py:1429-1475) and ships mel + 1024-d HuBERT + motion to
the device every step.  With ``train.on_device_frontend`` the step takes
the cache's raw 16 kHz window audio instead (int16 on the way to the
card) and computes both features there:

  wave16 (B, S) --+-- polyphase 16k -> 18k (audio/resample.py) -> mel
                  |   (audio/mel.py), last frame dropped, T frames -> (B, T, 128)
                  +-- normalize -> speech encoder (models/hubert.py:
                      HuBERT-large unless told another, e.g. WavLM-Large)
                      in model.compute_dtype, padded / cut to the frames
                      of S samples, linearly resampled to T -> (B, T, 1024)

Both branches run under ``torch.no_grad()``: the speech encoder is frozen
(reference ddpm_beat_trainer.py:1434), so nothing differentiates through
them or keeps their activations for the backward pass (JAX's
``stop_gradient``; its ``optimization_barrier`` only steers XLA's compile
and has no counterpart).  The mel branch equals the cache builder's (host
scipy resample + the same mel) to f32 rounding; the HuBERT branch equals
the offline extractor on each window (a window is shorter than one of its
20 s chunks).

Under a profiler the two branches are the spans ``train.frontend.mel`` and
``train.frontend.encoder``, and :data:`encoder_counts` counts the windows
and chunks the encoder took since the process started.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict

import torch
from torch.nn import functional as F

from diffsheg_tpu_torch.config import Config
from diffsheg_tpu_torch.device import DeviceLike, resolve_device, torch_dtype
from diffsheg_tpu_torch.utils.profiling import span

# Windows a HuBERT forward takes at once.  A HuBERT-large window of BEAT
# (36266 samples) costs ~82 GFLOP, and its first conv's output and that
# output's norm and GELU (7251 x 512 each) take ~15 MB apiece in f32: ~37
# GB for one such tensor at the published batch of 2500 windows.  64
# windows keep each of them under 1 GB while every product still has
# 64 x 113 = 7232 token rows.  Each window is normalised and encoded on
# its own, so the chunk size changes no number.
HUBERT_CHUNK = 64

Batch = Dict[str, torch.Tensor]

# windows and chunks of HUBERT_CHUNK the frontends' encoders took
encoder_counts: collections.Counter = collections.Counter()


def make_speech_frontend(cfg: Config, hubert_model=None,
                         device: DeviceLike = None,
                         hubert_config=None) -> Callable[[Batch], Batch]:
    """``frontend(batch) -> batch``: pops ``wave16`` (B, S), float or int16
    (divided by 32768), and adds ``mel`` (B, T, n_mels), T the frames of
    ``batch['motion']``, and with ``model.add_hubert`` ``hubert`` (B, T,
    hidden) f32.  ``hubert_model`` is the frozen ``HubertModel`` (either
    weight layout loads into it, ``compat/from_jax.py``), moved to
    ``device`` (default: the GPU) in ``model.compute_dtype``; without one,
    an encoder of ``hubert_config`` (a ``HubertConfig``, default
    HuBERT-large; ``models/hubert.py::wavlm_large_config`` for WavLM-Large)
    with seeded random weights, as ``cli train`` has without
    ``--hubert-checkpoint``."""
    from diffsheg_tpu_torch.audio.hubert_runner import (expected_frames,
                                                        linear_resample)
    from diffsheg_tpu_torch.audio.mel import MelFrontend
    from diffsheg_tpu_torch.audio.resample import resample_poly_device
    from diffsheg_tpu_torch.models.hubert import normalize_waveform

    dev = resolve_device(device)
    data = cfg.data
    mel_fe = MelFrontend(sr=data.mel_sr, hop=data.mel_hop,
                         n_mels=data.n_mels, device=dev)
    hubert = None
    if cfg.model.add_hubert:
        if hubert_model is None:
            from diffsheg_tpu_torch.models.factory import random_init_
            from diffsheg_tpu_torch.models.hubert import (HubertConfig,
                                                          HubertModel)
            hubert_model = random_init_(
                HubertModel(hubert_config or HubertConfig()), 0)
        hubert = hubert_model.to(
            device=dev, dtype=torch_dtype(cfg.model.compute_dtype)).eval()

    @torch.no_grad()
    def frontend(batch: Batch) -> Batch:
        batch = dict(batch)
        wave = batch.pop("wave16")
        if wave.dtype != torch.float32:
            # the int16 transport halves the bytes to the card
            wave = wave.float() / 32768.0
        T = batch["motion"].shape[1]
        with span("train.frontend.mel"):
            res = resample_poly_device(wave, data.mel_sr, data.audio_sr)
            batch["mel"] = mel_fe(res)[:, :T]
        if hubert is not None:
            with span("train.frontend.encoder"):
                exp_t = expected_frames(wave.shape[-1])
                feats = []
                for i in range(0, wave.shape[0], HUBERT_CHUNK):
                    f = hubert(normalize_waveform(wave[i:i + HUBERT_CHUNK]))
                    f = (F.pad(f, (0, 0, 0, exp_t - f.shape[1]))
                         if f.shape[1] < exp_t else f[:, :exp_t])
                    feats.append(linear_resample(f, T).float())
                batch["hubert"] = torch.cat(feats)
            encoder_counts["windows"] += wave.shape[0]
            encoder_counts["chunks"] += len(feats)
        return batch

    return frontend
