"""The serving pipeline: waveforms -> mel -> HuBERT -> windowed sampler.

Counterpart of ``diffsheg_tpu/sampling/pipeline.py::FusedPipeline`` (which
traces the three stages into one XLA program): the same stages in the same
order, one call per clip.
"""

from __future__ import annotations

from typing import Optional

import torch

from diffsheg_tpu_torch.diffusion.sampler import NoiseSource
from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator
from diffsheg_tpu_torch.utils.profiling import span


class FusedPipeline:
    """Waveforms in, motion out.

    Args:
      streamer: the window-level generator to drive.
      mel_frontend: audio.mel.MelFrontend.
      hubert_extractor: audio.hubert_runner.HubertFeatureExtractor or None.
    """

    def __init__(self, streamer: StreamingGenerator, mel_frontend,
                 hubert_extractor=None):
        self.stream = streamer
        self.frontend = mel_frontend
        self.hubert = hubert_extractor

    @torch.no_grad()
    def __call__(self, audio_mel, audio_16k: Optional[torch.Tensor],
                 person_id: torch.Tensor, noise: NoiseSource) -> torch.Tensor:
        """audio_mel (1, N) at the mel rate; audio_16k (1, N16) or None;
        person_id (B, style_dim).  Returns (B, T, C) float32, C the
        model's ``denoised_channels``.  Every span of the call nests in
        its ``pipeline`` span."""
        with span("pipeline"):
            mel = self.frontend(audio_mel)
            T = mel.shape[1]
            hub = (self.hubert(audio_16k, target_frames=T)
                   if self.hubert is not None and audio_16k is not None
                   else None)
            B = person_id.shape[0]
            if B > 1:   # one audio, a batch of speaker styles
                mel = mel.expand(B, *mel.shape[1:])
                if hub is not None:
                    hub = hub.expand(B, *hub.shape[1:])
            return self.stream.generate_fused(mel, person_id, noise, hub)
