"""Custom-audio generation: a wav to motion, BVH and face JSON.

Counterpart of ``diffsheg_tpu/cli/generate.py``, the reference's
``test_custom_aud`` (reference trainers/ddpm_beat_trainer.py:1123-1346):

  wav -> [host] load + resample (18 kHz mel, 16 kHz HuBERT)
      -> [device] mel frontend + HuBERT features
      -> [device] windowed DDIM + RePaint sampling, every speaker style in
         one batch
      -> [device] axis-angle -> euler degrees; [host] de-normalize, BVH
         template rewrite, face JSON (``sampling/export.py``)

``stream.single_dispatch`` (the default) runs mel, HuBERT and the sampler
as one ``FusedPipeline`` call; ``False`` runs them as stages, each timed,
the reference's per-stage RTF breakdown (frames / (t_mel + t_hubert +
t_sampler), :1315).  Everything runs on the card unless the caller asks
for the CPU.  Noise comes from a ``NoiseSource``: by default a
``GeneratorNoise`` seeded with ``seed`` on the pipeline's device.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from diffsheg_tpu_torch.config import Config
from diffsheg_tpu_torch.device import DeviceLike, resolve_device
from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise, NoiseSource
from diffsheg_tpu_torch.utils.profiling import StageTimer, block_until_ready


@dataclasses.dataclass
class GenerationResult:
    motion: np.ndarray            # (B, T, motion_dim) normalized model output
    fps: float                    # generated frames per wall-second
    rtf: float                    # real-time factor
    stages: Dict[str, float]      # per-stage seconds


class CustomAudioPipeline:
    """Owns the frontend, the generator and the exporter for one model.

    Args:
      cfg: the resolved configuration.
      model: a denoiser of ``models/factory.py::build_denoiser``.
      hubert_model: a ``models.hubert.HubertModel`` (e.g. from
        ``compat/hubert_ckpt.py::load_hf_hubert``); without it a model
        with ``add_hubert`` gets a seeded random encoder of
        ``hubert_config``'s layout (default HuBERT-large).
      hubert_config: the speech encoder's ``HubertConfig`` (e.g.
        ``models/hubert.py::wavlm_large_config()``).
      motion_mean, motion_std: dataset statistics for the export.
      device: where everything runs (default: the GPU; raises without
        one).
    """

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 hubert_model=None, hubert_config=None,
                 motion_mean: Optional[np.ndarray] = None,
                 motion_std: Optional[np.ndarray] = None,
                 device: DeviceLike = None):
        from diffsheg_tpu_torch.audio.mel import MelFrontend
        from diffsheg_tpu_torch.sampling.generator import WindowGenerator
        from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator

        self.cfg = cfg
        self.device = resolve_device(device)
        self.mel_frontend = MelFrontend(
            sr=cfg.data.mel_sr, hop=cfg.data.mel_hop, n_mels=cfg.data.n_mels,
            drop_last=True, device=self.device)
        self.generator = WindowGenerator(cfg, model, device=self.device)
        self.streamer = StreamingGenerator(self.generator)
        self.motion_mean = motion_mean
        self.motion_std = motion_std
        self._pipe = None       # FusedPipeline, built on first use
        self._exporter = None   # BeatMotionExporter, kept across clips
        self.hubert_extractor = None
        if cfg.model.add_hubert:
            from diffsheg_tpu_torch.audio.hubert_runner import (
                HubertFeatureExtractor)
            if hubert_model is None:
                print(
                    "WARNING: model.add_hubert is on but no HuBERT weights "
                    "were given — speech features come from a RANDOM-INIT "
                    "encoder. Pass hubert_model (see "
                    "compat.hubert_ckpt.load_hf_hubert) or set "
                    "model.add_hubert=false.", file=sys.stderr)
            self.hubert_extractor = HubertFeatureExtractor(
                hubert_config, model=hubert_model, device=self.device)

    # -- stages ------------------------------------------------------------
    def _load_audio(self, wav_path: str):
        """Host-side load + resample: (mel-rate waveform, 16 kHz waveform
        or None) on the pipeline's device.  The one place both paths take
        their audio from."""
        from diffsheg_tpu_torch.audio.wav import load_wav, resample_poly

        y, sr = load_wav(wav_path)
        y_mel = torch.from_numpy(
            resample_poly(y, sr, self.cfg.data.mel_sr)).to(self.device)
        y16 = (torch.from_numpy(resample_poly(y, sr, 16000)).to(self.device)
               if self.hubert_extractor is not None else None)
        return y_mel, y16

    def prepare_audio(self, wav_path: str, timer: StageTimer):
        """Load + resample on the host, mel + HuBERT on the device, each
        a timed stage."""
        y_mel, y16 = self._load_audio(wav_path)
        with timer.stage("mel"):
            mel = self.mel_frontend(y_mel[None])        # (1, T, M)
            block_until_ready(mel)
        T = mel.shape[1]
        hubert = None
        if y16 is not None:
            with timer.stage("hubert"):
                hubert = self.hubert_extractor(y16, target_frames=T)
                block_until_ready(hubert)
        return mel, hubert

    def _sample(self, mel_b, pid, noise, hub_b):
        if self.cfg.stream.same_overlap_noisy:
            return self.streamer.generate(mel_b, pid, noise, hub_b)
        return self.streamer.generate_fused(mel_b, pid, noise, hub_b)

    @torch.no_grad()
    def generate(self, wav_path: str, speaker_ids: Sequence[int],
                 seed: int = 0,
                 noise: Optional[NoiseSource] = None) -> GenerationResult:
        """Generate every requested speaker style in one batch.  ``noise``
        defaults to ``GeneratorNoise(seed, device)``."""
        timer = StageTimer()
        if noise is None:
            noise = GeneratorNoise(seed, self.device)
        pid = torch.nn.functional.one_hot(
            torch.as_tensor(list(speaker_ids)),
            self.cfg.model.style_dim).float().to(self.device)
        if self.cfg.stream.single_dispatch \
                and not self.cfg.stream.same_overlap_noisy:
            y_mel, y16 = self._load_audio(wav_path)
            if self._pipe is None:
                from diffsheg_tpu_torch.sampling.pipeline import FusedPipeline
                self._pipe = FusedPipeline(self.streamer, self.mel_frontend,
                                           self.hubert_extractor)
            with timer.stage("pipeline"):
                out = self._pipe(y_mel[None],
                                 None if y16 is None else y16[None],
                                 pid, noise)
                block_until_ready(out)
        else:
            mel, hubert = self.prepare_audio(wav_path, timer)
            B = len(speaker_ids)
            mel_b = mel.expand(B, *mel.shape[1:])
            hub_b = (None if hubert is None
                     else hubert.expand(B, *hubert.shape[1:]))
            with timer.stage("sampler"):
                out = self._sample(mel_b, pid, noise, hub_b)
                block_until_ready(out)
        T = out.shape[1]
        return GenerationResult(
            motion=out.float().cpu().numpy(),
            fps=timer.fps(T),
            rtf=timer.rtf(T, self.cfg.data.fps),
            stages=timer.report(),
        )

    def warmup(self, seconds: float, num_speakers: int = 1,
               sr: int = 16000) -> None:
        """One :meth:`generate` on synthetic audio of the target length,
        so the timings of the next call are steady-state (the kernels
        built and loaded, the fast-path weights made, the allocator
        warm)."""
        import tempfile
        import wave as wave_mod
        t = np.arange(int(seconds * sr)) / sr
        sig = (0.1 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            with wave_mod.open(f.name, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sr)
                w.writeframes((sig * 32767).astype("<i2").tobytes())
            self.generate(f.name, list(range(num_speakers)), seed=0)

    # -- postprocess / export ---------------------------------------------
    def export_beat(self, motion: np.ndarray, out_dir: str, name: str,
                    template_bvh: Optional[str] = None,
                    player: bool = False) -> List[str]:
        """De-normalize, convert to euler degrees, write BVH + face JSON
        (reference ddpm_beat_trainer.py:1322-1341); ``player`` adds the
        self-contained HTML viewer per clip."""
        from diffsheg_tpu_torch.sampling.export import BeatMotionExporter

        assert self.motion_mean is not None, "need dataset stats for export"
        if self._exporter is None or \
                self._exporter.template_bvh != template_bvh or \
                self._exporter.player != player:
            self._exporter = BeatMotionExporter(
                self.cfg.model.pose_dim, self.cfg.data.fps,
                self.motion_mean, self.motion_std, template_bvh,
                player=player, device=self.device)
        exporter = self._exporter
        written: List[str] = []
        for b in range(motion.shape[0]):
            written += exporter.export(motion[b], out_dir, f"{name}_{b}")
        return written

    def export_show(self, motion: np.ndarray, out_dir: str, name: str,
                    stats=None) -> List[str]:
        """SHOW export: inv-standardize and save npy (reference
        ddpm_show_trainer.py:913-935; visualization is external)."""
        os.makedirs(out_dir, exist_ok=True)
        written = []
        for b in range(motion.shape[0]):
            out = motion[b]
            if stats is not None:
                from diffsheg_tpu_torch.data.show import inv_standardize
                out = inv_standardize(out, stats.motion_mean, stats.motion_std)
            p = os.path.join(out_dir, f"{name}_{b}.npy")
            np.save(p, out)
            written.append(p)
        return written
