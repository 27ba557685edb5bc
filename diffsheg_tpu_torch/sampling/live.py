"""Live streaming speech-to-motion session.

Counterpart of ``diffsheg_tpu/sampling/live.py``.  The model is causal at
window granularity — each window depends only on its own audio span and
the previous window's tail via RePaint — so generation runs while audio
arrives: push waveform chunks as they are captured, get motion frames as
windows complete.

- mel: each window's frames come from a fixed-length segment of the
  head-padded waveform through ``stft_magsq(center=False)`` — frame t of
  a centred STFT reads exactly ``padded[t*hop : t*hop + n_fft]`` — so a
  window's mel equals the offline frontend's away from the sequence end;
- HuBERT: window-local context (the window's own span, padded to one
  chunk and masked, as the offline chunker pads a remainder), or with
  ``hubert_ctx_s > 0`` that many seconds of already-captured audio
  prepended and the window's frames sliced back out through the frame
  mask (``HubertFeatureExtractor.encode_left_context``);
- sampler: the window programs of the offline host loop
  (``StreamingGenerator.generate``): plain first window, RePaint
  continuation windows.  Window ``k`` the session runs (``finish``'s
  windows included) draws window ``k`` of its ``NoiseSource``; a session
  too short for one window draws window 0.

``finish()`` drains the tail with the left-shifted final window
(``streamer.window_starts``), taking the end-padding-dependent frames
from the offline (centred) mel.  ``push`` and ``finish`` return motion as
float32 CPU tensors (B, frames, C).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import numpy as np
import torch

from diffsheg_tpu_torch.audio.hubert_runner import STRIDE, expected_frames
from diffsheg_tpu_torch.audio.mel import hann_window, mel_filterbank, stft_magsq
from diffsheg_tpu_torch.device import DeviceLike, resolve_device
from diffsheg_tpu_torch.diffusion.sampler import NoiseSource
from diffsheg_tpu_torch.models.factory import denoised_channels
from diffsheg_tpu_torch.sampling.generator import WindowGenerator
from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator

N_FFT = 2048


@functools.lru_cache(maxsize=8)
def _mel_constants(sr: int, n_fft: int, n_mels: int, device: torch.device):
    """(window, (F, n_mels) filterbank) on ``device``, shared by every
    session with the same geometry."""
    return (torch.as_tensor(hann_window(n_fft), device=device),
            torch.as_tensor(mel_filterbank(sr, n_fft, n_mels).T,
                            device=device))


class LiveSession:
    """One incremental generation session (one audio stream, B styles).

    Args:
      gen: the window generator (owns model, schedule, config, device).
      person_id: (B, style_dim) speaker one-hot(s).
      noise: the session's noise; with the offline streamer's source a
        fully pushed session reproduces offline sampling.
      hubert_extractor: optional ``HubertFeatureExtractor`` on the
        generator's device.
      retain: keep the whole stream (``finish`` returns the whole
        session); False bounds memory — consumed audio is trimmed, motion
        is returned once by ``push`` and ``finish`` returns only the tail.
      hubert_ctx_s: seconds of left context for each window's HuBERT
        encode (0: window-local).
    """

    @classmethod
    def create(cls, cfg, model, person_id: torch.Tensor, noise: NoiseSource,
               window_frames: int = 0, overlap: int = 0,
               hubert_extractor=None, gen_cache: Optional[dict] = None,
               retain: bool = True, hubert_ctx_s: float = 0.0,
               device: DeviceLike = None) -> "LiveSession":
        """Build a session for ``model`` (any model of
        ``models/factory.py::build_denoiser``),
        optionally at a reduced window (``window_frames``; the denoiser is
        window-length-agnostic, and the live lookahead is one window:
        2.27 s at 34 frames, 0.8 s at 12).  ``overlap`` overrides the
        RePaint overlap (default: the config's, capped at
        window_frames // 2).  ``gen_cache``, a dict the caller owns,
        shares one :class:`WindowGenerator` (its weights cast and moved
        once, its fast-path weights built once per window length) across
        sessions keyed by (window, overlap).  Runs on ``device``
        (default: the GPU)."""
        dev = resolve_device(device)
        if window_frames < 0 or overlap < 0:
            raise ValueError(
                f"window_frames={window_frames}, overlap={overlap}: "
                "both must be >= 0 (0 = keep the config's value)")
        if window_frames:
            ov = overlap or min(cfg.stream.overlap_len, window_frames // 2)
            if ov >= window_frames:
                raise ValueError(
                    f"overlap={ov} >= window_frames={window_frames}: the "
                    "window step (window - overlap) must be >= 1 or the "
                    "session can never advance")
            cfg = cfg.replace(
                data=dataclasses.replace(cfg.data, n_poses=window_frames),
                stream=dataclasses.replace(cfg.stream, overlap_len=ov))
        elif overlap:
            if overlap >= cfg.data.n_poses:
                raise ValueError(
                    f"overlap={overlap} >= window size {cfg.data.n_poses}: "
                    "the window step (window - overlap) must be >= 1")
            cfg = cfg.replace(
                stream=dataclasses.replace(cfg.stream, overlap_len=overlap))
        key = (cfg.data.n_poses, cfg.stream.overlap_len)
        if gen_cache is not None and key in gen_cache:
            gen = gen_cache[key]
        else:
            gen = WindowGenerator(cfg, model, device=dev)
            if gen_cache is not None:
                gen_cache[key] = gen
        return cls(gen, person_id, noise, hubert_extractor=hubert_extractor,
                   retain=retain, hubert_ctx_s=hubert_ctx_s)

    def __init__(self, gen: WindowGenerator, person_id: torch.Tensor,
                 noise: NoiseSource, hubert_extractor=None,
                 retain: bool = True, hubert_ctx_s: float = 0.0):
        cfg = gen.cfg
        self.gen, self.cfg = gen, cfg
        self.device = gen.device
        self.pid = torch.as_tensor(person_id, dtype=torch.float32,
                                   device=self.device)
        self.noise = noise
        self.hubert_fe = hubert_extractor

        d = cfg.data
        self.size = d.n_poses
        self.overlap = cfg.stream.overlap_len
        self.step = self.size - self.overlap
        self.sr, self.hop, self.fps = d.mel_sr, d.mel_hop, d.fps
        self.n_fft = N_FFT
        self.channels = denoised_channels(cfg.model)

        self.retain = retain
        self._audio = np.zeros(0, dtype=np.float32)      # mel-rate samples
        self._audio16 = np.zeros(0, dtype=np.float32)    # 16 kHz samples
        self._base = 0        # mel-rate samples trimmed (hop-aligned)
        self._base16 = 0      # 16 kHz samples trimmed
        self._chunks: List[torch.Tensor] = []            # emitted motion
        self._emitted = 0                                # frames emitted
        self._next_start = 0                             # next window start
        self._last_start = 0
        self._windows = 0                                # windows run
        self._prev_out: Optional[torch.Tensor] = None
        self._prev_tails = None                          # same_overlap_noisy
        self._finished = False

        self._window, self._filters = _mel_constants(self.sr, self.n_fft,
                                                     d.n_mels, self.device)
        self._seg_len = (self.size - 1) * self.hop + self.n_fft

        # left-context HuBERT: the context rounded down to whole encoder
        # strides, so a fully padded young stream's first kept frame is
        # not a masked one
        self._hub_ctx = int(round(hubert_ctx_s * 16000))
        if self.hubert_fe is not None and self._hub_ctx > 0:
            self._hub_ctx = (self._hub_ctx // STRIDE) * STRIDE
            self._hub_n_win = int(self.size / self.fps * 16000)
            self._hub_ext_len = self._hub_ctx + self._hub_n_win

    # -- audio bookkeeping -------------------------------------------------
    @property
    def duration(self) -> float:
        """Seconds of mel-rate audio pushed so far."""
        return (self._base + len(self._audio)) / self.sr

    @property
    def buffered_seconds(self) -> float:
        """Seconds of audio currently held: the unconsumed backlog (about
        two windows while windows run; it grows when they stall)."""
        return max(len(self._audio) / self.sr, len(self._audio16) / 16000.0)

    def _trim(self) -> None:
        """retain=False: drop audio no future window reads, hop-aligned so
        the retained stream's centred frames stay on the offline grid."""
        if self.retain:
            return
        pad = self.n_fft // 2
        keep = max(0, (self._next_start - self.step) * self.hop - pad)
        keep = (keep // self.hop) * self.hop
        if keep > self._base:
            self._audio = self._audio[keep - self._base:]
            self._base = keep
        if self.hubert_fe is not None:
            keep16 = int((self._next_start - self.step) / self.fps * 16000)
            keep16 = max(0, keep16 - self._hub_ctx)
            if keep16 > self._base16:
                self._audio16 = self._audio16[keep16 - self._base16:]
                self._base16 = keep16

    def _window_ready(self, s: int) -> bool:
        """Window [s, s+size) runs only when (a) the offline frame plan
        (T = n // hop) contains it, (b) its last frame's analysis span is
        captured and (c) with HuBERT, the 16 kHz stream covers its span."""
        end = s + self.size
        n = self._base + len(self._audio)
        if n // self.hop < end:
            return False
        if n < (end - 1) * self.hop + self.n_fft // 2:
            return False
        if self.hubert_fe is not None:
            n16 = self._base16 + len(self._audio16)
            if n16 < int(np.ceil(end / self.fps * 16000)):
                return False
        return True

    def _mel_of(self, y: np.ndarray, center: bool) -> torch.Tensor:
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)[None]
        return stft_magsq(y, self.n_fft, self.hop, self._window,
                          center=center) @ self._filters

    def _window_mel(self, s: int) -> torch.Tensor:
        pad = self.n_fft // 2
        lo = s * self.hop - pad                   # stream sample index
        if lo < 0:
            # head reflect, as librosa pads (only reached untrimmed)
            head = self._audio[1:pad + 1][::-1]
            seg = np.concatenate([head[lo:], self._audio[:lo + self._seg_len]])
        else:
            seg = self._audio[lo - self._base:lo - self._base + self._seg_len]
        if len(seg) != self._seg_len:
            raise RuntimeError(f"window segment of {len(seg)} samples, "
                               f"expected {self._seg_len}")
        return self._mel_of(seg, center=False)     # (1, size, n_mels)

    def _window_hubert(self, s: int) -> Optional[torch.Tensor]:
        if self.hubert_fe is None:
            return None
        n = int(self.size / self.fps * 16000)
        n16 = self._base16 + len(self._audio16)
        lo = min(int(s / self.fps * 16000), max(0, n16 - n))
        lo = max(lo, self._base16)
        if self._hub_ctx > 0:
            lo_ext = lo - self._hub_ctx
            avail = max(lo_ext, self._base16)
            pad_left = avail - lo_ext
            seg = self._audio16[avail - self._base16:lo + n - self._base16]
            seg = np.pad(seg, (pad_left,
                               self._hub_ext_len - pad_left - len(seg)))
            return self.hubert_fe.encode_left_context(
                seg, pad_left, self._hub_ctx // STRIDE, expected_frames(n),
                self.size)
        seg = self._audio16[lo - self._base16:lo - self._base16 + n]
        if len(seg) < n:
            seg = np.pad(seg, (0, n - len(seg)))
        return self.hubert_fe(seg[None], target_frames=self.size)

    def _offline_mel(self):
        """The centred, drop_last mel of the retained stream and the frame
        its first row is in the full stream (``_base`` is hop-aligned)."""
        return (self._mel_of(self._audio, center=True)[:, :-1],
                self._base // self.hop)

    # -- window machinery --------------------------------------------------
    def _run_window(self, s: int, mel_w: torch.Tensor, hub_w) -> torch.Tensor:
        B = self.pid.shape[0]
        mel_b = mel_w.expand(B, *mel_w.shape[1:])
        hub_b = None if hub_w is None else hub_w.expand(B, *hub_w.shape[1:])
        gt_head = None
        if self._prev_out is not None:
            tail_from = s - self._last_start
            gt_head = self._prev_out[:, tail_from:tail_from + self.overlap]
        out = self.gen.generate(mel_b, self.pid, self.noise, hub_b,
                                gt_head=gt_head,
                                prev_saved_tails=self._prev_tails,
                                window=self._windows)
        self._windows += 1
        if isinstance(out, tuple):      # same_overlap_noisy: carry tails
            out, self._prev_tails = out
        self._last_start, self._prev_out = s, out
        return out

    def _empty(self) -> torch.Tensor:
        return torch.zeros((self.pid.shape[0], 0, self.channels))

    @torch.no_grad()
    def push(self, samples, samples_16k=None) -> torch.Tensor:
        """Append captured audio (mel-rate, and the 16 kHz stream when the
        session has a HuBERT extractor) and run every window that became
        ready; returns the motion frames they emit, (B, new_T, C)."""
        if self._finished:
            raise RuntimeError("session already finished")
        self._audio = np.concatenate(
            [self._audio, np.asarray(samples, dtype=np.float32).ravel()])
        if samples_16k is not None and self.hubert_fe is not None:
            # without an extractor the 16 kHz stream is never read
            self._audio16 = np.concatenate(
                [self._audio16,
                 np.asarray(samples_16k, dtype=np.float32).ravel()])
        emitted = []
        while self._window_ready(self._next_start):
            s = self._next_start
            out = self._run_window(s, self._window_mel(s),
                                   self._window_hubert(s))
            emitted.append(out[:, :self.step])
            self._emitted += self.step
            self._next_start = s + self.step
        if not emitted:
            return self._empty()
        out = torch.cat(emitted, dim=1).float().cpu()
        if self.retain:
            self._chunks.append(out)
        else:
            self._trim()
        return out

    @torch.no_grad()
    def finish(self) -> torch.Tensor:
        """Drain the tail.  Returns the whole session's motion (B, T, C)
        when ``retain``, else only the frames drained here."""
        if self._finished:
            raise RuntimeError("session already finished")
        self._finished = True
        T = (self._base + len(self._audio)) // self.hop  # offline frames
        tail: List[torch.Tensor] = []
        if self._prev_out is not None:
            # windows the live gates stalled (behind the 16 kHz stream or
            # the analysis-span gate) while mel frames accumulated: the
            # offline plan runs every window whose span lies in T
            mel = off = None
            while T >= self._next_start + self.size:
                if mel is None:
                    mel, off = self._offline_mel()
                s = self._next_start
                out = self._run_window(
                    s, mel[:, s - off:s - off + self.size],
                    self._window_hubert(s))
                tail.append(out[:, :self.step])
                self._emitted += self.step
                self._next_start = s + self.step
        done = self._emitted
        if T > done:
            if self._prev_out is None:
                # never emitted: the offline short-clip semantics
                # (pad-and-trim), from window 0 of the noise
                mel_full, _ = self._offline_mel()
                B = self.pid.shape[0]
                hub_b = None
                if self.hubert_fe is not None:
                    hub = self.hubert_fe(self._audio16[None], target_frames=T)
                    hub_b = hub.expand(B, *hub.shape[1:])
                out = StreamingGenerator(self.gen).generate(
                    mel_full.expand(B, *mel_full.shape[1:]), self.pid,
                    self.noise, hub_b)
                tail.append(out[:, :T])
            elif T <= self._last_start + self.size:
                # the last sampled window covers through T
                tail.append(self._prev_out[:, self.step:self.step + T - done])
            else:
                s = T - self.size                 # left-shifted final window
                mel, off = self._offline_mel()
                out = self._run_window(s, mel[:, s - off:s - off + self.size],
                                       self._window_hubert(s))
                tail.append(out[:, done - s:])
        tail = [t.float().cpu() for t in tail]
        if self.retain:
            tail = self._chunks + tail
        return torch.cat(tail, dim=1) if tail else self._empty()
