"""Arbitrary-length generation via windowed outpainting.

Counterpart of ``diffsheg_tpu/sampling/streamer.py``: slice the
conditioning into ``n_poses``-frame windows advancing by ``n_poses -
overlap_len``; pin each continuation window's first ``overlap_len`` frames
toward the previous window's output with RePaint; the final window is
shifted left to end at the sequence end, and only its new frames are
emitted.  Two modes, as in JAX:

- :meth:`StreamingGenerator.generate`, the host window loop (one
  ``WindowGenerator.generate`` a window, the program a live session
  walks);
- :meth:`StreamingGenerator.generate_fused`, which computes what the JAX
  ``generate_fused`` computes — where they apply, the fast-path weights
  and the static cache once per stream and the audio cache for all
  windows in one batch; the same per-window noise order — with a Python
  loop over windows in place of ``lax.scan``.

Both take ``stream.fix_very_first`` (window 0 pinned toward zeros) and
``stream.same_overlap_noisy`` (saved noisy tails carried between windows).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch.nn import functional as F

from diffsheg_tpu_torch.diffusion.sampler import NoiseSource
from diffsheg_tpu_torch.models.factory import denoised_channels
from diffsheg_tpu_torch.models.level_cache import AudioCache, combine
from diffsheg_tpu_torch.sampling.generator import WindowGenerator
from diffsheg_tpu_torch.utils.profiling import span


def get_windows(x: np.ndarray, size: int, step: int) -> List[np.ndarray]:
    """Reference-compatible window slicing over axis 1 (windows every
    ``step`` frames, a shorter last window where frames remain), for
    dataset tooling and parity tests; the streamer uses
    :func:`window_starts`."""
    seq_len = x.shape[1]
    if seq_len <= size:
        return [x]
    win_num = (seq_len - (size - step)) / float(step)
    out = [x[:, m * step: m * step + size] for m in range(int(win_num))]
    if win_num != int(win_num):
        out.append(x[:, int(win_num) * step:])
    return out


def window_starts(seq_len: int, size: int, step: int) -> List[int]:
    """Full windows every ``step`` frames, plus a final left-shifted
    window ending at ``seq_len`` when frames remain."""
    if seq_len <= size:
        return [0]
    starts = []
    s = 0
    while s + size <= seq_len:
        starts.append(s)
        s += step
    if starts[-1] + size < seq_len:
        starts.append(seq_len - size)
    return starts


class StreamingGenerator:
    """Drives a :class:`WindowGenerator` over arbitrary-length
    conditioning.  Window ``k`` draws its noise as window ``k`` of the
    noise source."""

    def __init__(self, gen: WindowGenerator):
        self.gen = gen
        self.cfg = gen.cfg

    @torch.no_grad()
    def generate(self, mel, person_id, noise: NoiseSource,
                 hubert=None) -> torch.Tensor:
        """The host window loop: mel (B, T, n_mels), person_id (B, style),
        hubert (B, T, H) -> (B, T, C) float32, C the model's
        ``denoised_channels``."""
        with span("sampler"):
            cfg, gen = self.cfg, self.gen
            size = cfg.data.n_poses
            overlap = cfg.stream.overlap_len
            step = size - overlap
            B, T = mel.shape[0], mel.shape[1]
            if T <= size:
                return self._short_sequence(mel, person_id, noise, hubert, T)

            starts = window_starts(T, size, step)
            chunks: List[torch.Tensor] = []
            emitted = 0
            gt_head = None
            prev_tails = None
            for k, s in enumerate(starts):
                mel_w = mel[:, s:s + size]
                hub_w = None if hubert is None else hubert[:, s:s + size]
                if k == 0 and cfg.stream.fix_very_first and overlap > 0:
                    gt_head = torch.zeros(
                        (B, overlap, denoised_channels(cfg.model)))
                out = gen.generate(mel_w, person_id, noise, hub_w,
                                   gt_head=gt_head,
                                   prev_saved_tails=prev_tails, window=k)
                if isinstance(out, tuple):      # same_overlap_noisy
                    out, prev_tails = out
                is_last = k == len(starts) - 1
                keep_to = size if is_last else step
                chunks.append(out[:, emitted - s:keep_to])
                emitted = s + keep_to
                if not is_last:
                    # the next window's head matches frames
                    # [next, next + overlap)
                    tail_from = starts[k + 1] - s
                    gt_head = out[:, tail_from:tail_from + overlap]
            return torch.cat(chunks, dim=1)

    @torch.no_grad()
    def generate_fused(self, mel, person_id, noise: NoiseSource,
                       hubert=None) -> torch.Tensor:
        """mel (B, T, n_mels), person_id (B, style), hubert (B, T, H) ->
        (B, T, C) float32, C the model's ``denoised_channels``."""
        with span("sampler"):
            cfg, gen = self.cfg, self.gen
            dev = gen.device
            mel = mel.to(dev)
            person_id = person_id.to(dev)
            hubert = None if hubert is None else hubert.to(dev)
            size = cfg.data.n_poses
            overlap = cfg.stream.overlap_len
            step = size - overlap
            B, T = mel.shape[0], mel.shape[1]
            if T <= size:
                return self._short_sequence(mel, person_id, noise, hubert, T)

            starts = window_starts(T, size, step)
            K = len(starts)
            C = denoised_channels(cfg.model)
            track_tails = cfg.stream.same_overlap_noisy

            # the fast-path weights and the static cache once per stream, the
            # audio cache for all windows in one batch; each only where it
            # applies (None otherwise)
            fast = gen.make_fast(size)
            static = gen.cache_static(person_id)
            mel_all = torch.stack([mel[:, s:s + size] for s in starts])
            hub_all = (None if hubert is None else
                       torch.stack([hubert[:, s:s + size] for s in starts]))
            ac = gen.cache_audio(mel_all.reshape(K * B, size, -1),
                                 None if hub_all is None
                                 else hub_all.reshape(K * B, size, -1))
            if ac is not None:
                # unfold the window axis: (Lv, K*B, T, .) -> (K, Lv, B, T, .);
                # (K*B, T, .) -> (K, B, T, .)
                ac = AudioCache(
                    *(a.reshape(a.shape[0], K, B, *a.shape[2:]).transpose(0, 1)
                      for a in (ac.exp_audio, ac.ges_audio)),
                    *(None if a is None else a.reshape(K, B, *a.shape[1:])
                      for a in (ac.exp_hub, ac.ges_hub)))

            def cache_at(k):
                if ac is None:
                    return None
                return combine(static, AudioCache(
                    *(None if a is None else a[k] for a in ac)))

            def hub_w(k):
                return None if hub_all is None else hub_all[k]

            tails = None
            valid = False
            if cfg.stream.fix_very_first and overlap > 0:
                out, t0 = gen.sample_repaint(
                    mel_all[0], person_id, hub_w(0),
                    torch.zeros((B, size, C), device=dev), noise, 0,
                    cache=cache_at(0), fast=fast)
                if track_tails:
                    tails, valid = t0, True
            else:
                out = gen.sample_plain(mel_all[0], person_id, hub_w(0),
                                       noise, 0, cache=cache_at(0),
                                       fast=fast)

            res = torch.zeros((B, T, C), device=dev)
            res[:, :step] = out[:, :step]
            for k in range(1, K):
                tf = starts[k] - starts[k - 1]
                gt = torch.zeros((B, size, C), device=dev)
                gt[:, :overlap] = out[:, tf:tf + overlap]
                out, new_tails = gen.sample_repaint(
                    mel_all[k], person_id, hub_w(k), gt, noise, k,
                    prev_tails=tails if track_tails else None,
                    prev_tails_valid=valid if track_tails else None,
                    cache=cache_at(k), fast=fast)
                if track_tails:
                    tails, valid = new_tails, True
                if k < K - 1:
                    res[:, starts[k]:starts[k] + step] = out[:, :step]
                else:
                    new_from = starts[k - 1] + step - starts[k]
                    res[:, starts[k] + new_from:] = out[:, new_from:]
            return res

    def _short_sequence(self, mel, person_id, noise, hubert, T):
        """A sequence no longer than one window: edge-pad to the window
        size, sample, trim."""
        size = self.cfg.data.n_poses
        pad = size - T
        if pad:
            mel = F.pad(mel.transpose(1, 2), (0, pad), mode="replicate").transpose(1, 2)
            if hubert is not None:
                hubert = F.pad(hubert.transpose(1, 2), (0, pad),
                               mode="replicate").transpose(1, 2)
        out = self.gen.generate(mel, person_id, noise, hubert)
        return out[:, :T]
