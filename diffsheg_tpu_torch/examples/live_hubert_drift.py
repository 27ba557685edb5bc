"""Quantify the live-mode HuBERT approximation.

Counterpart of ``examples/live_hubert_drift.py``.  Live sessions extract
HuBERT features with WINDOW-LOCAL context: per 34-frame window, the
window's own ~2.27 s of 16 kHz audio is normalized and encoded on its
own.  The offline path (``audio/hubert_runner.py``) normalizes the WHOLE
stream, attends over 20 s chunks and resamples whole-stream features to
the motion rate before windowing.  Three divergence sources:
normalization statistics, attention context truncation, and per-window
against whole-stream resampling.

This script measures the per-window feature drift (relative RMS against
the offline features) for:
  (a) the window-local live path, and
  (b) a LEFT-CONTEXT variant that prepends the previous ``ctx_s`` seconds
      of captured audio, encodes, and keeps the window's frames — the
      live session's ``hubert_ctx_s`` knob, through the same
      ``HubertFeatureExtractor.encode_left_context``.

The encoder is HuBERT-large with seeded random weights unless
``--hubert-checkpoint`` names a local HF checkpoint: with random weights
the number indicates architectural sensitivity, not perceptual quality.
The audio is ``--wav`` (any rate, resampled to 16 kHz) or, by default,
seeded speech-like audio (a gliding voiced tone with syllable-rate
amplitude and noise) of ``--seconds``.  It reaches no kernel: HuBERT is
plain PyTorch.

Run:  python -m diffsheg_tpu_torch.examples.live_hubert_drift
      [--seconds 24] [--ctx 1,2,4] [--wav FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from diffsheg_tpu_torch.audio.hubert_runner import (STRIDE,
                                                    HubertFeatureExtractor,
                                                    expected_frames)
from diffsheg_tpu_torch.examples import add_device_arg, script_device


def speech_like(secs: float, sr: int = 16000, seed: int = 0) -> np.ndarray:
    """Seeded speech-like audio: a voiced tone gliding 120-220 Hz with its
    first harmonics, amplitude-modulated at syllable rate, plus noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(secs * sr)) / sr
    f0 = 170 + 50 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase) / k for k in (1, 2, 3, 4))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * t + rng.uniform(0, 6.28))
    return (0.2 * env * voiced
            + 0.02 * rng.randn(len(t))).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=24.0)
    ap.add_argument("--ctx", default="4.0",
                    help="left context seconds for variant (b); "
                         "comma-separated values sweep the table")
    ap.add_argument("--wav", default=None)
    ap.add_argument("--hubert-checkpoint", default=None)
    ap.add_argument("--fps", type=int, default=15)
    ap.add_argument("--window", type=int, default=34)
    ap.add_argument("--step", type=int, default=30)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = script_device(args.device)

    if args.wav:
        from diffsheg_tpu_torch.audio.wav import load_wav, resample_poly
        y, sr = load_wav(args.wav)
        audio = resample_poly(y, sr, 16000)[: int(args.seconds * 16000)]
    else:
        audio = speech_like(args.seconds)
    audio = np.asarray(audio, np.float32)
    T_total = int(len(audio) / 16000 * args.fps)

    model = None
    if args.hubert_checkpoint:
        from diffsheg_tpu_torch.compat.hubert_ckpt import load_hf_hubert
        model = load_hf_hubert(args.hubert_checkpoint)
    ex = HubertFeatureExtractor(model=model, device=device)

    # offline oracle: whole-stream chunked extraction at the motion rate
    offline = ex(audio, target_frames=T_total)[0].float().cpu().numpy()

    # window starts (streamer semantics: fixed step, left-shifted tail)
    starts = list(range(0, T_total - args.window + 1, args.step))
    if starts[-1] != T_total - args.window:
        starts.append(T_total - args.window)

    n = int(args.window / args.fps * 16000)
    ctx_sweep = [float(c) for c in str(args.ctx).split(",") if c.strip()]

    def rel_rms(a, b):
        return float(np.sqrt(((a - b) ** 2).mean())
                     / max(np.sqrt((b ** 2).mean()), 1e-12))

    # (a) live path: window-local context, shared across the sweep
    rows_local = []
    for s in starts:
        lo = min(int(s / args.fps * 16000), max(0, len(audio) - n))
        seg = audio[lo:lo + n]
        if len(seg) < n:
            seg = np.pad(seg, (0, n - len(seg)))
        live = ex(seg[None], target_frames=args.window)[0]
        rows_local.append(rel_rms(live.float().cpu().numpy(),
                                  offline[s:s + args.window]))

    result = {
        "metric": "live_hubert_feature_drift",
        "unit": "rel_rms_vs_offline",
        "windows": len(starts),
        "weights": "converted" if model is not None else "random-init",
        "window_local_mean": round(float(np.mean(rows_local)), 4),
        "window_local_max": round(float(np.max(rows_local)), 4),
    }

    for ctx_s in ctx_sweep:
        # a whole number of encoder strides, as LiveSession rounds it
        ctx = (int(ctx_s * 16000) // STRIDE) * STRIDE
        want = expected_frames(n)
        rows_ctx = []
        for s in starts:
            lo = min(int(s / args.fps * 16000), max(0, len(audio) - n))
            # (b) left context: encode [lo - ctx, lo + n), zero-padded on
            # the left while the stream is younger than ctx, and keep the
            # window's frames
            lo_ext = lo - ctx
            pad_left = max(0, -lo_ext)
            ext = audio[max(0, lo_ext):lo + n]
            ext = np.pad(ext, (pad_left, ctx + n - pad_left - len(ext)))
            feats = ex.encode_left_context(ext, pad_left, ctx // STRIDE,
                                           want, args.window)[0]
            rows_ctx.append(rel_rms(feats.float().cpu().numpy(),
                                    offline[s:s + args.window]))
        tag = f"{ctx_s:g}"
        result[f"left_ctx_{tag}s_mean"] = round(float(np.mean(rows_ctx)), 4)
        result[f"left_ctx_{tag}s_max"] = round(float(np.max(rows_ctx)), 4)
        print(f"ctx={ctx_s:g}s: mean={result[f'left_ctx_{tag}s_mean']} "
              f"max={result[f'left_ctx_{tag}s_max']}", file=sys.stderr)

    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
