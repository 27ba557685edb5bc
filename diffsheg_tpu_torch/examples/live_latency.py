"""Live-session latency/quality frontier.

Counterpart of ``examples/live_latency.py``.  A live session's added
latency is dominated by its *algorithmic lookahead*: a window of W frames
cannot be denoised until its whole audio span is captured, so a frame
emitted at window position p waits ``(W - p) / fps`` seconds plus the
per-window compute.  The default BEAT window (W=34 @ 15 fps) means a 2.3 s
worst-case lookahead; the denoiser is window-length-agnostic, so
``LiveSession.create(window_frames=...)`` trades lookahead for quality
(less audio context per window, more RePaint seams).

Per window size (BEAT at full width, bf16, no HuBERT, jump_n_sample 2:
the per-layer kernel at (1, W) on the card) it measures:
  - worst / mean algorithmic latency (audio arrival -> frame emission),
  - steady-state per-window compute (host wall of the pushes that
    completed a window, launches included),
  - real-time headroom (window audio span / compute),
  - quality drift against the full-window OFFLINE output on the same
    audio: relative RMS, and FGD between 34-frame slices embedded by a
    fixed random-init ``FgdFeatureNet`` (the no-corpus quality proxy).

Usage: python -m diffsheg_tpu_torch.examples.live_latency [--secs 40]
       [--sizes 34,24,16,12] [--device cpu]
Prints one JSON line per size; PERF.md has the table on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from diffsheg_tpu_torch.audio.mel import MelFrontend
from diffsheg_tpu_torch.config import beat_config
from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
from diffsheg_tpu_torch.eval.fgd_net import FgdNetConfig, init_fgd_net
from diffsheg_tpu_torch.eval.metrics import frechet_from_activations
from diffsheg_tpu_torch.examples import add_device_arg, script_device
from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
from diffsheg_tpu_torch.sampling.generator import WindowGenerator
from diffsheg_tpu_torch.sampling.live import LiveSession
from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator


def fgd_windows(x: np.ndarray, n_frames: int) -> np.ndarray:
    """Slice (1, T, C) motion into disjoint (N, n_frames, C) windows."""
    T = x.shape[1]
    n = T // n_frames
    return x[0, : n * n_frames].reshape(n, n_frames, x.shape[2])


def make_config():
    cfg = beat_config()
    return cfg.replace(
        diffusion=dataclasses.replace(
            cfg.diffusion, jump_n_sample=2,
            # live sessions keep the per-layer kernel ('auto')
            fused_layer=os.environ.get("BENCH_FUSED_LAYER", "auto"),
            quantize=os.environ.get("BENCH_QUANT", "none")),
        model=dataclasses.replace(cfg.model, compute_dtype="bfloat16",
                                  add_hubert=False),
    )


def live_audio(secs: int, sr: int) -> np.ndarray:
    """A gliding tone (200 Hz +- 30) plus seeded noise."""
    t = np.arange(secs * sr) / sr
    return (0.3 * np.sin(2 * np.pi * (200 + 30 * np.sin(2 * np.pi * t)) * t)
            + 0.05 * np.random.RandomState(0).randn(len(t))
            ).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--secs", type=int, default=40)
    ap.add_argument("--sizes", default="34,24,16,12")
    ap.add_argument("--chunk-ms", type=int, default=100)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = script_device(args.device)

    cfg = make_config()
    model = init_unidiffuser(cfg.model, seed=0)
    pid = torch.nn.functional.one_hot(torch.tensor([1]),
                                      cfg.model.style_dim).float()
    fps = cfg.data.fps
    sr = cfg.data.mel_sr
    hop = cfg.data.mel_hop
    audio = live_audio(args.secs, sr)

    # offline full-window reference output
    fe = MelFrontend(sr=sr, hop=hop, n_mels=cfg.data.n_mels, device=device)
    mel = fe(torch.as_tensor(audio)[None])
    offline = StreamingGenerator(WindowGenerator(
        cfg, model, device=device)).generate(
            mel, pid, GeneratorNoise(3, device)).float().cpu().numpy()

    fgd_frames = cfg.data.n_poses
    net = init_fgd_net(FgdNetConfig(n_frames=fgd_frames,
                                    pose_dim=cfg.model.motion_dim),
                       device=device)

    def embed(x: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return net(torch.as_tensor(x, device=device)).float().cpu().numpy()

    ref_lat = embed(fgd_windows(offline, fgd_frames))

    chunk = int(sr * args.chunk_ms / 1000)
    gens: dict = {}
    for W in [int(s) for s in args.sizes.split(",") if s]:
        sess = LiveSession.create(cfg, model, pid, GeneratorNoise(3, device),
                                  window_frames=0 if W == cfg.data.n_poses
                                  else W, gen_cache=gens, device=device)
        ov = sess.overlap
        step = sess.step
        # simulate real-time capture; time each push that completes >=1 window
        per_window = []
        emitted = 0
        for lo in range(0, len(audio), chunk):
            t0 = time.perf_counter()
            out = sess.push(audio[lo:lo + chunk])
            if out.shape[1]:
                n_win = max(1, out.shape[1] // step)
                per_window.append((time.perf_counter() - t0) / n_win)
                emitted += out.shape[1]
        live = sess.finish().float().cpu().numpy()

        compute_ms = float(np.median(per_window[2:] or per_window) * 1e3)
        worst_s = W / fps + compute_ms / 1e3
        mean_s = (W + ov + 1) / 2 / fps + compute_ms / 1e3
        rel_rms = float(np.sqrt(((live - offline) ** 2).mean())
                        / np.sqrt((offline ** 2).mean()))
        lat = embed(fgd_windows(live, fgd_frames))
        fgd = float(frechet_from_activations(lat, ref_lat))
        print(json.dumps({
            "window": W, "overlap": ov,
            "lookahead_s": round(W / fps, 3),
            "compute_ms_per_window": round(compute_ms, 1),
            "latency_worst_s": round(worst_s, 3),
            "latency_mean_s": round(mean_s, 3),
            "realtime_headroom": round((step / fps) / (compute_ms / 1e3), 1),
            "rel_rms_vs_offline": round(rel_rms, 4),
            "fgd_vs_offline": round(fgd, 3),
            "frames": int(live.shape[1]),
        }), flush=True)


if __name__ == "__main__":
    main()
