"""Live streaming demo: simulated microphone capture -> motion.

Counterpart of ``examples/live_demo.py``.  Feeds synthetic audio to a
``LiveSession`` (BEAT at full width, bf16, no HuBERT, jump_n_sample 2:
the per-layer kernel at (1, 34) on the card) in 250 ms capture chunks and
reports, per push that emitted motion, how many frames came out and how
long the window took; then the whole session's coverage and wall time.
With a real checkpoint this is the skeleton of a live avatar program; here
it shows the latency profile with random weights.

Run: python -m diffsheg_tpu_torch.examples.live_demo [seconds] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from diffsheg_tpu_torch.config import beat_config
from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
from diffsheg_tpu_torch.examples import add_device_arg, script_device
from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
from diffsheg_tpu_torch.sampling.generator import WindowGenerator
from diffsheg_tpu_torch.sampling.live import LiveSession


def make_config():
    cfg = beat_config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="bfloat16",
                                  add_hubert=False),
        diffusion=dataclasses.replace(cfg.diffusion, jump_n_sample=2))


def capture_audio(secs: float, sr: int) -> np.ndarray:
    """A 220 Hz tone plus seeded noise, ``secs`` seconds at ``sr``."""
    t = np.arange(int(secs * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.1 * np.random.RandomState(0).randn(len(t))
            ).astype(np.float32)


def main(secs: float = 12.0, device=None):
    device = script_device(device)
    cfg = make_config()
    model = init_unidiffuser(cfg.model, seed=0)
    gen = WindowGenerator(cfg, model, device=device)
    pid = torch.nn.functional.one_hot(torch.tensor([2]),
                                      cfg.model.style_dim).float()
    session = LiveSession(gen, pid, GeneratorNoise(1, device))

    sr = cfg.data.mel_sr
    chunk = int(0.25 * sr)                       # 250 ms capture blocks
    audio = capture_audio(secs, sr)

    total_frames, t_start = 0, time.perf_counter()
    for i in range(0, len(audio), chunk):
        t0 = time.perf_counter()
        out = session.push(audio[i:i + chunk])
        dt = time.perf_counter() - t0
        total_frames += out.shape[1]
        if out.shape[1]:
            audio_s = (i + chunk) / sr
            print(f"t={audio_s:5.2f}s  +{out.shape[1]} frames "
                  f"(window in {dt*1e3:.0f} ms, "
                  f"motion through {total_frames/cfg.data.fps:.2f}s)",
                  file=sys.stderr)
    final = session.finish()
    wall = time.perf_counter() - t_start
    print(f"session: {final.shape[1]} frames of motion for {secs:.1f}s of "
          f"audio in {wall:.2f}s wall "
          f"({final.shape[1]/cfg.data.fps/secs*100:.0f}% coverage, "
          f"first window after {cfg.data.n_poses/cfg.data.fps:.1f}s of "
          f"audio)", file=sys.stderr)
    return final


def cli(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("seconds", type=float, nargs="?", default=12.0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    main(args.seconds, script_device(args.device))


if __name__ == "__main__":
    cli()
