"""Aggregate-throughput probe: one audio, B speaker styles in one batch.

Counterpart of ``examples/batch_probe.py``.  The window stream is
sequential (RePaint overlap), so aggregate throughput comes from the free
batch axis — the reference loops styles serially.  BEAT at full width,
bf16, jump_n_sample 2, a 60 s stream through ``FusedPipeline`` with B
styles; on the card the per-layer kernel runs at (B, 34) rows, in
launches of at most 256 rows (``ops/fused_layer.py``).  Prints one line a
batch size: the best of 4 timed calls and the aggregate FPS against the
reference's 55 FPS A100 single stream.

Run: python -m diffsheg_tpu_torch.examples.batch_probe [B ...] [--device cpu]
(default B 8 and 64; ``BENCH_FUSED_LAYER`` / ``BENCH_QUANT`` as in
show_bench.py)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from diffsheg_tpu_torch.audio.hubert_runner import HubertFeatureExtractor
from diffsheg_tpu_torch.audio.mel import MelFrontend
from diffsheg_tpu_torch.config import beat_config
from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
from diffsheg_tpu_torch.examples import (add_device_arg, script_device,
                                         synchronize)
from diffsheg_tpu_torch.models.hubert import HubertConfig
from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
from diffsheg_tpu_torch.sampling.generator import WindowGenerator
from diffsheg_tpu_torch.sampling.pipeline import FusedPipeline
from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator

SECS = 60


def make_config():
    cfg = beat_config()
    cfg = cfg.replace(diffusion=dataclasses.replace(
        cfg.diffusion, jump_n_sample=2,
        # the per-layer kernel ('auto'): batched styles share its launches
        fused_layer=os.environ.get("BENCH_FUSED_LAYER", "auto"),
        quantize=os.environ.get("BENCH_QUANT", "none")))
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 compute_dtype="bfloat16"))


def synth(sr: int, secs: int = 0) -> np.ndarray:
    """(1, secs * sr), ``SECS`` seconds by default: a 220 Hz tone plus
    seeded noise."""
    secs = secs or SECS
    t = np.arange(secs * sr) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.1 * np.random.RandomState(1).randn(secs * sr)
            ).astype(np.float32)[None]


def run(B, device=None):
    device = script_device(device)
    cfg = make_config()
    model = init_unidiffuser(cfg.model, seed=0)
    stream = StreamingGenerator(WindowGenerator(cfg, model, device=device))
    frontend = MelFrontend(sr=cfg.data.mel_sr, hop=cfg.data.mel_hop,
                           n_mels=cfg.data.n_mels, device=device)
    hub_fe = HubertFeatureExtractor(HubertConfig(dtype="bfloat16"),
                                    device=device)
    pipe = FusedPipeline(stream, frontend, hub_fe)

    a18 = torch.as_tensor(synth(cfg.data.mel_sr), device=device)
    a16 = torch.as_tensor(synth(16000), device=device)
    pid = torch.nn.functional.one_hot(
        torch.arange(B) % cfg.model.style_dim,
        cfg.model.style_dim).float().to(device)
    out = pipe(a18, a16, pid, GeneratorNoise(0, device))
    synchronize(device)
    ts = []
    for i in range(4):
        t0 = time.perf_counter()
        out = pipe(a18, a16, pid, GeneratorNoise(i + 1, device))
        synchronize(device)
        ts.append(time.perf_counter() - t0)
    frames = int(out.shape[1]) * B
    print(f"B={B}: {min(ts):.3f}s -> aggregate {frames/min(ts):.0f} FPS "
          f"({frames/min(ts)/55:.0f}x A100 single-stream)", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", type=int, nargs="*", default=[8, 64])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = script_device(args.device)
    for b in args.batch:
        run(b, device)


if __name__ == "__main__":
    main()
