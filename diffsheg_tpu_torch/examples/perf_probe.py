"""Sampler-stage performance probe.

Counterpart of ``examples/perf_probe.py``.  Times the whole-stream sampler
(``StreamingGenerator.generate_fused``, BEAT at full width, jump_n_sample
2, best of 5 calls) under micro-variants that guide the kernels' dispatch
defaults:
  - the linear-attention kernel against the two-einsum torch composition
    (every ``models/attention.py`` call forced to one or the other; on
    the fast path that is the level cache's audio encoder, once a
    stream), in f32;
  - float32 against bfloat16 compute, with the kernel forced for bf16
    too (the port's default dispatch takes the composition for bf16:
    this variant measures that choice);
  - weight-only int8 on top of bf16.
Each variant is a kernel path but the composition row, which exists to
be compared with the first.

Usage: python -m diffsheg_tpu_torch.examples.perf_probe [--secs 60]
       [--batch 1] [--device cpu]
Prints one line per variant; not part of any benchmark contract.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import time

import numpy as np
import torch

from diffsheg_tpu_torch.audio.mel import MelFrontend
from diffsheg_tpu_torch.config import beat_config
from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
from diffsheg_tpu_torch.examples import (add_device_arg, script_device,
                                         synchronize)
from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
from diffsheg_tpu_torch.sampling.generator import WindowGenerator
from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator


@contextlib.contextmanager
def attention_path(use_fused):
    """Every linear attention of the model forward through the kernel
    (True), the composition (False) or the default dispatch (None)."""
    import diffsheg_tpu_torch.models.attention as attn
    orig = attn.linear_attention
    if use_fused is not None:
        attn.linear_attention = functools.partial(orig, use_fused=use_fused)
    try:
        yield
    finally:
        attn.linear_attention = orig


def run_variant(name, cfg, model, secs, batch, device=None,
                use_fused_attention=None):
    device = script_device(device)
    gen = WindowGenerator(cfg, model, device=device)
    stream = StreamingGenerator(gen)
    frontend = MelFrontend(sr=cfg.data.mel_sr, hop=cfg.data.mel_hop,
                           n_mels=cfg.data.n_mels, device=device)
    t = np.arange(secs * cfg.data.mel_sr) / cfg.data.mel_sr
    audio = np.tile((0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
                    [None], (batch, 1))
    mel = frontend(torch.as_tensor(audio))
    T = mel.shape[1]
    hubert = torch.zeros((batch, T, cfg.model.hubert_dim), device=device)
    pid = torch.nn.functional.one_hot(
        torch.arange(batch) % cfg.model.style_dim,
        cfg.model.style_dim).float()

    with attention_path(use_fused_attention):
        out = stream.generate_fused(mel, pid, GeneratorNoise(0, device),
                                    hubert=hubert)
        synchronize(device)   # warm-up: the kernels' build and load
        times = []
        for i in range(5):
            t0 = time.perf_counter()
            out = stream.generate_fused(mel, pid,
                                        GeneratorNoise(i + 1, device),
                                        hubert=hubert)
            synchronize(device)
            times.append(time.perf_counter() - t0)
    frames = out.shape[0] * out.shape[1]
    best = min(times)
    print(f"{name:28s} sampler={best:.3f}s  {frames / best:8.1f} fps "
          f"(frames={frames})", flush=True)
    return best


def make_config():
    cfg = beat_config()
    return cfg.replace(diffusion=dataclasses.replace(cfg.diffusion,
                                                     jump_n_sample=2))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--secs", type=int, default=60)
    ap.add_argument("--batch", type=int, default=1)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = script_device(args.device)

    cfg = make_config()
    model = init_unidiffuser(cfg.model, seed=0)

    run_variant("f32 + kernel-attn", cfg, model, args.secs, args.batch,
                device, use_fused_attention=True)
    run_variant("f32 + einsum-attn", cfg, model, args.secs, args.batch,
                device, use_fused_attention=False)

    cfg_bf16 = cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16"))
    run_variant("bf16 params + kernel", cfg_bf16, model, args.secs,
                args.batch, device, use_fused_attention=True)

    # weight-only int8 transformer stack on top of bf16 serving
    # (fused_layer='on': quantize needs the fast path)
    cfg_int8 = cfg_bf16.replace(diffusion=dataclasses.replace(
        cfg_bf16.diffusion, quantize="int8", fused_layer="on"))
    run_variant("bf16 + int8 weights", cfg_int8, model, args.secs,
                args.batch, device)


if __name__ == "__main__":
    main()
