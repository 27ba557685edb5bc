"""End-to-end learning sanity demo: overfit one window, sample it back.

Counterpart of ``examples/overfit_demo.py``.  Trains a small UniDiffuser
(BEAT data widths, latent 128, 4 layers) on one synthetic (mel, motion)
window until the conditional distribution collapses onto the data point,
then runs the DDIM-25 sampler and reports how closely the generated window
reproduces the ground truth: training -> weights -> sampling as one loop
that *learns*.  On the card the step runs the linear-attention kernel and
``WindowGenerator.generate`` the per-layer kernel (f32, one window of 34
frames).  The criterion is the JAX demo's: normalised error (sample MSE /
GT variance) below 0.5 is "LEARNED".  PERF.md has the result on the card.

Usage: python -m diffsheg_tpu_torch.examples.overfit_demo [--steps 24000]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from diffsheg_tpu_torch.config import beat_config
from diffsheg_tpu_torch.examples import add_device_arg, script_device


def make_config():
    cfg = beat_config()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, latent_dim=128, num_layers=4, num_heads=4,
            ff_size=256, add_hubert=False),
        # the demo data lives in [-1, 1], so clipped x0 predictions keep the
        # partially-trained chain stable (the reference samples unclipped on
        # z-scored data with a fully-trained model)
        diffusion=dataclasses.replace(cfg.diffusion, clip_denoised=True),
        train=dataclasses.replace(cfg.train, lr=4e-4),
    )


def overfit_window(cfg):
    """One synthetic window: smooth phase-shifted multi-frequency motion
    (low-rank, like real gesture data), a seeded random mel and speaker 3.
    Returns (motion (T, C), mel (1, T, A), pid (1, S)) float32."""
    T, C = cfg.data.n_poses, cfg.model.motion_dim
    t = np.linspace(0, 2 * np.pi, T)[:, None]
    ch = np.arange(C)[None, :]
    motion = (0.6 * np.sin(2 * t + 0.3 * ch)).astype(np.float32)
    rng0 = np.random.RandomState(0)
    mel = rng0.randn(1, T, cfg.model.audio_dim).astype(np.float32)
    pid = np.eye(cfg.model.style_dim, dtype=np.float32)[[3]]
    return motion, mel, pid


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=24000)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = script_device(args.device)

    from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
    from diffsheg_tpu_torch.diffusion.schedule import (
        get_named_beta_schedule, make_schedule)
    from diffsheg_tpu_torch.models.factory import build_denoiser, random_init_
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator
    from diffsheg_tpu_torch.train.step import (create_train_state,
                                               make_train_step)

    cfg = make_config()
    T = cfg.data.n_poses
    motion, mel, pid = overfit_window(cfg)

    # replicate the window across the batch: each row draws its own
    # timestep, so every step covers the t range (B=1 gives one t per
    # update and the high-t x0/velocity terms destabilize Adam)
    B = 32
    batch = {
        "motion": torch.as_tensor(motion, device=device)[None].repeat(B, 1, 1),
        "mel": torch.as_tensor(mel, device=device).repeat(B, 1, 1),
        "pid": torch.as_tensor(pid, device=device).repeat(B, 1),
        "sem": torch.zeros((B, T), device=device),
    }

    # the Flax initialisation's distributions (zero output projections)
    model = random_init_(build_denoiser(cfg.model), 0, perturb=0.0)
    sched = make_schedule(get_named_beta_schedule("linear", 1000))
    step = make_train_step(cfg, sched)
    state = create_train_state(cfg, model, device)

    t0 = time.time()
    for i in range(args.steps):
        state, terms = step(state, batch)
        if (i + 1) % max(1, args.steps // 10) == 0:
            print(f"step {i + 1}: eps_mse={float(terms.eps_mse):.4f} "
                  f"total={float(terms.total):.1f}", flush=True)
    print(f"trained {args.steps} steps in {time.time() - t0:.1f}s")

    gen = WindowGenerator(cfg, state.model, device=device)
    samples = []
    for seed in range(3):
        out = gen.generate(torch.as_tensor(mel), torch.as_tensor(pid),
                           GeneratorNoise(100 + seed, device), None)
        samples.append(out.float().cpu().numpy()[0])
    err = [float(((s - motion) ** 2).mean()) for s in samples]
    gt_var = float(motion.var())
    print(f"GT variance: {gt_var:.4f}")
    print(f"sample MSE vs GT (3 seeds): {[round(e, 4) for e in err]}")
    ratio = np.mean(err) / gt_var
    print(f"normalized error: {ratio:.3f} "
          f"({'LEARNED' if ratio < 0.5 else 'NOT LEARNED'})")
    return 0 if ratio < 0.5 else 1


if __name__ == "__main__":
    raise SystemExit(main())
