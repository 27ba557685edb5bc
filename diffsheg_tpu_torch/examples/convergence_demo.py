"""Multi-epoch convergence demonstration (synthetic-but-learnable data).

Counterpart of ``examples/convergence_demo.py``.  There are no BEAT / SHOW
corpora here, so convergence is shown on a synthetic dataset where motion
IS a deterministic function of the audio and speaker, the structure the
denoiser must learn:

    motion[b, t] = tanh(mel[b, t] @ W + offset[speaker_b])

(W and the speaker offsets are fixed random matrices).  A conditional
diffusion model that uses its audio pathway drives val MSE toward the
deterministic floor; one that ignores conditioning cannot beat the
marginal variance.  The run goes through the port's ``Trainer.fit`` with
its evaluation cadence (DDIM sampling + FGD / MSE / PCK), so it also
exercises, on a real downward trend, best-checkpoint rotation, a mid-run
resume (a fresh ``Trainer`` + ``try_resume`` continues the trend) and the
metric logger's JSONL curve.  On the card the training step runs the
linear-attention kernel and the evaluation the per-layer kernel.

torch cannot replay JAX's random draws, so this is an independent run of
the same experiment, not a copy of JAX's: the data are equal bit for bit,
the weights, noise and FGD net are torch's own seeded draws.

Run:  python -m diffsheg_tpu_torch.examples.convergence_demo [epochs]
      [--device cpu] [--workdir DIR] [--curve-out FILE]
(default 60 epochs).  Writes <workdir>/metrics.jsonl, prints the eval
curve and the final/first val MSE ratio, and writes the curve to
``curves/convergence.json`` beside this file (``--curve-out`` elsewhere).
The committed curve is from a 240-epoch run on the card; PERF.md has its
numbers and the card.

PCK@0.5 is bounded by the sampling floor: the threshold asks for a
per-joint 3-channel L2 error < 0.5, and for an isotropic residual with
per-channel variance = val MSE, PCK@0.5 = P(chi2_3 < 0.25 / mse); the
``val_pck2`` track (threshold 2.0) shows the same statistic responding to
training (``tests/test_torch_convergence.py`` holds both against the
committed curve).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional

import numpy as np

from diffsheg_tpu_torch.config import (Config, DiffusionConfig, ModelConfig,
                                       TrainConfig)
from diffsheg_tpu_torch.examples import add_device_arg, script_device

CURVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "curves",
                     "convergence.json")


def make_config(eval_every: int = 10) -> Config:
    cfg = Config(
        model=ModelConfig(
            pose_dim=8, expression_dim=4, latent_dim=32, num_layers=2,
            num_heads=4, ff_size=64, audio_dim=16, aud_latent_dim=16,
            style_dim=4, add_hubert=False, encode_hubert=False),
        diffusion=DiffusionConfig(num_steps=100, respacing="ddim10"),
        train=TrainConfig(batch_size=32, lr=4e-4, log_every=4,
                          eval_every_epochs=eval_every, save_every_epochs=0,
                          use_sem_weighting=False, seed=0),
    )
    # 12 frames: the smallest window the FGD conv tower (k3, k3, k4s2, k3)
    # still maps to >= 1 output frame
    return cfg.replace(data=dataclasses.replace(cfg.data, n_poses=12))


class AudioDrivenDataset:
    """motion = tanh(mel @ W + speaker_offset): learnable, deterministic."""

    def __init__(self, cfg: Config, n: int = 256, seed: int = 0):
        m = cfg.model
        T = cfg.data.n_poses
        rng = np.random.RandomState(seed)
        # smooth per-sample audio: random fourier series over the window
        t = np.linspace(0.0, 1.0, T)[None, :, None]
        freq = rng.uniform(0.5, 3.0, size=(n, 1, m.audio_dim))
        phase = rng.uniform(0, 2 * np.pi, size=(n, 1, m.audio_dim))
        mel = np.sin(2 * np.pi * freq * t + phase).astype(np.float32)
        W = rng.randn(m.audio_dim, m.motion_dim).astype(np.float32) * 0.6
        offsets = rng.randn(m.style_dim, m.motion_dim).astype(np.float32) * .3
        sid = rng.randint(0, m.style_dim, size=n)
        motion = np.tanh(mel @ W + offsets[sid][:, None, :])
        self.data = {
            "motion": motion.astype(np.float32),
            "mel": mel,
            "id": sid.reshape(n, 1).astype(np.int32),
        }
        self.n = n

    def __len__(self):
        return self.n

    def batch(self, idx):
        return {k: v[idx] for k, v in self.data.items()}


def run(workdir: str, num_epochs: int = 60, eval_every: int = 10,
        resume_at: Optional[int] = None, n_train: int = 256,
        n_val: int = 64, device=None) -> List[Dict[str, float]]:
    """Train with eval cadence; returns the eval curve (list of dicts).

    ``resume_at`` splits the run into fit(resume_at) + a FRESH Trainer that
    ``try_resume``s and fits to ``num_epochs``: the mid-run resume check.
    ``device``: the GPU by default (raises without one), or 'cpu'.
    """
    from diffsheg_tpu_torch.data.loader import ShardedBatchLoader
    from diffsheg_tpu_torch.eval.fgd_net import FgdNetConfig, init_fgd_net
    from diffsheg_tpu_torch.train.trainer import Trainer

    cfg = make_config(eval_every)
    train_ds = AudioDrivenDataset(cfg, n=n_train, seed=0)
    val_ds = AudioDrivenDataset(cfg, n=n_val, seed=1)
    train_loader = ShardedBatchLoader(
        train_ds, global_batch_size=cfg.train.batch_size, prefetch=0)
    val_loader = ShardedBatchLoader(val_ds, global_batch_size=n_val,
                                    prefetch=0, shuffle=False)

    # random-init FGD feature net: Frechet distance in a fixed random
    # feature space still contracts as the generated distribution
    # approaches the data distribution
    net = init_fgd_net(FgdNetConfig(n_frames=cfg.data.n_poses,
                                    pose_dim=cfg.model.motion_dim),
                       seed=7, device=device)

    def build():
        return Trainer(cfg, workdir, device=device, fgd_net=net)

    tr = build()
    tr.try_resume()
    phases = [num_epochs] if resume_at is None else [resume_at, num_epochs]
    for end in phases:
        if tr.epoch < end:
            tr.fit(train_loader, val_loader, num_epochs=end)
        if end != phases[-1]:
            tr = build()             # fresh process-equivalent: must resume
            assert tr.try_resume(), "mid-run resume found no checkpoint"
            assert tr.epoch == end

    # read back the eval curve from the logger's JSONL
    curve = []
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "val_mse" in rec:
                curve.append(rec)
    return curve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("epochs", type=int, nargs="?", default=60)
    ap.add_argument("--workdir", default=os.environ.get(
        "CONV_DEMO_DIR", os.path.join(tempfile.gettempdir(),
                                      "convergence_demo")))
    ap.add_argument("--curve-out", default=CURVE)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = script_device(args.device)

    epochs = args.epochs
    curve = run(args.workdir, num_epochs=epochs, resume_at=epochs // 2,
                device=device)
    for row in curve:
        print(json.dumps(row))
    first, last = curve[0], curve[-1]
    print(json.dumps({
        "metric": "convergence_val_mse_ratio",
        "value": round(last["val_mse"] / first["val_mse"], 4),
        "unit": "final/first",
        "evals": len(curve),
    }))
    os.makedirs(os.path.dirname(os.path.abspath(args.curve_out)),
                exist_ok=True)
    with open(args.curve_out, "w") as f:
        json.dump({"epochs": epochs, "curve": curve}, f, indent=1)
    print("curve ->", args.curve_out)


if __name__ == "__main__":
    main()
