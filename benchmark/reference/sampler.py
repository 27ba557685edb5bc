"""Plain reference of the windowed DDIM sampler with RePaint outpainting.

The DiffSHEG repository's inference (``gaussian_diffusion.py``,
``models/scheduler.py``, ``trainers/ddpm_beat_trainer.py``): a linear beta
schedule of 1000 steps respaced to DDIM-N, eta 0; the first window samples
every respaced step, each later window walks the RePaint jump schedule
from 60% depth with its first ``overlap`` frames pinned toward the
previous window's output (noised to the level, cross-faded into the
sample once the noise weight drops below 0.2), and undo steps re-noise
one forward step.  Windows advance by ``size - overlap``; the last one is
shifted left to end at the sequence end and only its new frames are kept.

Noise comes from an object with ``initial(window, shape, device)`` and
``step(window, step, kind, shape, device)``, one per clip; a batch of
clips is sampled together, one row each.
"""

from __future__ import annotations

import numpy as np
import torch


class Schedule:
    """Respaced coefficient tables (float64 math, float32 values)."""

    def __init__(self, num_steps, respacing):
        base = np.linspace(1e-4 * 1000 / num_steps, 0.02 * 1000 / num_steps,
                           num_steps, dtype=np.float64)
        acp = np.cumprod(1.0 - base)
        n = int(respacing[len("ddim"):])
        stride = next(s for s in range(1, num_steps)
                      if len(range(0, num_steps, s)) == n)
        keep = list(range(0, num_steps, stride))
        self.timestep_map = np.asarray(keep, dtype=np.int64)
        betas, last = [], 1.0
        for i in keep:
            betas.append(1.0 - acp[i] / last)
            last = acp[i]
        betas = np.asarray(betas)
        ab = np.cumprod(1.0 - betas)
        f32 = np.float32
        self.n = len(betas)
        self.betas = betas.astype(f32)
        self.ab = ab.astype(f32)
        self.ab_prev = np.append(1.0, ab[:-1]).astype(f32)
        self.sqrt_recip = np.sqrt(1.0 / ab).astype(f32)
        self.sqrt_recipm1 = np.sqrt(1.0 / ab - 1.0).astype(f32)


def jump_times(t_T, length, n_sample):
    """The RePaint walk from ``t_T`` down to -1, climbing ``length`` steps
    back ``n_sample - 1`` times at every ``length``-th level."""
    jumps = {j: n_sample - 1 for j in range(0, t_T - length, length)}
    t, ts = t_T, []
    while t >= 1:
        t -= 1
        ts.append(t)
        if jumps.get(t, 0) > 0:
            jumps[t] -= 1
            for _ in range(length):
                t += 1
                ts.append(t)
    ts.append(-1)
    return ts


def programs(sched, diffusion):
    """(plain, harmonize): lists of (t, is_denoise) transitions."""
    plain = [(t, True) for t in range(sched.n - 1, -1, -1)]
    t_T = 15 if sched.n == 25 else int(sched.n * 0.6)
    ts = jump_times(t_T, diffusion["jump_length"], diffusion["jump_n_sample"])
    harm = [(a, b < a) for a, b in zip(ts[:-1], ts[1:])]
    return plain, harm


def window_starts(T, size, step):
    if T <= size:
        return [0]
    starts, s = [], 0
    while s + size <= T:
        starts.append(s)
        s += step
    if starts[-1] + size < T:
        starts.append(T - size)
    return starts


def _stack(noises, fn):
    return torch.cat([fn(nz) for nz in noises])


def sample_window(model_fn, sched, program, noises, window, shape, dev,
                  gt=None, overlap=0):
    """One window of every clip in the batch (row i draws from
    ``noises[i]``); ``gt`` (B, T, C) pins the first ``overlap`` frames."""
    one = (1,) + tuple(shape[1:])
    x = _stack(noises, lambda nz: nz.initial(window, one, dev))
    f32 = np.float32
    for s, (t, denoise) in enumerate(program):
        if not denoise:
            beta = f32(sched.betas[t])
            x = (float(np.sqrt(f32(1) - beta)) * x + float(np.sqrt(beta))
                 * _stack(noises, lambda nz: nz.step(window, s, "undo", one, dev)))
            continue
        eps = model_fn(x, t)
        x0 = float(sched.sqrt_recip[t]) * x - float(sched.sqrt_recipm1[t]) * eps
        ab, abp = f32(sched.ab[t]), f32(sched.ab_prev[t])
        e = (float(np.sqrt(f32(1) / ab)) * x - x0) / float(np.sqrt(f32(1) / ab - f32(1)))
        x = x0 * float(np.sqrt(abp)) + float(np.sqrt(f32(1) - abp)) * e
        if gt is not None:
            noise_w = np.sqrt(f32(1) - abp)
            gtn = _stack(noises, lambda nz: nz.step(window, s, "gt", one, dev))
            head = (float(np.sqrt(abp)) * gt[:, :overlap]
                    + float(noise_w) * gtn[:, :overlap])
            if noise_w < f32(0.2):
                w = (torch.arange(overlap, device=dev, dtype=torch.float32)
                     / float(max(overlap - 1, 1))).reshape(1, overlap, 1)
                head = head * (1 - w) + x[:, :overlap] * w
            x = torch.cat([head, x[:, overlap:]], dim=1)
    return x


@torch.no_grad()
def sample_stream(model, cfg, sched, mel, pid, hubert, noises):
    """mel (B, T, n_mels), pid (B, style), hubert (B, T, H) -> (B, T, C).
    ``cfg`` is a configuration file's dict."""
    m, d, st = cfg["model"], cfg["diffusion"], cfg["stream"]
    size, overlap = cfg["data"]["n_poses"], st["overlap_len"]
    step = size - overlap
    B, T = mel.shape[:2]
    C = m["pose_dim"] + m["expression_dim"]
    dev = mel.device
    plain, harm = programs(sched, d)
    guided = m["classifier_free"] and m["cond_scale"] != 1.0
    starts = window_starts(T, size, step)
    res = torch.zeros((B, T, C), device=dev)
    out = None
    for k, s in enumerate(starts):
        mw, hw = mel[:, s:s + size], hubert[:, s:s + size]

        def model_fn(x, t):
            tt = torch.full((B,), int(sched.timestep_map[t]), device=dev)
            return model(x, tt, (float(sched.sqrt_recip[t]),
                                 float(sched.sqrt_recipm1[t])),
                         mw, pid, hw, cfg=guided)

        if k == 0:
            out = sample_window(model_fn, sched, plain, noises, 0,
                                (B, size, C), dev)
            res[:, :step] = out[:, :step]
            continue
        tf = s - starts[k - 1]
        gt = torch.zeros((B, size, C), device=dev)
        gt[:, :overlap] = out[:, tf:tf + overlap]
        out = sample_window(model_fn, sched, harm, noises, k, (B, size, C),
                            dev, gt=gt, overlap=overlap)
        if k < len(starts) - 1:
            res[:, s:s + step] = out[:, :step]
        else:
            new = starts[k - 1] + step - s
            res[:, s + new:] = out[:, new:]
    return res
