"""Diffusion noise schedules and coefficient tables.

Counterpart of ``diffsheg_tpu/diffusion/schedule.py``: every per-timestep
coefficient is computed once on the host in float64 and kept as a float32
table.  The sampler's loop runs on the host and reads its scalars from
these tables: the closed forms (``q_posterior_mean``, ``predict_*``) take
one level as a python int, or (B,) levels as a tensor; ``undo`` one
level; ``q_sample`` is the forward process the training loss noises with.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def get_named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    """Beta schedule by name, float64 on host ('linear' or 'cosine')."""
    if name == "linear":
        scale = 1000.0 / num_steps
        return np.linspace(scale * 1e-4, scale * 0.02, num_steps,
                           dtype=np.float64)
    if name == "cosine":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        betas = [min(1.0 - alpha_bar((i + 1) / num_steps)
                     / alpha_bar(i / num_steps), 0.999)
                 for i in range(num_steps)]
        return np.array(betas, dtype=np.float64)
    raise ValueError(f"unknown beta schedule: {name!r}")


class DiffusionSchedule(NamedTuple):
    """Per-timestep coefficient tables, each ``(T,)`` float32 numpy."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    alphas_cumprod_next: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    large_variance: np.ndarray
    log_large_variance: np.ndarray

    @property
    def num_steps(self) -> int:
        return self.betas.shape[0]

    # closed forms at one level ``t`` (python int: scalars in float32 as
    # the JAX tables are gathered) or at (B,) levels (a tensor, as the VLB
    # terms and the training loss take them)
    def q_sample(self, x_start, t, noise):
        """Forward diffusion: x_t ~ q(x_t | x_0) with the given noise."""
        return (gather(self.sqrt_alphas_cumprod, t, x_start) * x_start
                + gather(self.sqrt_one_minus_alphas_cumprod, t, x_start)
                * noise)

    def q_posterior_mean(self, x_start, x_t, t):
        return (gather(self.posterior_mean_coef1, t, x_t) * x_start
                + gather(self.posterior_mean_coef2, t, x_t) * x_t)

    def predict_xstart_from_eps(self, x_t, t, eps):
        return (gather(self.sqrt_recip_alphas_cumprod, t, x_t) * x_t
                - gather(self.sqrt_recipm1_alphas_cumprod, t, x_t) * eps)

    def predict_eps_from_xstart(self, x_t, t, x0):
        return ((gather(self.sqrt_recip_alphas_cumprod, t, x_t) * x_t - x0)
                / gather(self.sqrt_recipm1_alphas_cumprod, t, x_t))

    def predict_xstart_from_xprev(self, x_t, t, xprev):
        c1 = self.posterior_mean_coef1
        return (gather(np.float32(1.0) / c1, t, x_t) * xprev
                - gather(self.posterior_mean_coef2 / c1, t, x_t) * x_t)

    def undo(self, x: torch.Tensor, t: int, noise: torch.Tensor) -> torch.Tensor:
        """RePaint re-noising: one forward-diffusion step at level ``t``."""
        beta = np.float32(self.betas[t])
        return (float(np.sqrt(np.float32(1.0) - beta)) * x
                + float(np.sqrt(beta)) * noise)


def gather(table: np.ndarray, t, like: torch.Tensor):
    """``table[t]`` to broadcast against ``like``: a python float for one
    level ``t`` (a python int), or for (B,) levels ``t`` (a tensor) a
    float32 tensor of shape (B, 1, ...) on ``like``'s device."""
    if isinstance(t, (int, np.integer)):
        return float(table[t])
    out = torch.as_tensor(table, device=like.device)[t.to(like.device).long()]
    return out.reshape(out.shape + (1,) * (like.ndim - out.ndim))


def make_schedule(betas: np.ndarray) -> DiffusionSchedule:
    """All coefficient tables from a 1-D beta array (float64 math, float32
    tables)."""
    betas = np.asarray(betas, dtype=np.float64)
    if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must be a 1-D array in (0, 1]")
    alphas = 1.0 - betas
    acp = np.cumprod(alphas, axis=0)
    acp_prev = np.append(1.0, acp[:-1])
    acp_next = np.append(acp[1:], 0.0)
    posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
    posterior_log_variance_clipped = np.log(
        np.append(posterior_variance[1], posterior_variance[1:]))
    large_variance = np.append(posterior_variance[1], betas[1:])

    def f32(x):
        return np.asarray(x, dtype=np.float32)

    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(acp),
        alphas_cumprod_prev=f32(acp_prev),
        alphas_cumprod_next=f32(acp_next),
        sqrt_alphas_cumprod=f32(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - acp)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
        posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas)
                                 / (1.0 - acp)),
        large_variance=f32(large_variance),
        log_large_variance=f32(np.log(large_variance)),
    )
