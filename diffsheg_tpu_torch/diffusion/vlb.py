"""Variational-lower-bound terms and learned-variance support.

Counterpart of ``diffsheg_tpu/diffusion/vlb.py``: the gaussian KL, the
discretized gaussian likelihood of the t = 0 term, per-timestep VLB terms
in bits, the prior term, and the learned-range variance interpolation
(``var_type='learned_range'``) of a model output that carries 2C
channels.  ``t`` is (B,) levels as a tensor; :func:`learned_range_logvar`
also takes one level as a python int, as the sampler's host loop does.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from diffsheg_tpu_torch.diffusion.schedule import DiffusionSchedule, gather

LOG2 = math.log(2.0)


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL(N(mean1, e^logvar1) || N(mean2, e^logvar2)), elementwise, in
    nats."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, means, log_scales) -> torch.Tensor:
    """Log-likelihood of data in [-1, 1], discretized to 255 bins, under a
    gaussian."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_delta))


def learned_range_logvar(sched: DiffusionSchedule, var_raw: torch.Tensor,
                         t) -> torch.Tensor:
    """The log-variance interpolated between the posterior's (min) and
    beta's (max) from a [-1, 1] model output, at the (respaced)
    schedule's level ``t``."""
    min_log = gather(sched.posterior_log_variance_clipped, t, var_raw)
    max_log = gather(np.log(sched.betas), t, var_raw)
    frac = (var_raw + 1.0) / 2.0
    return frac * max_log + (1.0 - frac) * min_log


def split_learned_variance(model_out: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A 2C-channel output -> (mean part, raw variance)."""
    C = model_out.shape[-1] // 2
    return model_out[..., :C], model_out[..., C:]


def _mean_bits(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0], -1).mean(dim=1) / LOG2


def vlb_term(sched: DiffusionSchedule, x_start, x_t, t: torch.Tensor,
             pred_mean, pred_logvar) -> torch.Tensor:
    """Per-sample L_{t-1} in bits: KL(q(x_{t-1} | x_t, x_0) || p) for
    t > 0, the discretized decoder NLL at t = 0."""
    true_mean = sched.q_posterior_mean(x_start, x_t, t)
    true_logvar = gather(sched.posterior_log_variance_clipped, t, x_t)
    kl = _mean_bits(normal_kl(true_mean, true_logvar, pred_mean, pred_logvar))
    nll = _mean_bits(-discretized_gaussian_log_likelihood(
        x_start, pred_mean, 0.5 * pred_logvar))
    return torch.where(t.to(kl.device) == 0, nll, kl)


def vb_term_from_output(sched: DiffusionSchedule, x_start, x_t,
                        t: torch.Tensor, model_out: torch.Tensor,
                        mean_type: str = "epsilon",
                        var_type: str = "learned_range",
                        clip_denoised: bool = False,
                        freeze_mean: bool = False) -> torch.Tensor:
    """Per-sample VLB term (bits) from a (B, T, 2C) output, mean part ++
    raw variance.  ``freeze_mean`` detaches the mean half, so the term
    trains only the variance head (the hybrid loss)."""
    mean_part, var_raw = split_learned_variance(model_out)
    if freeze_mean:
        mean_part = mean_part.detach()
    if var_type == "learned":
        pred_logvar = var_raw
    elif var_type == "learned_range":
        pred_logvar = learned_range_logvar(sched, var_raw, t)
    else:
        raise ValueError(var_type)
    if mean_type == "previous_x":
        pred_mean = mean_part
    else:
        if mean_type == "epsilon":
            x0 = sched.predict_xstart_from_eps(x_t, t, mean_part)
        elif mean_type == "start_x":
            x0 = mean_part
        else:
            raise ValueError(mean_type)
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        pred_mean = sched.q_posterior_mean(x0, x_t, t)
    return vlb_term(sched, x_start, x_t, t, pred_mean, pred_logvar)


def prior_kl(sched: DiffusionSchedule, x_start: torch.Tensor) -> torch.Tensor:
    """L_T: KL(q(x_T | x_0) || N(0, I)) in bits, per sample."""
    t = torch.full((x_start.shape[0],), sched.num_steps - 1, dtype=torch.long)
    mean = gather(sched.sqrt_alphas_cumprod, t, x_start) * x_start
    logvar = gather(np.log(np.float32(1.0) - sched.alphas_cumprod), t,
                    x_start)
    kl = normal_kl(mean, logvar, torch.zeros_like(mean),
                   torch.zeros_like(logvar))
    return _mean_bits(kl)
