"""Training losses for the denoiser.

Counterpart of ``diffsheg_tpu/diffusion/losses.py``:

    L = eps_weight * masked-MSE(eps)
      + vel_weight * MSE(velocity of the predicted x0)   (epoch-gated)
      + x0_weight  * Huber_beta(x0 * (sem + 1))           (epoch-gated)
      + the VLB term (learned variance, or 'kl' / 'rescaled_kl' alone)

Pure functions of the model output, the batch and the schedule.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from diffsheg_tpu_torch.config import TrainConfig
from diffsheg_tpu_torch.diffusion.schedule import DiffusionSchedule


class LossTerms(NamedTuple):
    total: torch.Tensor
    eps_mse: torch.Tensor
    vel_mse: torch.Tensor
    x0_huber: torch.Tensor
    vb: torch.Tensor        # variational-bound term (bits), else 0


def huber(pred: torch.Tensor, target: torch.Tensor, beta: float,
          sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``smooth_l1(pred / beta, target / beta) * beta``, mean reduction;
    optional per-sample weights along the batch axis."""
    d = torch.abs(pred - target) / beta
    per_elem = torch.where(d < 1.0, 0.5 * d * d, d - 0.5) * beta
    if sample_weights is not None:
        per_elem = per_elem * sample_weights.reshape(
            (-1,) + (1,) * (per_elem.ndim - 1))
    return per_elem.mean()


def masked_time_mean(per_frame: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """(B, T) values averaged over the valid frames."""
    return (per_frame * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def diffusion_loss(
    sched: DiffusionSchedule,
    model_out: torch.Tensor,     # (B, T, C) predicted epsilon
    x_start: torch.Tensor,       # (B, T, C)
    x_t: torch.Tensor,           # (B, T, C)
    t: torch.Tensor,             # (B,)
    noise: torch.Tensor,         # (B, T, C)
    cfg: TrainConfig,
    src_mask: Optional[torch.Tensor] = None,   # (B, T)
    sem_score: Optional[torch.Tensor] = None,  # (B, T)
    vel_loss_active: bool = True,
    t_weights: Optional[torch.Tensor] = None,  # (B,) importance weights
    var_out: Optional[torch.Tensor] = None,    # (B, T, C) raw variance half
    var_type: str = "learned_range",
    mean_type: str = "epsilon",
) -> LossTerms:
    B, T, _ = x_start.shape
    dev = x_start.device
    mask = torch.ones(B, T, device=dev) if src_mask is None else src_mask
    zero = torch.zeros((), device=dev)

    vb = zero
    if cfg.loss_type in ("kl", "rescaled_kl") or var_out is not None:
        from diffsheg_tpu_torch.diffusion.vlb import vb_term_from_output
        vb_var_type = var_type
        if var_out is None:
            # a fixed variance through the learned-range interpolation:
            # raw -1 is fixed_small, +1 fixed_large (at every t > 0)
            vb_var_type = "learned_range"
            fill = 1.0 if var_type == "fixed_large" else -1.0
            var_out = torch.full_like(model_out, fill)
        full_out = torch.cat([model_out, var_out], dim=-1)
        # the hybrid objective detaches the mean half, so the VLB trains
        # only the variance head
        hybrid = cfg.loss_type in ("mse", "rescaled_mse")
        per_sample_vb = vb_term_from_output(
            sched, x_start, x_t, t, full_out, mean_type=mean_type,
            var_type=vb_var_type, clip_denoised=False, freeze_mean=hybrid)
        if t_weights is not None:
            per_sample_vb = per_sample_vb * t_weights
        vb = per_sample_vb.mean()
        if cfg.loss_type == "rescaled_mse":
            vb = vb * (sched.num_steps / 1000.0)
        elif cfg.loss_type == "rescaled_kl":
            vb = vb * sched.num_steps

    if cfg.loss_type in ("kl", "rescaled_kl"):
        return LossTerms(total=vb, eps_mse=zero, vel_mse=zero,
                         x0_huber=zero, vb=vb)

    per_frame = ((model_out - noise) ** 2).mean(-1)
    if t_weights is not None:
        per_frame = per_frame * t_weights[:, None]
    eps_mse = masked_time_mean(per_frame, mask)
    eps_term = cfg.eps_weight * eps_mse

    pred_x0 = sched.predict_xstart_from_eps(x_t, t, model_out)

    vel_target = x_start[:, :-1] - x_start[:, 1:]
    vel_pred = pred_x0[:, :-1] - pred_x0[:, 1:]
    vel_frames = ((vel_pred - vel_target) ** 2).mean(-1)
    if t_weights is not None:
        vel_frames = vel_frames * t_weights[:, None]
    vel_mse = masked_time_mean(vel_frames, mask[:, :-1])

    if cfg.use_sem_weighting and sem_score is not None:
        w = sem_score[..., None] + 1.0
        x0_h = huber(pred_x0 * w, x_start * w, cfg.huber_beta,
                     sample_weights=t_weights)
    else:
        x0_h = huber(pred_x0, x_start, cfg.huber_beta,
                     sample_weights=t_weights)

    if vel_loss_active:
        total = eps_term + cfg.vel_weight * vel_mse + cfg.x0_weight * x0_h
    else:
        total = eps_term
    total = total + vb
    return LossTerms(total=total, eps_mse=eps_mse, vel_mse=vel_mse,
                     x0_huber=x0_h, vb=vb)
