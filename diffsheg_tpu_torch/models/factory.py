"""Model helpers: channel counts, input ablations, seeded random weights.

Counterpart of the serving part of ``diffsheg_tpu/models/factory.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from diffsheg_tpu_torch.config import ModelConfig


def denoised_channels(cfg: ModelConfig) -> int:
    """Channel count the active model denoises."""
    mode = cfg.branch_mode
    if mode == "expression_only":
        return cfg.expression_dim
    if mode in ("gesture_only", "exp_condition_gesture"):
        return cfg.pose_dim
    return cfg.motion_dim


def ablate_inputs(cfg: ModelConfig, mel, pid):
    """Input-level ablations (remove_audio / use_single_style /
    remove_style)."""
    if cfg.remove_audio and mel is not None:
        mel = torch.zeros_like(mel)
    if pid is not None:
        if cfg.use_single_style:
            pid = torch.zeros_like(pid)
            pid[..., 0] = 1.0
        if cfg.remove_style or cfg.no_style:
            pid = torch.zeros_like(pid)
    return mel, pid


# zero-initialised in the reference (and Flax) model: the stylization
# output projections and the FFN's second linear, so each block starts as
# the identity
ZERO_INIT = ("proj_out.out_proj.weight", "proj_out.out_proj.bias",
             "ffn.linear2.weight", "ffn.linear2.bias")


@torch.no_grad()
def random_init_(module: nn.Module, seed: int, perturb: float = 0.02) -> nn.Module:
    """Fill every parameter and buffer from a seeded generator the way the
    Flax model initialises: weight matrices and kernels N(0, 1/fan_in),
    biases 0, norm scales 1, free embeddings N(0, 1), BatchNorm statistics
    mean 0 / var 1, zero output projections (``ZERO_INIT``) — then
    perturb every leaf with ``perturb * N(0, 1)``, so no projection is zero
    and no norm is the identity."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in list(module.named_parameters()) + list(module.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        shape = p.shape
        if name.endswith(ZERO_INIT):
            base = torch.zeros(shape)
        elif leaf == "weight" and p.dim() >= 2:
            base = torch.randn(shape, generator=gen) / p[0].numel() ** 0.5
        elif leaf in ("weight", "gn_scale", "running_var"):
            base = torch.ones(shape)
        elif leaf in ("bias", "gn_bias", "running_mean"):
            base = torch.zeros(shape)
        else:   # null_cond_emb, sequence_embedding
            base = torch.randn(shape, generator=gen)
        noise = perturb * torch.randn(shape, generator=gen)
        if leaf == "running_var":
            noise = noise.abs()
        p.copy_((base + noise).to(p.dtype))
    return module
