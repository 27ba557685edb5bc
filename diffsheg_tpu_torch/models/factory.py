"""Model factory: the joint UniDiffuser or a single-branch model, channel
counts, input ablations, seeded random weights.

Counterpart of ``diffsheg_tpu/models/factory.py``.  ``ModelConfig.branch_mode``
picks the model:

  - 'joint'                  both branches and the x0 bridge (UniDiffuser)
  - 'expression_only'        face channels only
  - 'gesture_only'           pose channels only
  - 'exp_condition_gesture'  pose channels conditioned on a given
                             expression (``exp_cond``)

Every model takes the same call ``(x, t, sqrt_alphas, audio_mel,
person_id, hubert=..., word=..., emo=..., cfg_inference=...,
train=...)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from diffsheg_tpu_torch.config import ModelConfig
from diffsheg_tpu_torch.models.denoiser import MotionDenoiser
from diffsheg_tpu_torch.models.unidiffuser import (UniDiffuser,
                                                   branch_feats_dim,
                                                   branch_kwargs)


def denoised_channels(cfg: ModelConfig) -> int:
    """Channel count the active model denoises."""
    mode = cfg.branch_mode
    if mode == "expression_only":
        return cfg.expression_dim
    if mode in ("gesture_only", "exp_condition_gesture"):
        return cfg.pose_dim
    return cfg.motion_dim


class SingleBranchDenoiser(nn.Module):
    """One branch named ``encoder``: the mel projected straight to the
    audio latent (audio width ``audio_dim``, not twice it; no audio-encoder
    layer), no x0 bridge."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        mode = cfg.branch_mode
        if mode not in ("expression_only", "gesture_only",
                        "exp_condition_gesture"):
            raise ValueError(f"model.branch_mode={mode!r}")
        exp_cond_dim = (cfg.expression_dim if mode == "exp_condition_gesture"
                        else 0)
        self.encoder = MotionDenoiser(
            denoised_channels(cfg), branch_feats_dim(cfg, exp_cond_dim),
            audio_dim=cfg.audio_dim,
            use_pid_embed=not (cfg.expr_id_off and mode == "expression_only"),
            **branch_kwargs(cfg))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                sqrt_alphas: Tuple, audio_mel: torch.Tensor,
                person_id: torch.Tensor,
                hubert: Optional[torch.Tensor] = None,
                exp_cond: Optional[torch.Tensor] = None,
                word: Optional[torch.Tensor] = None,
                emo: Optional[torch.Tensor] = None,
                cfg_inference: bool = False,
                train: bool = False) -> torch.Tensor:
        """As ``UniDiffuser.forward`` (``sqrt_alphas`` unused); ``exp_cond``
        (B, T, expression_dim) is required by 'exp_condition_gesture' and
        ignored otherwise."""
        c = self.cfg
        if c.branch_mode == "exp_condition_gesture" and exp_cond is None:
            raise ValueError("exp_condition_gesture needs exp_cond input")
        return self.encoder(
            x.to(self.encoder.joint_embed.weight.dtype), t, audio_mel,
            person_id, hubert=hubert,
            exp_cond=(exp_cond if c.branch_mode == "exp_condition_gesture"
                      else None),
            word=word if c.add_text_cond else None,
            emo=emo if c.add_emo_cond else None,
            cfg_inference=cfg_inference, train=train)


def build_denoiser(cfg: ModelConfig) -> nn.Module:
    """The model ``cfg.branch_mode`` names, weights uninitialised."""
    if cfg.branch_mode == "joint":
        return UniDiffuser(cfg)
    return SingleBranchDenoiser(cfg)


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
        else:   # null_cond_emb, sequence_embedding, embedding tables
            base = torch.randn(shape, generator=gen)
        noise = perturb * torch.randn(shape, generator=gen)
        if leaf == "running_var":
            noise = noise.abs()
        p.copy_((base + noise).to(p.dtype))
    return module


def init_denoiser(cfg: ModelConfig, seed: int = 0) -> nn.Module:
    """The model of any ``branch_mode`` with seeded random weights (on the
    CPU, float32)."""
    return random_init_(build_denoiser(cfg), seed)
