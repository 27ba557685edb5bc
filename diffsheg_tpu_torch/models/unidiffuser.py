"""UniDiffuser: joint expression + gesture denoiser.

Counterpart of ``diffsheg_tpu/models/unidiffuser.py``: a one-layer audio
encoder over the mel features, the expression branch, and the gesture
branch conditioned on the detached expression x0 estimate; outputs in
(gesture, expression) channel order.  :meth:`UniDiffuser.forward` is the
module forward, uncached or fed by one level of the timestep-level cache
(``models/level_cache.py``); the sampler's fast path
(``models/fast_forward.py``) runs the same weights through the fused
kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from diffsheg_tpu_torch.config import ModelConfig
from diffsheg_tpu_torch.models.blocks import DiffusionTransformerLayer
from diffsheg_tpu_torch.models.denoiser import MotionDenoiser, TimeEmbedMLP
from diffsheg_tpu_torch.models.embeddings import timestep_embedding
from diffsheg_tpu_torch.models.factory import random_init_


def speech_mode(cfg: ModelConfig) -> str:
    """How a branch consumes HuBERT features: 'conv', 'linear', 'raw', or
    'none' without HuBERT."""
    if not cfg.add_hubert:
        return "none"
    return cfg.speech_encoder if cfg.encode_hubert else "raw"


def branch_feats_dim(cfg: ModelConfig, exp_cond_dim: int) -> int:
    """The per-layer concat width (latent ++ condition) of a branch."""
    c = cfg.latent_dim + cfg.aud_latent_dim + exp_cond_dim
    mode = speech_mode(cfg)
    if mode == "raw":
        c += cfg.hubert_dim
    elif mode != "none":
        c += cfg.hubert_latent_dim
    return c


def supports_fast_path(cfg: ModelConfig) -> bool:
    """The configurations the port runs: the joint encoder model without
    text/emotion conditioning or a learned-variance head."""
    return (cfg.branch_mode == "joint" and not cfg.add_text_cond
            and not cfg.add_emo_cond
            and cfg.model_base == "transformer_encoder"
            and not cfg.learned_variance)


class UniDiffuser(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if not supports_fast_path(cfg):
            raise NotImplementedError(
                "the port covers the joint transformer_encoder UniDiffuser "
                "without text/emotion conditioning or learned variance")
        self.cfg = cfg
        L = cfg.latent_dim
        self.time_embed = TimeEmbedMLP(L, cfg.time_embed_dim)
        self.encoder_aud = DiffusionTransformerLayer(
            cfg.audio_dim, cfg.ff_size, cfg.num_heads, cfg.time_embed_dim)
        kw = dict(latent_dim=L, ff_size=cfg.ff_size,
                  num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                  style_dim=cfg.style_dim, audio_dim=2 * cfg.audio_dim,
                  aud_latent_dim=cfg.aud_latent_dim,
                  hubert_dim=cfg.hubert_dim,
                  hubert_latent_dim=cfg.hubert_latent_dim,
                  speech_mode=speech_mode(cfg),
                  classifier_free=cfg.classifier_free, pe_type=cfg.pe_type,
                  cond_scale=cfg.cond_scale, max_seq_len=cfg.max_seq_len)
        self.encoder_exp = MotionDenoiser(
            cfg.expression_dim, branch_feats_dim(cfg, 0),
            use_pid_embed=not cfg.expr_id_off, **kw)
        self.encoder_ges = MotionDenoiser(
            cfg.pose_dim, branch_feats_dim(cfg, cfg.expression_dim),
            use_pid_embed=True, **kw)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                sqrt_alphas: Tuple, audio_mel: torch.Tensor,
                person_id: torch.Tensor,
                hubert: Optional[torch.Tensor] = None,
                cfg_inference: bool = False, cache=None) -> torch.Tensor:
        """x (B, T, pose+expr) noisy motion, t (B,) original-process
        timesteps, ``sqrt_alphas`` the (sqrt(1/ab), sqrt(1/ab-1)) pair at
        the level (floats or tensors broadcastable to x), audio_mel (B, T,
        audio_dim), person_id (B, style), hubert (B, T, hubert_dim) or
        None; ``cache`` one level of a ``level_cache.ModelCache``.
        Returns the f32 (gesture ++ expression) epsilon."""
        c = self.cfg
        dtype = self.time_embed.fc1.weight.dtype
        audio_emb = None     # with the cache, the branches read projections
        if cache is None:
            emb = self.time_embed(
                timestep_embedding(t, c.latent_dim).to(dtype))
            mel = audio_mel.to(dtype)
            audio_feat = self.encoder_aud(mel, None, emb)
            audio_emb = torch.cat([mel, audio_feat], dim=-1)

        gesture, expression = x[..., :c.pose_dim], x[..., c.pose_dim:]
        exp_eps = self.encoder_exp(
            expression, t, audio_emb, person_id, hubert=hubert,
            cfg_inference=cfg_inference,
            cache=None if cache is None else cache.exp)
        sr, srm1 = sqrt_alphas
        expr_x0 = (sr * expression - srm1 * exp_eps).detach()   # x0 bridge
        ges_eps = self.encoder_ges(
            gesture, t, audio_emb, person_id, hubert=hubert,
            exp_cond=expr_x0, cfg_inference=cfg_inference,
            cache=None if cache is None else cache.ges)
        return torch.cat([ges_eps, exp_eps], dim=-1)


def init_unidiffuser(cfg: ModelConfig, seed: int = 0) -> UniDiffuser:
    """A UniDiffuser with seeded random weights (on the CPU, float32)."""
    return random_init_(UniDiffuser(cfg), seed)
