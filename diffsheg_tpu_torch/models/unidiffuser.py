"""UniDiffuser: joint expression + gesture denoiser.

Counterpart of ``diffsheg_tpu/models/unidiffuser.py``: a one-layer audio
encoder over the mel features, the expression branch, and the gesture
branch conditioned on the detached expression x0 estimate; outputs in
(gesture, expression) channel order — with a learned-variance head
``[gesture mean, expression mean, gesture var, expression var]``.
:meth:`UniDiffuser.forward` is the module forward, uncached or fed by one
level of the timestep-level cache (``models/level_cache.py``); the
sampler's fast path (``models/fast_forward.py``) runs the same weights
through the fused kernels.  Both cover the configurations of
``level_cache.supports_level_cache``; the module forward uncached covers
every configuration.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from diffsheg_tpu_torch.config import ModelConfig
from diffsheg_tpu_torch.models.blocks import DiffusionTransformerLayer
from diffsheg_tpu_torch.models.denoiser import MotionDenoiser, TimeEmbedMLP
from diffsheg_tpu_torch.models.embeddings import timestep_embedding


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
    if cfg.add_text_cond:
        c += cfg.word_f
    if cfg.add_emo_cond:
        c += cfg.emotion_f
    return c


def branch_kwargs(cfg: ModelConfig) -> dict:
    """The ``MotionDenoiser`` arguments every branch of ``cfg`` shares."""
    return dict(latent_dim=cfg.latent_dim, ff_size=cfg.ff_size,
                num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                style_dim=cfg.style_dim, aud_latent_dim=cfg.aud_latent_dim,
                hubert_dim=cfg.hubert_dim,
                hubert_latent_dim=cfg.hubert_latent_dim,
                speech_mode=speech_mode(cfg),
                classifier_free=cfg.classifier_free, pe_type=cfg.pe_type,
                cond_scale=cfg.cond_scale, max_seq_len=cfg.max_seq_len,
                model_base=cfg.model_base,
                learned_variance=cfg.learned_variance,
                text=cfg.add_text_cond, emotion=cfg.add_emo_cond,
                word_f=cfg.word_f, emotion_f=cfg.emotion_f,
                word_vocab=cfg.word_vocab, num_emotions=cfg.num_emotions,
                dropout=cfg.dropout, null_cond_prob=cfg.null_cond_prob,
                remat=cfg.remat)


class UniDiffuser(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        L = cfg.latent_dim
        self.time_embed = TimeEmbedMLP(L, cfg.time_embed_dim)
        # the audio encoder is an encoder-base layer whatever model_base
        self.encoder_aud = DiffusionTransformerLayer(
            cfg.audio_dim, cfg.ff_size, cfg.num_heads, cfg.time_embed_dim,
            dropout=cfg.dropout)
        kw = dict(branch_kwargs(cfg), audio_dim=2 * cfg.audio_dim)
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
                word: Optional[torch.Tensor] = None,
                emo: Optional[torch.Tensor] = None,
                cfg_inference: bool = False, cache=None,
                train: bool = False) -> torch.Tensor:
        """x (B, T, pose+expr) noisy motion, t (B,) original-process
        timesteps, ``sqrt_alphas`` the (sqrt(1/ab), sqrt(1/ab-1)) pair at
        the level (floats or tensors broadcastable to x), audio_mel (B, T,
        audio_dim), person_id (B, style), hubert (B, T, hubert_dim) or
        None, word / emo (B, T) int labels (read when the config
        conditions on them); ``cache`` one level of a
        ``level_cache.ModelCache``; ``train`` the training forward
        (``models/denoiser.py``).  Returns the f32 (gesture ++
        expression) output: the epsilon, or with a learned-variance head
        the 2C layout of the module docstring."""
        c = self.cfg
        dtype = self.time_embed.fc1.weight.dtype
        audio_emb = None     # with the cache, the branches read projections
        if cache is None:
            emb = self.time_embed(
                timestep_embedding(t, c.latent_dim).to(dtype))
            mel = audio_mel.to(dtype)
            audio_feat = self.encoder_aud(mel, None, emb, train=train)
            audio_emb = torch.cat([mel, audio_feat], dim=-1)

        labels = dict(word=word if c.add_text_cond else None,
                      emo=emo if c.add_emo_cond else None)
        gesture, expression = x[..., :c.pose_dim], x[..., c.pose_dim:]
        exp_out = self.encoder_exp(
            expression, t, audio_emb, person_id, hubert=hubert,
            cfg_inference=cfg_inference,
            cache=None if cache is None else cache.exp, train=train, **labels)
        # with a learned-variance head each branch emits mean ++ raw var
        exp_eps = exp_out[..., :c.expression_dim]
        sr, srm1 = sqrt_alphas
        expr_x0 = (sr * expression - srm1 * exp_eps).detach()   # x0 bridge
        ges_out = self.encoder_ges(
            gesture, t, audio_emb, person_id, hubert=hubert,
            exp_cond=expr_x0, cfg_inference=cfg_inference,
            cache=None if cache is None else cache.ges, train=train, **labels)
        if c.learned_variance:
            return torch.cat([ges_out[..., :c.pose_dim], exp_eps,
                              ges_out[..., c.pose_dim:],
                              exp_out[..., c.expression_dim:]], dim=-1)
        return torch.cat([ges_out, exp_eps], dim=-1)


def init_unidiffuser(cfg: ModelConfig, seed: int = 0) -> UniDiffuser:
    """A UniDiffuser with seeded random weights (on the CPU, float32)."""
    from diffsheg_tpu_torch.models.factory import random_init_
    return random_init_(UniDiffuser(cfg), seed)
