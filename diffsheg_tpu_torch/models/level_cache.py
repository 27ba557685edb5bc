"""Timestep-level conditioning cache for the sampler loop.

Counterpart of ``diffsheg_tpu/models/level_cache.py``.  Everything in the
denoiser that does not depend on the sample ``x`` — time/speaker
embeddings and all stylization modulations (per level), the one-layer
audio encoder and the branch audio projections (per level and window),
the HuBERT encoders (per window) — is computed once, before the sampler
loop, by applying the same modules to their own weights:

  - :func:`build_static_cache` — modulations, once per stream;
  - :func:`build_audio_cache` — audio encoder + projections, for all
    windows of a stream in one batch;
  - :func:`combine` / :func:`gather_level` — the per-window, per-step
    views the fast path and the module forward consume.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.nn import functional as F

from diffsheg_tpu_torch.config import ModelConfig
from diffsheg_tpu_torch.models.denoiser import BranchCache
from diffsheg_tpu_torch.models.embeddings import timestep_embedding
from diffsheg_tpu_torch.models.unidiffuser import UniDiffuser, speech_mode


def supports_level_cache(cfg: ModelConfig) -> bool:
    """The cache covers the joint encoder-base model without text or
    emotion conditioning or a learned-variance head; every other
    configuration runs the uncached module forward, as in JAX (the decoder
    cross-attends to the raw condition, and a learned-variance head changes
    the output width and the x0 bridge)."""
    return (cfg.branch_mode == "joint" and not cfg.add_text_cond
            and not cfg.add_emo_cond
            and cfg.model_base == "transformer_encoder"
            and not cfg.learned_variance)


class ModelCache(NamedTuple):
    exp: BranchCache
    ges: BranchCache


class StaticCache(NamedTuple):
    exp_mods: torch.Tensor               # (Lv, num_layers, 2, B, 2*latent)
    ges_mods: torch.Tensor


class AudioCache(NamedTuple):
    """A leading window axis K may precede every field."""

    exp_audio: torch.Tensor              # ([K,] Lv, B, T, aud_latent)
    ges_audio: torch.Tensor
    exp_hub: Optional[torch.Tensor]      # ([K,] B, T, hubert_latent)
    ges_hub: Optional[torch.Tensor]


def _dtype(model: UniDiffuser) -> torch.dtype:
    return model.time_embed.fc1.weight.dtype


def _branch_mods(model, branch, use_pid: bool, t_levels, pid):
    cfg = model.cfg
    dtype = _dtype(model)
    Lv, B, E = t_levels.shape[0], pid.shape[0], cfg.time_embed_dim
    temb = branch.time_embed(
        timestep_embedding(t_levels, cfg.latent_dim).to(dtype))     # (Lv, E)
    emb = temb[:, None].expand(Lv, B, E)
    if use_pid:
        emb = emb + branch.pid_embed(pid.to(dtype))[None]
    s = F.silu(emb).reshape(Lv * B, E)
    mods = torch.stack([
        torch.stack([layer.sa_block.proj_out.emb_proj(s),
                     layer.ffn.proj_out.emb_proj(s)])
        for layer in branch.layers])                                 # (n, 2, Lv*B, 2L)
    mods = mods.reshape(cfg.num_layers, 2, Lv, B, 2 * cfg.latent_dim)
    return mods.permute(2, 0, 1, 3, 4).contiguous()                  # (Lv, n, 2, B, 2L)


def _branch_hubert(model, branch, hubert):
    if hubert is None:
        return None
    mode = speech_mode(model.cfg)
    h = hubert.to(_dtype(model))
    if mode in ("conv", "linear"):
        return branch.hubert_encoder(h)
    return h


@torch.no_grad()
def build_static_cache(model: UniDiffuser, t_levels: torch.Tensor,
                       pid: torch.Tensor) -> StaticCache:
    """Per-level stylization modulations for both branches.
    ``t_levels`` (Lv,) original-process timesteps; ``pid`` (B, style)."""
    return StaticCache(
        exp_mods=_branch_mods(model, model.encoder_exp,
                              not model.cfg.expr_id_off, t_levels, pid),
        ges_mods=_branch_mods(model, model.encoder_ges, True, t_levels, pid))


@torch.no_grad()
def build_audio_cache(model: UniDiffuser, t_levels: torch.Tensor,
                      mel: torch.Tensor,
                      hubert: Optional[torch.Tensor]) -> AudioCache:
    """Audio-encoder outputs and branch projections per level.  ``mel``
    (N, T, audio_dim); N is a free batch axis (a streamer folds all
    windows into it)."""
    cfg = model.cfg
    dtype = _dtype(model)
    Lv = t_levels.shape[0]
    N, T, A = mel.shape
    top_emb = model.time_embed(
        timestep_embedding(t_levels, cfg.latent_dim).to(dtype))      # (Lv, E)
    mel_rep = mel.to(dtype)[None].expand(Lv, N, T, A).reshape(Lv * N, T, A)
    emb_rep = top_emb.repeat_interleave(N, dim=0)                    # (Lv*N, E)
    audio_feat = model.encoder_aud(mel_rep, None, emb_rep)
    audio_emb = torch.cat([mel_rep, audio_feat], dim=-1)

    def proj(branch):
        return branch.audio_proj(audio_emb).reshape(Lv, N, T,
                                                    cfg.aud_latent_dim)

    return AudioCache(
        exp_audio=proj(model.encoder_exp),
        ges_audio=proj(model.encoder_ges),
        exp_hub=_branch_hubert(model, model.encoder_exp, hubert),
        ges_hub=_branch_hubert(model, model.encoder_ges, hubert))


def combine(static: StaticCache, audio: AudioCache) -> ModelCache:
    """The per-window cache the denoiser consumes."""
    return ModelCache(
        exp=BranchCache(static.exp_mods, audio.exp_audio, audio.exp_hub),
        ges=BranchCache(static.ges_mods, audio.ges_audio, audio.ges_hub))


def build_level_cache(model: UniDiffuser, t_levels, mel, pid,
                      hubert) -> ModelCache:
    """Single-window composition of the two cache functions."""
    return combine(build_static_cache(model, t_levels, pid),
                   build_audio_cache(model, t_levels, mel, hubert))


def gather_level(cache: ModelCache, level: int) -> ModelCache:
    """One timestep level of a leveled cache."""

    def g(b: BranchCache) -> BranchCache:
        return BranchCache(b.mods[level], b.audio_lat[level], b.hubert_lat)

    return ModelCache(g(cache.exp), g(cache.ges))
