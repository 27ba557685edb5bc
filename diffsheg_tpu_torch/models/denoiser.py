"""Per-branch denoiser modules (expression or gesture).

Counterpart of ``diffsheg_tpu/models/denoiser.py``: ``TimeEmbedMLP``,
``HubertConvEncoder`` and the branch's parameter holder
``MotionDenoiser``.  The port runs a branch through the timestep-level
cache (``models/level_cache.py``) and the fused fast path
(``models/fast_forward.py``); the uncached forward is not ported yet.
Attribute names follow the Flax parameter tree (``layer_0`` ...).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn
from torch.nn import functional as F

from diffsheg_tpu_torch.models.blocks import DiffusionTransformerLayer, gelu_exact


class TimeEmbedMLP(nn.Module):
    """Dense -> SiLU -> Dense."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, out_dim)
        self.fc2 = nn.Linear(out_dim, out_dim)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))


class BatchNorm(nn.Module):
    """Inference BatchNorm over the last (channel) axis:
    ``(x - mean) * rsqrt(var + eps) * weight + bias``."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        return ((x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
                * self.weight + self.bias)


class HubertConvEncoder(nn.Module):
    """HuBERT features -> ``out_dim``: Conv(k3) + BN + GELU + Conv(k3),
    channel-last in and out."""

    def __init__(self, in_dim: int, out_dim: int = 128):
        super().__init__()
        self.conv1 = nn.Conv1d(in_dim, out_dim, 3, padding=1, bias=False)
        self.bn = BatchNorm(out_dim)
        self.conv2 = nn.Conv1d(out_dim, out_dim, 3, padding=1, bias=False)

    def forward(self, x):                         # (B, T, C)
        h = self.conv1(x.transpose(1, 2)).transpose(1, 2)
        h = gelu_exact(self.bn(h))
        return self.conv2(h.transpose(1, 2)).transpose(1, 2)


class MotionDenoiser(nn.Module):
    """One branch's parameters: time (+speaker) embedding, speech-feature
    encoder, audio projection, joint embedding, ``num_layers`` transformer
    layers, output head, and the classifier-free null condition.

    ``feats_dim`` is the per-layer concat width: latent + audio latent
    (+ encoded HuBERT) (+ expression condition on the gesture branch).
    """

    def __init__(self, input_feats: int, feats_dim: int, *, latent_dim: int,
                 ff_size: int, num_layers: int, num_heads: int,
                 style_dim: int, audio_dim: int, aud_latent_dim: int,
                 hubert_dim: int, hubert_latent_dim: int, speech_mode: str,
                 use_pid_embed: bool, classifier_free: bool, pe_type: str,
                 max_frames: int = 240):
        super().__init__()
        E = 4 * latent_dim
        self.num_layers = num_layers
        self.time_embed = TimeEmbedMLP(latent_dim, E)
        if use_pid_embed:
            self.pid_embed = TimeEmbedMLP(style_dim, E)
        if speech_mode == "conv":
            self.hubert_encoder = HubertConvEncoder(hubert_dim, hubert_latent_dim)
        elif speech_mode == "linear":
            self.hubert_encoder = nn.Linear(hubert_dim, hubert_latent_dim)
        self.audio_proj = nn.Linear(audio_dim, aud_latent_dim)
        self.joint_embed = nn.Linear(input_feats, latent_dim)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DiffusionTransformerLayer(
                latent_dim, ff_size, num_heads, E, feats_dim))
        self.out = nn.Linear(latent_dim, input_feats)
        if classifier_free:
            self.null_cond_emb = nn.Parameter(torch.zeros(1, feats_dim))
        if pe_type == "learnable":
            self.sequence_embedding = nn.Parameter(
                torch.zeros(max_frames, latent_dim))

    @property
    def layers(self) -> List[DiffusionTransformerLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]
