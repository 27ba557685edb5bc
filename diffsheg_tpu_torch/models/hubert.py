"""HuBERT encoder: the hubert-large-ls960-ft and wav2vec2-base layouts.

Counterpart of ``diffsheg_tpu/models/hubert.py``.  HuBERT-large: a 7-layer
conv feature extractor with per-layer LayerNorm, LN + projection, a
grouped-conv positional embedding, 24 pre-LN transformer layers (16
heads, FFN 4096), final LayerNorm.  The wav2vec2-base / HuBERT-base family
(:func:`wav2vec2_base_config`): bias-free convs with a per-channel
GroupNorm over time on the first conv only, the encoder LayerNorm after
the positional conv (none at the end) and post-LN layers.  Attribute
names follow the Flax parameter tree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: tuple = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    conv_norm: str = "layer"        # {"layer", "group_first"}
    conv_bias: bool = True          # wav2vec2-base convs are bias-free
    stable_layer_norm: bool = True  # True: pre-LN (hubert-large); False:
                                    # post-LN (wav2vec2-base)
    dtype: str = "float32"


def wav2vec2_base_config() -> HubertConfig:
    """facebook/wav2vec2-base-960h geometry (HuBERT-base too): 768-d, 12
    post-LN layers, group-norm first conv, bias-free convs."""
    return HubertConfig(
        hidden_size=768, num_layers=12, num_heads=12,
        intermediate_size=3072, conv_norm="group_first",
        stable_layer_norm=False, conv_bias=False)


def gelu(x):
    return F.gelu(x, approximate="none")


class ConvFeatureExtractor(nn.Module):
    """Strided conv stack, each conv followed by GELU: with a LayerNorm
    before it on every conv ('layer'), or a GroupNorm on the first conv
    only ('group_first')."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        self.group_first = cfg.conv_norm == "group_first"
        c_in = 1
        for i, (c, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel,
                                          cfg.conv_stride)):
            self.add_module(f"conv_{i}", nn.Conv1d(c_in, c, k, stride=s,
                                                   bias=cfg.conv_bias))
            if not self.group_first:
                self.add_module(f"ln_{i}", nn.LayerNorm(c, eps=LN_EPS))
            c_in = c
        if self.group_first:
            self.gn_scale = nn.Parameter(torch.ones(cfg.conv_dim[0]))
            self.gn_bias = nn.Parameter(torch.zeros(cfg.conv_dim[0]))

    def forward(self, x):                       # (B, N) -> (B, T, C)
        h = x[:, None].to(self.conv_0.weight.dtype)
        for i in range(len(self.cfg.conv_dim)):
            h = getattr(self, f"conv_{i}")(h)   # (B, C, T)
            if not self.group_first:
                h = getattr(self, f"ln_{i}")(h.transpose(1, 2)).transpose(1, 2)
            elif i == 0:
                # GroupNorm(C groups, C channels): each channel over all
                # time steps, a padded row's pad samples included
                mean = h.mean(-1, keepdim=True)
                var = h.var(-1, keepdim=True, unbiased=False)
                h = (h - mean) * torch.rsqrt(var + LN_EPS)
                h = h * self.gn_scale[:, None] + self.gn_bias[:, None]
            h = gelu(h)
        return h.transpose(1, 2)


class PosConvEmbed(nn.Module):
    """Grouped conv, 'same' padding k//2 each side, one frame trimmed when
    the kernel is even."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.k = k
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k,
                              padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)

    def forward(self, x):                       # (B, T, H)
        h = self.conv(x.transpose(1, 2)).transpose(1, 2)
        if self.k % 2 == 0:
            h = h[:, :-1]
        return gelu(h)


class HubertSelfAttention(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        H = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(H, H)
        self.k_proj = nn.Linear(H, H)
        self.v_proj = nn.Linear(H, H)
        self.out_proj = nn.Linear(H, H)

    def forward(self, x, frame_mask=None):
        B, T, H = x.shape
        nh = self.num_heads
        hd = H // nh
        q = (self.q_proj(x) * (hd ** -0.5)).reshape(B, T, nh, hd)
        k = self.k_proj(x).reshape(B, T, nh, hd)
        v = self.v_proj(x).reshape(B, T, nh, hd)
        # logits and P.V accumulate in f32, probabilities in x's dtype
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        if frame_mask is not None:
            # padded frames get zero weight: valid frames equal a
            # natural-length forward
            logits = logits.masked_fill(~frame_mask[:, None, None, :], -1e9)
        probs = logits.softmax(-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(x.dtype)
        return self.out_proj(out.reshape(B, T, H))


class HubertEncoderLayer(nn.Module):
    """Transformer layer: pre-LN (``stable_layer_norm``, hubert-large) or
    post-LN (wav2vec2-base)."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.pre_ln = cfg.stable_layer_norm
        self.attn = HubertSelfAttention(cfg)
        self.attn_ln = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.ffn_ln = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x, frame_mask=None):
        if self.pre_ln:
            x = x + self.attn(self.attn_ln(x), frame_mask)
            return x + self.fc2(gelu(self.fc1(self.ffn_ln(x))))
        x = self.attn_ln(x + self.attn(x, frame_mask))
        return self.ffn_ln(x + self.fc2(gelu(self.fc1(x))))


class HubertModel(nn.Module):
    """Waveform (B, N) at 16 kHz -> hidden states (B, T, H),
    T = (N - 400) // 320 + 1.  ``frame_mask`` (B, T) bool marks valid frames
    of right-padded rows: pad frames are zeroed before the positional conv
    and excluded from attention.  The encoder LayerNorm ``final_ln`` comes
    after the layers (pre-LN) or before them, after the positional conv
    (post-LN)."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = ConvFeatureExtractor(cfg)
        self.feat_proj_ln = nn.LayerNorm(cfg.conv_dim[-1], eps=LN_EPS)
        self.feat_proj = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)
        self.pos_conv = PosConvEmbed(cfg)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", HubertEncoderLayer(cfg))
        self.final_ln = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)

    def forward(self, x, frame_mask: Optional[torch.Tensor] = None):
        h = self.feat_proj(self.feat_proj_ln(self.feature_extractor(x)))
        if frame_mask is not None:
            h = h * frame_mask[..., None].to(h.dtype)
        h = h + self.pos_conv(h)
        if not self.cfg.stable_layer_norm:
            h = self.final_ln(h)
        for i in range(self.cfg.num_layers):
            h = getattr(self, f"layer_{i}")(h, frame_mask)
        return self.final_ln(h) if self.cfg.stable_layer_norm else h


def normalize_waveform(x: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Zero-mean / unit-variance per row (Wav2Vec2Processor)."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps)
