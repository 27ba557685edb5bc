"""HuBERT encoder: the hubert-large-ls960-ft, wav2vec2-base and WavLM-Large
layouts.

Counterpart of ``diffsheg_tpu/models/hubert.py``.  HuBERT-large: a 7-layer
conv feature extractor with per-layer LayerNorm, LN + projection, a
grouped-conv positional embedding, 24 pre-LN transformer layers (16
heads, FFN 4096), final LayerNorm.  The wav2vec2-base / HuBERT-base family
(:func:`wav2vec2_base_config`): bias-free convs with a per-channel
GroupNorm over time on the first conv only, the encoder LayerNorm after
the positional conv (none at the end) and post-LN layers.  WavLM-Large
(:func:`wavlm_large_config`; Chen et al., arXiv:2110.13900, HuggingFace's
``WavLMAttention``): HuBERT-large's geometry with bias-free convs and
attention that adds a gated relative-position bias to its logits
(:class:`GatedRelPosAttention`; the JAX package has no counterpart).
The dense layers are ``ops/products.py``'s ``Dense``: ``nn.Linear`` whose
f32 products on the card, at the route's sizes, run in split TF32 on the
tensor cores.  Attribute names follow the Flax parameter tree.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from diffsheg_tpu_torch.ops.products import Dense

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
    # relative-position buckets of WavLM's gated attention bias (0: no
    # bias, the HuBERT / wav2vec2 attention)
    rel_pos_buckets: int = 0


def hubert_large_config() -> HubertConfig:
    """HuBERT-large geometry: the defaults, 1024-d, 24 pre-LN layers."""
    return HubertConfig()


def wav2vec2_base_config() -> HubertConfig:
    """facebook/wav2vec2-base-960h geometry (HuBERT-base too): 768-d, 12
    post-LN layers, group-norm first conv, bias-free convs."""
    return HubertConfig(
        hidden_size=768, num_layers=12, num_heads=12,
        intermediate_size=3072, conv_norm="group_first",
        stable_layer_norm=False, conv_bias=False)


def wavlm_large_config() -> HubertConfig:
    """microsoft/wavlm-large geometry: HuBERT-large's widths, bias-free
    convs, 320 relative-position buckets up to :data:`REL_POS_MAX_DISTANCE`.
    """
    return HubertConfig(conv_bias=False, rel_pos_buckets=320)


# WavLM's ``max_bucket_distance``: the distance past which a key's bucket
# stops growing (with its 320 buckets, the last log bucket)
REL_POS_MAX_DISTANCE = 800

# the encoders the entry points build by name (``--speech-encoder``)
SPEECH_ENCODERS = {"hubert-large": hubert_large_config,
                   "wavlm-large": wavlm_large_config,
                   "wav2vec2-base": wav2vec2_base_config}


def speech_encoder_config(name: str) -> HubertConfig:
    try:
        return SPEECH_ENCODERS[name]()
    except KeyError:
        raise ValueError(f"speech encoder {name!r}: valid encoders are "
                         f"{', '.join(SPEECH_ENCODERS)}") from None


# attention calls by kind since the process started ('plain': HuBERT's,
# 'gated_bias': WavLM's), counted where each layer's attention runs
attention_calls: collections.Counter = collections.Counter()


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
    kind = "plain"

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        H = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q_proj = Dense(H, H)
        self.k_proj = Dense(H, H)
        self.v_proj = Dense(H, H)
        self.out_proj = Dense(H, H)

    def forward(self, x, frame_mask=None, position_bias=None):
        attention_calls[self.kind] += 1
        B, T, H = x.shape
        nh = self.num_heads
        hd = H // nh
        q = (self.q_proj(x) * (hd ** -0.5)).reshape(B, T, nh, hd)
        k = self.k_proj(x).reshape(B, T, nh, hd)
        v = self.v_proj(x).reshape(B, T, nh, hd)
        # logits and P.V accumulate in f32, probabilities in x's dtype
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        if position_bias is not None:
            logits = logits + self.bias(x, position_bias)
        if frame_mask is not None:
            # padded frames get zero weight: valid frames equal a
            # natural-length forward
            logits = logits.masked_fill(~frame_mask[:, None, None, :], -1e9)
        probs = logits.softmax(-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(x.dtype)
        return self.out_proj(out.reshape(B, T, H))


def relative_position_buckets(T: int, num_buckets: int,
                              max_distance: int = REL_POS_MAX_DISTANCE,
                              device=None) -> torch.Tensor:
    """(T, T) long: the bucket of key j seen from query i, r = j - i (HF
    ``WavLMAttention._relative_positions_bucket``).  Each sign takes half
    of the buckets (r > 0 the upper half); |r| under a quarter of them is
    its own bucket, past that ``exact + log(|r| / exact) / log(max_distance
    / exact) * (half - exact)`` in f32, truncated and capped at the half's
    last bucket."""
    half = num_buckets // 2
    exact = half // 2
    pos = torch.arange(T, device=device)
    r = pos[None, :] - pos[:, None]
    a = r.abs()
    far = (exact + torch.log(a.clamp(min=1).float() / exact)
           / math.log(max_distance / exact) * (half - exact)).long()
    return ((r > 0).long() * half
            + torch.where(a < exact, a, far.clamp(max=half - 1)))


class GatedRelPosAttention(HubertSelfAttention):
    """WavLM's attention: HuBERT's, with ``gate * B[h, i, j]`` added to the
    logits.  ``B`` (heads, T, T) is layer 0's ``rel_attn_embed`` looked up
    at each pair's bucket, made once a forward (:meth:`position_bias`) and
    handed to every layer.  Each layer gates it per query and head from
    its own input x (after the pre-LN) cut into heads: the head's 8
    ``gru_rel_pos_linear`` outputs summed in two groups of 4 and put
    through a sigmoid, (a, b), give ``a * (b * c_h - 1) + 2`` with
    ``c_h`` the head's ``gru_rel_pos_const``."""

    kind = "gated_bias"

    def __init__(self, cfg: HubertConfig, has_embed: bool):
        super().__init__(cfg)
        self.cfg = cfg
        if has_embed:
            self.rel_attn_embed = nn.Embedding(cfg.rel_pos_buckets,
                                               cfg.num_heads)
        self.gru_rel_pos_linear = Dense(cfg.hidden_size // cfg.num_heads, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(cfg.num_heads))

    def position_bias(self, T: int) -> torch.Tensor:
        """(heads, T, T) f32 bias of a sequence of T frames."""
        table = self.rel_attn_embed.weight
        b = relative_position_buckets(T, self.cfg.rel_pos_buckets,
                                      device=table.device)
        return table.float()[b].permute(2, 0, 1)

    def bias(self, x, position_bias):
        B, T, H = x.shape
        nh = self.num_heads
        g = self.gru_rel_pos_linear(x.reshape(B, T, nh, H // nh)).float()
        a, b = torch.sigmoid(g.reshape(B, T, nh, 2, 4).sum(-1)).unbind(-1)
        gate = a * (b * self.gru_rel_pos_const.float() - 1.0) + 2.0
        return gate.transpose(1, 2)[..., None] * position_bias


class HubertEncoderLayer(nn.Module):
    """Transformer layer: pre-LN (``stable_layer_norm``, hubert-large) or
    post-LN (wav2vec2-base)."""

    def __init__(self, cfg: HubertConfig, index: int = 0):
        super().__init__()
        self.pre_ln = cfg.stable_layer_norm
        self.attn = (GatedRelPosAttention(cfg, has_embed=index == 0)
                     if cfg.rel_pos_buckets else HubertSelfAttention(cfg))
        self.attn_ln = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.ffn_ln = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x, frame_mask=None, position_bias=None):
        if self.pre_ln:
            x = x + self.attn(self.attn_ln(x), frame_mask, position_bias)
            return x + self.fc2(gelu(self.fc1(self.ffn_ln(x))))
        x = self.attn_ln(x + self.attn(x, frame_mask, position_bias))
        return self.ffn_ln(x + self.fc2(gelu(self.fc1(x))))


class HubertModel(nn.Module):
    """Waveform (B, N) at 16 kHz -> hidden states (B, T, H),
    T = (N - 400) // 320 + 1.  ``frame_mask`` (B, T) bool marks valid frames
    of right-padded rows: pad frames are zeroed before the positional conv
    and excluded from attention.  The encoder LayerNorm ``final_ln`` comes
    after the layers (pre-LN) or before them, after the positional conv
    (post-LN).  With ``rel_pos_buckets`` (WavLM) the relative-position bias
    of the sequence at hand is made once and handed through the layers."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = ConvFeatureExtractor(cfg)
        self.feat_proj_ln = nn.LayerNorm(cfg.conv_dim[-1], eps=LN_EPS)
        self.feat_proj = Dense(cfg.conv_dim[-1], cfg.hidden_size)
        self.pos_conv = PosConvEmbed(cfg)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", HubertEncoderLayer(cfg, i))
        self.final_ln = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)

    def forward(self, x, frame_mask: Optional[torch.Tensor] = None):
        h = self.feat_proj(self.feat_proj_ln(self.feature_extractor(x)))
        if frame_mask is not None:
            h = h * frame_mask[..., None].to(h.dtype)
        h = h + self.pos_conv(h)
        if not self.cfg.stable_layer_norm:
            h = self.final_ln(h)
        bias = (self.layer_0.attn.position_bias(h.shape[1])
                if self.cfg.rel_pos_buckets else None)
        for i in range(self.cfg.num_layers):
            h = getattr(self, f"layer_{i}")(h, frame_mask, bias)
        return self.final_ln(h) if self.cfg.stable_layer_norm else h


def normalize_waveform(x: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Zero-mean / unit-variance per row (Wav2Vec2Processor)."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps)
