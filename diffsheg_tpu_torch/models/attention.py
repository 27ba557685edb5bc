"""Linear (efficient) temporal self- and cross-attention.

Counterpart of ``diffsheg_tpu/models/attention.py``: Q is softmax-normalised
over the per-head features, K over time, and

    ctx  = sum_t K[t] (x) V[t]          # (B, H, hd, hd)
    y[t] = Q[t] @ ctx                   # (B, T, H, hd)

with the reference's masking: the key logits get ``(1 - mask) * -1e6``
before the time softmax and the values are zeroed outside the mask.  The
cross-attention (``model_base='transformer_decoder'``) takes its queries
from the normed latent and its keys and values from a separately normed
memory, unmasked.  The core goes through
``ops/linear_attention.py::linear_attention``: the CUDA kernel for f32
activations on the card, the composition otherwise.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch
from torch import nn

from diffsheg_tpu_torch.ops.linear_attention import (  # noqa: F401
    linear_attention, linear_attention_core, linear_attention_reference)
from diffsheg_tpu_torch.ops.products import Dense

if TYPE_CHECKING:    # blocks.py imports this module
    from diffsheg_tpu_torch.models.blocks import Train

LN_EPS = 1e-5


class LinearTemporalSelfAttention(nn.Module):
    """LN -> Q/K/V -> masked linear attention -> stylization, plus the
    residual.  ``src_mask`` (B, T, 1) of ones and zeros, or None for all
    ones; ``mod`` (B, 2L) a precomputed stylization modulation."""

    def __init__(self, latent_dim: int, num_heads: int, time_embed_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        from diffsheg_tpu_torch.models.blocks import StylizationBlock
        self.num_heads = num_heads
        self.norm = nn.LayerNorm(latent_dim, eps=LN_EPS)
        self.query = Dense(latent_dim, latent_dim)
        self.key = Dense(latent_dim, latent_dim)
        self.value = Dense(latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dropout)

    def forward(self, x, emb, src_mask: Optional[torch.Tensor] = None,
                mod: Optional[torch.Tensor] = None, train: Train = False):
        xn = self.norm(x)
        query, key, value = self.query(xn), self.key(xn), self.value(xn)
        if src_mask is not None:
            mask = src_mask.to(query.dtype)
            key = key + (1.0 - mask) * -1_000_000.0
            value = value * mask
        y = linear_attention(query, key, value, self.num_heads)
        return x + self.proj_out(y, emb, mod, train=train)


class LinearTemporalCrossAttention(nn.Module):
    """LN(x) -> Q, LN(xf) -> K/V over the memory ``xf`` (B, T, cond_dim)
    -> unmasked linear attention -> stylization, plus the residual."""

    def __init__(self, latent_dim: int, num_heads: int, time_embed_dim: int,
                 cond_dim: int, dropout: float = 0.0):
        super().__init__()
        from diffsheg_tpu_torch.models.blocks import StylizationBlock
        self.num_heads = num_heads
        self.norm = nn.LayerNorm(latent_dim, eps=LN_EPS)
        self.text_norm = nn.LayerNorm(cond_dim, eps=LN_EPS)
        self.query = Dense(latent_dim, latent_dim)
        self.key = Dense(cond_dim, latent_dim)
        self.value = Dense(cond_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dropout)

    def forward(self, x, xf, emb, mod: Optional[torch.Tensor] = None,
                train: Train = False):
        xn, xfn = self.norm(x), self.text_norm(xf)
        y = linear_attention(self.query(xn), self.key(xfn), self.value(xfn),
                             self.num_heads)
        return x + self.proj_out(y, emb, mod, train=train)
