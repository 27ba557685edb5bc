"""Linear (efficient) temporal self-attention.

Counterpart of ``diffsheg_tpu/models/attention.py``: Q is softmax-normalised
over the per-head features, K over time, and

    ctx  = sum_t K[t] (x) V[t]          # (B, H, hd, hd)
    y[t] = Q[t] @ ctx                   # (B, T, H, hd)

This module is the plain composition (what the JAX package runs for bf16
activations); it serves the audio-encoder layer of the timestep-level
cache.  The sampler's per-step layers run inside the fused-layer kernels.
The source mask is all ones on every path the port runs (fixed-size
sampler windows), so the key mask and value zeroing are identities.
"""

from __future__ import annotations

import torch
from torch import nn

LN_EPS = 1e-5


def linear_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """q, k, v (B, T, D) pre-softmax -> (B, T, D) in q's dtype; both
    contractions accumulate in f32 and ctx is rounded to q's dtype before
    the second, as in the JAX composition."""
    B, T, D = q.shape
    N = k.shape[1]
    hd = D // num_heads
    qs = q.reshape(B, T, num_heads, hd).softmax(-1)
    ks = k.reshape(B, N, num_heads, hd).softmax(1)
    vv = v.reshape(B, N, num_heads, hd)
    ctx = torch.einsum("bnhd,bnhl->bhdl", ks.float(), vv.float())
    y = torch.einsum("bnhd,bhdl->bnhl", qs.float(),
                     ctx.to(qs.dtype).float())
    return y.to(q.dtype).reshape(B, T, D)


class LinearTemporalSelfAttention(nn.Module):
    """LN -> Q/K/V -> linear attention -> stylization, plus the residual."""

    def __init__(self, latent_dim: int, num_heads: int, time_embed_dim: int):
        super().__init__()
        from diffsheg_tpu_torch.models.blocks import StylizationBlock
        self.num_heads = num_heads
        self.norm = nn.LayerNorm(latent_dim, eps=LN_EPS)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(latent_dim, latent_dim)
        self.value = nn.Linear(latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim)

    def forward(self, x, emb):
        xn = self.norm(x)
        y = linear_attention_reference(self.query(xn), self.key(xn),
                                       self.value(xn), self.num_heads)
        return x + self.proj_out(y, emb)
