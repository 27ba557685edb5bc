"""Denoiser building blocks.

Counterpart of ``diffsheg_tpu/models/blocks.py``; attribute names follow
the Flax parameter tree so weights carry across by name
(``compat/from_jax.py``).

- ``StylizationBlock``: AdaLN modulation ``out(dropout(silu(norm(h) *
  (1 + scale) + shift)))`` from the time(+speaker) embedding or a
  precomputed ``mod`` from the timestep-level cache.
- ``FFN``: GELU MLP (dropout after the GELU) with a stylization residual.
- ``CondProjection``: LN -> Dense(2L) -> SiLU -> Dense(L).
- ``DiffusionTransformerLayer``: condition re-injection (concat, the
  classifier-free null-condition substitution, MLP projection and
  residual) then linear self-attention and FFN; or, with
  ``model_base='transformer_decoder'``, self-attention, linear
  cross-attention over the condition, and FFN.  This is the module
  forward; the sampler's fast path runs the same layers in the fused-layer
  kernels (``ops/fused_layer.py``).

Dense layers are ``ops/products.py``'s ``Dense``: ``nn.Linear`` whose f32
products on the card run in split TF32 on the tensor cores where they are
large enough (``takes_tf32x3``: training's batches), ``F.linear``
otherwise.

Every forward takes ``train``: dropout (probability ``dropout``, from
torch's global generator) runs only in training, as Flax's
``deterministic=not train``.  ``train`` is ``False``, ``True`` (one process
holding the whole batch) or a :class:`GlobalBatch`, which the training
step builds to say which rows of the global batch this process holds.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from diffsheg_tpu_torch.models.attention import (LinearTemporalCrossAttention,
                                                LinearTemporalSelfAttention)
from diffsheg_tpu_torch.ops.products import Dense

LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class GlobalBatch:
    """This process's share of the global training batch, as the training
    step computes it (``train/step.py``): rows ``[first, first + B)`` of
    ``total``, over ``processes`` processes, and ``sum_across``, the
    differentiable sum of a tensor over the processes (BatchNorm's global
    statistics).  Passed as a forward's ``train``."""

    first: int
    total: int
    processes: int = 1
    sum_across: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


Train = Union[bool, GlobalBatch]


def batch_rows(train: Train, local: int) -> Tuple[int, int]:
    """(first global row, global batch) of this process's ``local`` rows:
    the step's :class:`GlobalBatch`, else the whole batch."""
    if isinstance(train, GlobalBatch):
        return train.first, train.total
    return 0, local


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def dropout(x: torch.Tensor, p: float, train: Train) -> torch.Tensor:
    """Inverted dropout (kept entries scaled by 1 / (1 - p)) only in
    training; the identity otherwise and at ``p == 0``.  The mask is drawn
    for the global batch (``x`` is this process's rows of it, batch
    first; :func:`batch_rows`) and cut to this process's rows, so N
    processes drop what one process drops; with one process on the CPU it
    is ``F.dropout``'s draw (on the card ``F.dropout`` has a fused kernel
    of its own).  The global mask is drawn as bools and only this
    process's rows of it become the scale that the backward pass keeps."""
    if not (train and p > 0):
        return x
    first, total = batch_rows(train, x.shape[0])
    keep = torch.empty((total,) + x.shape[1:], dtype=torch.bool,
                       device=x.device).bernoulli_(1.0 - p)
    scale = keep[first:first + x.shape[0]].to(x.dtype).div_(1.0 - p)
    return x * scale


class StylizationBlock(nn.Module):
    def __init__(self, latent_dim: int, time_embed_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.emb_proj = Dense(time_embed_dim, 2 * latent_dim)
        self.norm = nn.LayerNorm(latent_dim, eps=LN_EPS)
        self.out_proj = Dense(latent_dim, latent_dim)

    def forward(self, h, emb: Optional[torch.Tensor],
                mod: Optional[torch.Tensor] = None, train: Train = False):
        # emb (B, E) -> mod (B, 2L), unless the cache supplies it
        if mod is None:
            mod = self.emb_proj(F.silu(emb))
        scale, shift = mod[:, None, :].chunk(2, dim=-1)
        h = self.norm(h) * (1.0 + scale) + shift
        return self.out_proj(dropout(F.silu(h), self.dropout, train))


class FFN(nn.Module):
    def __init__(self, latent_dim: int, ffn_dim: int, time_embed_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.linear1 = Dense(latent_dim, ffn_dim)
        self.linear2 = Dense(ffn_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dropout)

    def forward(self, x, emb, mod: Optional[torch.Tensor] = None,
                train: Train = False):
        y = self.linear2(dropout(gelu_exact(self.linear1(x)), self.dropout,
                                 train))
        return x + self.proj_out(y, emb, mod, train=train)


class CondProjection(nn.Module):
    def __init__(self, in_dim: int, latent_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(in_dim, eps=LN_EPS)
        self.fc1 = Dense(in_dim, 2 * latent_dim)
        self.fc2 = Dense(2 * latent_dim, latent_dim)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(self.norm(x))))


class DiffusionTransformerLayer(nn.Module):
    """One denoiser layer.  ``feats_dim`` is the concat width (latent +
    condition); ``None`` builds the condition-free layer of the audio
    encoder, whose residual doubles the input (a reference quirk kept for
    checkpoint parity).  ``model_base='transformer_decoder'`` replaces the
    concat projection by a cross-attention over the condition
    (``ca_block``) after the self-attention; it has no null-condition
    path."""

    def __init__(self, latent_dim: int, ffn_dim: int, num_heads: int,
                 time_embed_dim: int, feats_dim: Optional[int] = None,
                 model_base: str = "transformer_encoder",
                 dropout: float = 0.0):
        super().__init__()
        if model_base not in ("transformer_encoder", "transformer_decoder"):
            raise ValueError(f"model_base={model_base!r}")
        self.decoder = model_base == "transformer_decoder"
        if feats_dim is not None and not self.decoder:
            self.feat_proj = CondProjection(feats_dim, latent_dim)
        self.sa_block = LinearTemporalSelfAttention(latent_dim, num_heads,
                                                    time_embed_dim, dropout)
        if feats_dim is not None and self.decoder:
            self.ca_block = LinearTemporalCrossAttention(
                latent_dim, num_heads, time_embed_dim, feats_dim - latent_dim,
                dropout)
        self.ffn = FFN(latent_dim, ffn_dim, time_embed_dim, dropout)

    def forward(self, x, cond: Optional[torch.Tensor],
                emb: Optional[torch.Tensor],
                src_mask: Optional[torch.Tensor] = None,
                null_cond_mask: Optional[torch.Tensor] = None,
                null_cond_emb: Optional[torch.Tensor] = None,
                mods: Optional[torch.Tensor] = None, train: Train = False):
        """x (B, T, L); cond (B, T, C) or None; emb (B, E) or None when
        ``mods`` (2, B, 2L) come from the cache; ``null_cond_mask`` (B,)
        bool rows whose concat is replaced by ``null_cond_emb`` (1, L+C)."""
        if self.decoder:
            x = self.sa_block(x, emb, src_mask,
                              None if mods is None else mods[0], train=train)
            if cond is not None:
                x = self.ca_block(x, cond, emb, train=train)
            return self.ffn(x, emb, None if mods is None else mods[1],
                            train=train)
        if cond is not None:
            feats = torch.cat([x, cond], dim=-1)
            if null_cond_mask is not None:
                null = null_cond_emb[:, None, :].to(feats.dtype).expand_as(feats)
                feats = torch.where(null_cond_mask[:, None, None], null, feats)
            x = self.feat_proj(feats) + x
        else:
            x = x + x
        x = self.sa_block(x, emb, src_mask, None if mods is None else mods[0],
                          train=train)
        return self.ffn(x, emb, None if mods is None else mods[1],
                        train=train)
