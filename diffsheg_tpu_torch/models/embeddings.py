"""Timestep and positional embeddings.

Counterpart of ``diffsheg_tpu/models/embeddings.py``: the sinusoidal
timestep embedding (``[cos | sin]`` layout) and the periodic positional
encoding family (host numpy tables).
"""

from __future__ import annotations

import numpy as np
import torch


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """(B,) timesteps -> (B, dim) float32, ``[cos | sin]``."""
    half = dim // 2
    freqs = torch.exp(-np.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def sinusoidal_position_table(period: int, d_model: int) -> np.ndarray:
    """Interleaved sin/cos position table, (period, d_model) float32."""
    position = np.arange(period, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * (-np.log(10000.0) / d_model))
    table = np.zeros((period, d_model), dtype=np.float64)
    table[:, 0::2] = np.sin(position * div_term)
    table[:, 1::2] = np.cos(position * div_term[: table[:, 1::2].shape[1]])
    return table.astype(np.float32)


def positional_encoding(pe_type: str, seq_len: int, d_model: int,
                        max_seq_len: int = 600) -> np.ndarray:
    """The PE table for a variant, truncated to ``seq_len``
    ('pe_sinu' period max_seq_len, 'ppe_sinu' period 25, 'pe_sinu_repeat'
    period 200)."""
    if pe_type == "pe_sinu":
        period = max_seq_len
    elif pe_type in ("ppe_sinu", "ppe_sinu_dropout"):
        period = 25
    elif pe_type == "pe_sinu_repeat":
        period = 200
    else:
        raise ValueError(f"unsupported pe_type {pe_type!r}")
    table = sinusoidal_position_table(period, d_model)
    return np.tile(table, (seq_len // period + 1, 1))[:seq_len]
