"""Operations and bytes the work needs, counted from shapes.

A multiply-add is two operations; elementwise work (norms, activations,
softmax) is left out, so the counts are of the products.  Bytes count
each input read once and each output written once.  Every function takes
the ``model`` / ``hubert`` groups of a configuration file.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def layer_widths(m, n_out_cond):
    """(L, F, heads, concat width) of a branch layer; ``n_out_cond`` is the
    width of the expression condition (0 on the expression branch)."""
    L = m["latent_dim"]
    return (L, m["ff_size"], m["num_heads"],
            L + m["aud_latent_dim"] + m["hubert_latent_dim"] + n_out_cond)


def layer_ops(rows, L, F, heads, C=None):
    """One denoiser layer over ``rows`` = B * T frames of B windows of T:
    the concat projection (C -> 2L -> L, absent without a condition), q/k/v
    and the attention's output projection, both linear-attention
    contractions (2 * 2 * rows * L * hd), the FFN and its output
    projection.  The stylizations' modulation products are per window and
    counted by :func:`modulation_ops`."""
    hd = L // heads
    ops = 2 * rows * (3 * L * L + L * L + 2 * L * F + L * L) + 4 * rows * L * hd
    if C is not None:
        ops += 2 * rows * (C * 2 * L + 2 * L * L)
    return ops


def modulation_ops(n, L, E):
    """``n`` stylization modulations (E -> 2L)."""
    return 2 * n * E * 2 * L


def branch_ops(m, rows, n_out, n_out_cond):
    """One branch's x-dependent work: joint embedding, the layers, the
    output head."""
    L, F, H, C = layer_widths(m, n_out_cond)
    return (2 * rows * n_out * L + m["num_layers"] * layer_ops(rows, L, F, H, C)
            + 2 * rows * L * n_out)


def denoiser_call_ops(m, B, T):
    """One sampler call of the joint model on the level cache: both
    branches at B windows (twice the rows under classifier-free
    guidance)."""
    rows = B * T * (2 if m["classifier_free"] and m["cond_scale"] != 1.0 else 1)
    return (branch_ops(m, rows, m["expression_dim"], 0)
            + branch_ops(m, rows, m["pose_dim"], m["expression_dim"]))


def conditioning_ops(m, B, T, levels):
    """What the level cache computes for one window at ``levels`` noise
    levels: the audio encoder layer and both branches' audio projections
    at every level, the HuBERT encoders once, and every stylization
    modulation and time embedding at every level."""
    L, E, A = m["latent_dim"], 4 * m["latent_dim"], m["audio_dim"]
    rows = B * T
    aud = layer_ops(rows, A, m["ff_size"], m["num_heads"]) \
        + modulation_ops(2 * B, A, E)
    proj = 2 * 2 * rows * 2 * A * m["aud_latent_dim"]
    hub = 2 * 2 * rows * 3 * (m["hubert_dim"] * m["hubert_latent_dim"]
                              + m["hubert_latent_dim"] ** 2)
    emb = 3 * 2 * B * (L * E + E * E) + 2 * 2 * B * (m["style_dim"] * E + E * E)
    mods = modulation_ops(2 * 2 * m["num_layers"] * B, L, E)
    return levels * (aud + proj + emb + mods) + hub


def training_forward_ops(m, B, T):
    """The module forward of a training step over B windows of T frames:
    the per-window embeddings and modulations, the audio encoder, both
    branches with their audio projections and HuBERT encoders."""
    return (conditioning_ops(m, B, T, 1) + denoiser_call_ops(
        dict(m, classifier_free=False), B, T))


def hubert_chunk_ops(h, samples):
    """HuBERT-large over one chunk of ``samples`` audio samples: the conv
    feature extractor, the projection, the grouped positional conv, the
    layers (q/k/v/o, attention, FFN)."""
    ops, n, c_in = 0, samples, 1
    for c, k, s in zip(h["conv_dim"], h["conv_kernel"], h["conv_stride"]):
        n = (n - k) // s + 1
        ops += 2 * n * c * c_in * k
        c_in = c
    H, T = h["hidden_size"], n
    ops += 2 * T * c_in * H
    ops += 2 * T * H * (H // h["num_conv_pos_embedding_groups"]) \
        * h["num_conv_pos_embeddings"]
    ops += h["num_layers"] * (2 * T * 4 * H * H + 2 * 2 * T * T * H
                              + 2 * 2 * T * H * h["intermediate_size"])
    return ops


def hubert_ops(h, samples, chunk=320_080, clip=320_000):
    """A long clip cut as the runner cuts it: every chunk, the remainder
    included, runs at the full chunk length."""
    chunks = samples // clip + (1 if samples % clip >= 400 else 0)
    return chunks * hubert_chunk_ops(h, chunk)


def mel_ops(samples, hop, n_mels, n_fft=2048):
    """Framing, the real FFT (2.5 n log2 n a frame), |.|^2 and the mel
    product."""
    frames = samples // hop + 1
    bins = n_fft // 2 + 1
    return frames * (n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * bins
                     + 2 * bins * n_mels)


def fused_branch_bound(m, B, T, n_out_cond, esize):
    """(operations, bytes) of one launch of the whole-branch kernel: every
    layer of the branch at B windows of T frames; bytes: each layer's
    weights and biases, the input, the condition, the modulations and the
    output, each once, at ``esize`` bytes an element."""
    L, F, H, C = layer_widths(m, n_out_cond)
    n = m["num_layers"]
    rows = B * T
    ops = n * layer_ops(rows, L, F, H, C)
    weights = (2 * C + C * 2 * L + 2 * L + 2 * L * L + L   # concat projection
               + 2 * L + 4 * (L * L + L)                 # norm, q/k/v/o
               + 2 * (2 * L) + L * F + F + F * L + L      # norms, FFN
               + L * L + L)                               # FFN output proj
    acts = rows * L + rows * (C - L) + n * 2 * B * 2 * L + rows * L
    return ops, (n * weights + acts) * esize


def linear_attention_bound(B, T, D, heads, esize):
    """(operations, bytes) of one linear-attention launch: both
    contractions; q, k, v read and the output written once."""
    return 4 * B * T * D * (D // heads), 4 * B * T * D * esize


def bound_seconds(ops, nbytes, peak_flops):
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / peak_flops, nbytes / PEAKS["hbm_bytes_per_s"])
