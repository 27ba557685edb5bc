"""Operations of the speech encoder (HuBERT / WavLM layouts of a
configuration's ``hubert`` group) over one window of audio, counted from
shapes as ``model.py`` counts them: a multiply-add is two operations,
norms, activations and the softmax are left out.

Per window of ``samples`` samples: the conv feature extractor (each conv
over its output frames), the projection to the hidden width, the grouped
positional conv, and in each layer the q / k / v / output products, both
attention contractions (q.k and P.V), the FFN; with WavLM's gated
relative-position bias (``rel_pos_buckets``) also each layer's gate
product (a head's 64 inputs to 8 outputs, every frame and head) and the
gated bias (a multiply and an add a logit).  BEAT's window (36266
samples, 113 frames) at WavLM-Large's widths: ~82.6 GFLOP.
"""

from __future__ import annotations


def frames(h, samples):
    """The frames the conv stack makes of ``samples`` samples."""
    n = samples
    for k, s in zip(h["conv_kernel"], h["conv_stride"]):
        n = (n - k) // s + 1
    return n


def conv_ops(h, samples):
    ops, n, c_in = 0, samples, 1
    for c, k, s in zip(h["conv_dim"], h["conv_kernel"], h["conv_stride"]):
        n = (n - k) // s + 1
        ops += 2 * n * c * c_in * k
        c_in = c
    return ops


def layer_ops(h, T):
    """One encoder layer over T frames."""
    H, heads = h["hidden_size"], h["num_heads"]
    ops = (2 * T * 4 * H * H + 2 * 2 * T * T * H
           + 2 * 2 * T * H * h["intermediate_size"])
    if h.get("rel_pos_buckets", 0):
        ops += 2 * T * H * 8                  # each head's 8 gate outputs
        ops += 2 * heads * T * T              # the gated bias
    return ops


def window_ops(h, samples):
    """The encoder's forward over one window of ``samples`` samples."""
    T = frames(h, samples)
    H = h["hidden_size"]
    return (conv_ops(h, samples) + 2 * T * h["conv_dim"][-1] * H
            + 2 * T * H * (H // h["num_conv_pos_embedding_groups"])
            * h["num_conv_pos_embeddings"]
            + h["num_layers"] * layer_ops(h, T))
