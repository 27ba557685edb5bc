"""The operation and byte counts of ``benchmark/flops`` against counts
made by hand at two shapes each."""

import pytest

from benchmark.flops import model as fl

BEAT = dict(latent_dim=512, num_layers=8, num_heads=8, ff_size=1024,
            audio_dim=128, aud_latent_dim=256, hubert_dim=1024,
            hubert_latent_dim=128, style_dim=30, pose_dim=141,
            expression_dim=51, classifier_free=False, cond_scale=1.0)


@pytest.mark.parametrize("rows,L,F,H,C", [(34, 512, 1024, 8, 896),
                                          (176, 512, 1024, 8, 947)])
def test_layer_ops_by_hand(rows, L, F, H, C):
    hd = L // H
    by_hand = (2 * rows * C * 2 * L + 2 * rows * 2 * L * L   # concat proj
               + 3 * 2 * rows * L * L                        # q, k, v
               + 2 * (2 * rows * L * hd)                     # k^T v, q ctx
               + 2 * rows * L * L                            # attn out proj
               + 2 * rows * L * F + 2 * rows * F * L         # FFN
               + 2 * rows * L * L)                           # FFN out proj
    assert fl.layer_ops(rows, L, F, H, C) == by_hand


@pytest.mark.parametrize("B,T,cond,esize", [(1, 34, 0, 2), (2, 88, 51, 2),
                                            (1, 34, 51, 4)])
def test_fused_branch_bytes_by_hand(B, T, cond, esize):
    L, F, n = 512, 1024, 8
    C = 512 + 256 + 128 + cond
    per_layer = (C * 2 + C * 2 * L + 2 * L          # LN(C), fc1 and bias
                 + 2 * L * L + L                    # fc2 and bias
                 + 2 * L                            # attention LN
                 + 4 * (L * L + L)                  # q, k, v, out proj
                 + 2 * (2 * L)                      # two stylization LNs
                 + L * F + F + F * L + L            # FFN
                 + L * L + L)                       # FFN out proj
    acts = B * T * L + B * T * (C - L) + n * 2 * B * 2 * L + B * T * L
    ops, nbytes = fl.fused_branch_bound(BEAT, B, T, cond, esize)
    assert nbytes == (n * per_layer + acts) * esize
    assert ops == n * fl.layer_ops(B * T, L, F, 8, C)


def test_the_beat_branch_launch_is_bytes_bound_at_about_18_us():
    # PERF.md's kernel table: 0.0189 ms with the condition padded to 1024
    ops, nbytes = fl.fused_branch_bound(BEAT, 1, 34, 0, 2)
    assert nbytes / 3.35e12 > ops / 989e12
    assert 0.0180e-3 < fl.bound_seconds(ops, nbytes, 989e12) < 0.0189e-3


@pytest.mark.parametrize("B,T,D,H", [(2500, 34, 512, 8), (1, 34, 128, 8)])
def test_linear_attention_bound_by_hand(B, T, D, H):
    ops, nbytes = fl.linear_attention_bound(B, T, D, H, 4)
    assert ops == 2 * (2 * B * T * D * (D // H))
    assert nbytes == 4 * B * T * D * 4
    if B == 2500:   # PERF.md's kernel table, row 3k: 0.2079 ms (bytes)
        assert abs(fl.bound_seconds(ops, nbytes, 495e12) - 0.2079e-3) < 1e-7


def test_hubert_chunk_ops_by_hand():
    h = dict(conv_dim=[512] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
             conv_stride=[5, 2, 2, 2, 2, 2, 2], hidden_size=1024,
             num_layers=24, num_heads=16, intermediate_size=4096,
             num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16)
    n, conv, c_in = 320_080, 0, 1
    for k, s in zip(h["conv_kernel"], h["conv_stride"]):
        n = (n - k) // s + 1
        conv += 2 * n * 512 * c_in * k
        c_in = 512
    assert n == 1000    # 20 ms frames of a 20 s chunk
    layer = 2 * n * 4 * 1024 ** 2 + 4 * n * n * 1024 + 4 * n * 1024 * 4096
    expect = conv + 2 * n * 512 * 1024 + 2 * n * 1024 * 64 * 128 + 24 * layer
    assert fl.hubert_chunk_ops(h, 320_080) == expect
    # a 60 s clip: three chunks, the last a remainder padded to full length
    assert fl.hubert_ops(h, 960_000) == 3 * expect
    assert fl.hubert_ops(h, 320_000 + 399) == expect


def test_denoiser_call_doubles_rows_under_guidance():
    plain = fl.denoiser_call_ops(BEAT, 1, 88)
    guided = fl.denoiser_call_ops(dict(BEAT, classifier_free=True,
                                       cond_scale=1.15), 1, 88)
    assert guided == 2 * plain
