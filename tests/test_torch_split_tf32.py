"""The numerics of the f32 layer kernel's weight products.

``csrc/fused_layer.cu`` runs its f32 products on the tensor cores as split
TF32: each f32 value x becomes hi = rna(x) and lo = rna(x - hi), two TF32
values (``cvt.rna.tf32.f32``: 10 mantissa bits, ties away from zero), and
a product accumulates a_lo w_hi + a_hi w_lo + a_hi w_hi into f32, small
terms first; int8 / int4 codes are exact in TF32, so their products are
a_lo w + a_hi w.  The kernel runs only on the card; here a plain-torch
emulation of that product (the rounding by bit arithmetic on int32 views,
the kernel's tf32_rna) is held against the f32 product at every product
shape of a BEAT layer, with the inputs made from a seed with numpy.
Tolerance: 1e-6 rel-RMS, a tenth of the kernel-against-plain band of 1e-5
(each split product is ~2^-22 relative off).  One TF32 product alone
misses 1e-5, which is why the kernel takes three.
"""

import numpy as np
import pytest
import torch

from diffsheg_tpu_torch.ops.fused_layer import (LayerScales,
                                                quantize_layer_params,
                                                random_layer_params,
                                                unpack_int4)

L, F, CP = 512, 1024, 1024
# (K, N) of a BEAT layer's seven products: fc1, fc2, qkv, sa_out, l1, l2,
# ffn_out (sa_out and ffn_out share a shape)
PRODUCT_SHAPES = sorted({(CP, 2 * L), (2 * L, L), (L, 3 * L), (L, L),
                         (L, F), (F, L)})
ROWS = (34, 136, 238)   # one window; cli generate's 4 speakers; 7 windows


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 as ``cvt.rna.tf32.f32`` rounds: half an ulp of the
    10-bit mantissa added to the magnitude's bits, then the low 13 bits
    cleared (a carry into the exponent is the right result)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def split_product(a: torch.Tensor, w: torch.Tensor,
                  exact_w: bool = False) -> torch.Tensor:
    """The kernel's f32 product a @ w: three TF32 products (two when w holds
    codes exact in TF32), each exact in f32, summed small terms first."""
    a_hi, a_lo = split(a)
    if exact_w:
        return a_lo @ w + a_hi @ w
    w_hi, w_lo = split(w)
    return (a_lo @ w_hi + a_hi @ w_lo) + a_hi @ w_hi


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean().sqrt() / (b ** 2).mean().sqrt())


def operands(M, K, N, seed):
    """Activations of unit scale and weights as random_layer_params draws
    them (std 1/sqrt(K)), from numpy."""
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(rng.randn(M, K).astype(np.float32))
    w = torch.from_numpy((rng.randn(K, N) / np.sqrt(K)).astype(np.float32))
    return a, w


def rna_reference(x: np.ndarray) -> np.ndarray:
    """Round to 11 significant bits, ties away from zero, in float64."""
    m, e = np.frexp(x.astype(np.float64))          # |m| in [0.5, 1)
    s = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return np.ldexp(s, e - 11).astype(np.float32)


def test_rna_by_bits_rounds_to_nearest_ties_away():
    rng = np.random.RandomState(0)
    x = (rng.randn(4096) * 10.0 ** rng.uniform(-30, 30, 4096)).astype(
        np.float32)
    # exact ties (low 13 bits 0x1000), both signs, and a carry into the
    # exponent (1 - 2^-24 rounds to 1)
    ties = (rng.randint(1, 254, 64).astype(np.uint32) << 23
            | rng.randint(0, 2 ** 10, 64).astype(np.uint32) << 13
            | 0x1000).view(np.float32)
    x = np.concatenate([x, ties, -ties, np.float32([1 - 2 ** -24, 0.0])])
    got = tf32_rna(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, rna_reference(x))
    assert not (got.view(np.uint32) & 0x1FFF).any()


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("K,N", PRODUCT_SHAPES)
def test_split_product_matches_f32_product(K, N, M):
    a, w = operands(M, K, N, seed=K + N + M)
    want = a.double() @ w.double()
    got = split_product(a, w)
    assert rel_rms(got, want) <= 1e-6
    assert rel_rms(got, a @ w) <= 1e-6


@pytest.mark.parametrize("K,N", [(CP, 2 * L), (F, L)])
def test_one_tf32_product_misses_the_band(K, N):
    a, w = operands(34, K, N, seed=1)
    want = a.double() @ w.double()
    one_pass = tf32_rna(a) @ tf32_rna(w)
    assert rel_rms(one_pass, want) > 1e-5
    assert rel_rms(split_product(a, w), want) <= 1e-6


def quantized_codes(bits):
    """Every weight matrix of a BEAT layer, drawn with numpy, as the f32
    codes the kernel's quantized products read (int4 unpacked into both
    column halves)."""
    rng = np.random.RandomState(3)
    lp = random_layer_params(1, L, F, CP, 947, torch.float32,
                             torch.Generator().manual_seed(3), "cpu")
    lp = lp._replace(**{
        name: torch.from_numpy((rng.randn(*getattr(lp, name).shape)
                                / np.sqrt(getattr(lp, name).shape[-2])
                                ).astype(np.float32))
        for name in LayerScales._fields})
    q, _ = quantize_layer_params(lp, bits)
    codes = []
    for name in LayerScales._fields:
        c = getattr(q, name)[0]
        codes += list(unpack_int4(c)) if bits == 4 else [c.float()]
    return codes


@pytest.mark.parametrize("bits", [8, 4])
def test_codes_have_no_lo_part(bits):
    for c in quantized_codes(bits):
        hi, lo = split(c)
        assert torch.equal(hi, c)
        assert not lo.any()


@pytest.mark.parametrize("bits", [8, 4])
def test_two_products_with_codes_match_f32_product(bits):
    codes = quantized_codes(bits)[0]      # fc1 (int4: its left column half)
    a, _ = operands(136, *codes.shape, seed=bits)
    want = a.double() @ codes.double()
    assert rel_rms(split_product(a, codes, exact_w=True), want) <= 1e-6
