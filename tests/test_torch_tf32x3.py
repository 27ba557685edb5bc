"""The split-TF32 product (``ops/products.py``, ``csrc/gemm_tf32x3.cu``)
and the dense layer's route to it, on the CPU.

The kernel runs only on the card (``chip_smoke.py``'s ``gemm_tf32x3``
case holds it against its plain version and an f64 product there); here:

- the split: ``hi`` is TF32 (its 13 low bits zero), and so is ``lo`` as
  the tensor cores read it, and ``|x - (hi + lo)| <= 2^-22 |x|`` for
  normal x from 2^-100 (below that ``lo`` falls under f32's normal range)
  to the top of the range but for its last 2^-12 (where ``hi`` rounds to
  infinity); zeros and infinities pass through, a NaN stays a NaN;
- the plain version against an f64 product in NT, NN and TN at small odd
  shapes, under the bound of its arithmetic: each operand split to 2^-22
  and ``lo*lo`` dropped (3 x 2^-22 of each term's magnitude), plus f32's
  rounding of a sum of K terms (K x 2^-24 of the sum of magnitudes);
- ``linear_tf32x3``'s backward (dX in NN, dW in TN, db a column sum)
  against autograd through ``F.linear`` in f64, under the same bound, at
  widths on and off a multiple of 4 (padded for the kernel);
- ``Dense`` on the CPU is ``nn.Linear`` bit for bit, and ``UniDiffuser``'s
  parameters and state dict keep their names;
- the route's rule (the denoiser's and the speech encoder's shapes) and
  the split of dW's contraction over k;
- every kernel of the source has ``gemm`` in its name (the benchmark's
  ``products_ms_per_step.train`` finds product kernels by name).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn
from torch.nn import functional as F

from diffsheg_tpu_torch.ops import products
from diffsheg_tpu_torch.ops.products import (MIN_ROWS, MIN_WORK, Dense,
                                             gemm_tf32x3, linear_tf32x3,
                                             split_plan, split_tf32,
                                             takes_tf32x3)

SPLIT_REL = 2.0 ** -22
F32_EPS = 2.0 ** -24


def _bits(x):
    return x.contiguous().view(torch.int32)


def _normals(rng, n=4000, lo_exp=-100, hi_exp=127):
    """Normal f32 values of both signs, exponents lo_exp..hi_exp, random
    mantissas, below the top of the range by more than 2^-12."""
    exps = rng.integers(lo_exp, hi_exp + 1, n)
    mant = rng.uniform(1.0, 2.0 - 2.0 ** -11, n)
    x = (np.sign(rng.standard_normal(n)) * mant
         * 2.0 ** exps.astype(np.float64))
    return torch.from_numpy(x.astype(np.float32))


def test_split_is_tf32_and_within_2_to_the_minus_22():
    x = _normals(np.random.default_rng(0))
    hi, lo = split_tf32(x)
    assert torch.all(_bits(hi) & 0x1FFF == 0)
    assert torch.all(_bits(lo) & 0x1FFF == 0)
    err = (x.double() - (hi.double() + lo.double())).abs()
    assert torch.all(err <= SPLIT_REL * x.double().abs())
    # lo carries what hi misses: without it the error is TF32's
    assert (x.double() - hi.double()).abs().max() > 2 ** 6 * err.max()


def test_split_passes_zeros_infinities_and_nans():
    x = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan")])
    hi, lo = split_tf32(x)
    assert torch.equal(_bits(hi[:4]), _bits(x[:4]))
    assert torch.equal(lo[:4], torch.zeros(4))
    assert torch.isnan(hi[4] + lo[4])


def _operands(layout, M, N, K, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K) if layout[0] == "n" else (K, M))
    b = rng.standard_normal((N, K) if layout[1] == "t" else (K, N))
    return (torch.from_numpy(a.astype(np.float32)),
            torch.from_numpy(b.astype(np.float32)))


def _op(a, layout_char, left):
    """op(a) of a layout: 'n' as is, 't' transposed (left: A, else B)."""
    if left:
        return a if layout_char == "n" else a.t()
    return a.t() if layout_char == "t" else a


def _bound(A, B):
    """|op(a) op(b) - plain| <= this, elementwise (f64 A, B)."""
    K = A.shape[1]
    return (3 * SPLIT_REL + K * F32_EPS) * (A.abs() @ B.abs())


@pytest.mark.parametrize("layout", products.LAYOUTS)
@pytest.mark.parametrize("M,N,K", [(7, 12, 20), (37, 20, 28), (130, 44, 97)])
def test_plain_product_against_f64(layout, M, N, K):
    a, b = _operands(layout, M, N, K, seed=M * N * K)
    bias = torch.randn(N, dtype=torch.float32) if layout == "nt" else None
    out = gemm_tf32x3(a, b, layout, bias)
    assert out.shape == (M, N) and out.dtype == torch.float32
    A = _op(a.double(), layout[0], True)
    B = _op(b.double(), layout[1], False)
    ref = A @ B + (0 if bias is None else bias.double())
    assert torch.all((out.double() - ref).abs() <= _bound(A, B) + 1e-30)
    # and not single-pass TF32: the split's lo terms are in the product
    hi_a, _ = split_tf32(A.float())
    hi_b, _ = split_tf32(B.float())
    tf32 = (hi_a.double() @ hi_b.double()).float()
    err = (out.double() - ref).abs().max()
    assert (tf32.double() - ref).abs().max() > 50 * err


def test_products_refuse_what_does_not_multiply():
    a, b = _operands("nt", 5, 6, 7, seed=1)
    with pytest.raises(ValueError, match="layout"):
        gemm_tf32x3(a, b, "tt")
    with pytest.raises(ValueError, match="do not multiply"):
        gemm_tf32x3(a, b, "nn")


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("k_in,n_out", [(24, 20), (23, 17), (947, 6)])
def test_linear_backward_against_autograd(bias, k_in, n_out):
    """Widths off a multiple of 4 run padded with zeros (the gesture
    branch's 947-wide concat, the 141 / 51-channel heads)."""
    rng = np.random.default_rng(k_in + n_out)
    x = torch.from_numpy(rng.standard_normal((3, 11, k_in)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n_out, k_in)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n_out).astype(np.float32))
    g = torch.from_numpy(
        rng.standard_normal((3, 11, n_out)).astype(np.float32))
    xs = [t.clone().requires_grad_() for t in (x, w, b)]
    y = linear_tf32x3(xs[0], xs[1], xs[2] if bias else None)
    assert y.shape == (3, 11, n_out)
    y.backward(g)
    xd = [t.double().requires_grad_() for t in (x, w, b)]
    yd = F.linear(xd[0], xd[1], xd[2] if bias else None)
    yd.backward(g.double())
    x2, g2 = x.double().reshape(-1, k_in), g.double().reshape(-1, n_out)
    w2 = w.double()
    for got, ref, bound in (
            (y, yd, _bound(x2, w2.t()).reshape(y.shape)),
            (xs[0].grad, xd[0].grad, _bound(g2, w2).reshape(x.shape)),
            (xs[1].grad, xd[1].grad, _bound(g2.t(), x2))):
        assert got.shape == ref.shape
        assert torch.all((got.double() - ref.detach()).abs() <= bound + 1e-30)
    if bias:
        assert torch.allclose(xs[2].grad.double(), xd[2].grad, rtol=1e-6,
                              atol=1e-5)
    else:
        assert xs[2].grad is None


def test_dense_on_the_cpu_is_nn_linear():
    torch.manual_seed(0)
    lin = nn.Linear(24, 20)
    dense = Dense(24, 20)
    dense.load_state_dict(lin.state_dict())
    # the CPU takes F.linear at any size
    x = torch.randn(MIN_ROWS + 3, 24, requires_grad=True)
    y1, y2 = lin(x), dense(x)
    assert torch.equal(y1, y2)
    g = torch.randn_like(y1)
    g1 = torch.autograd.grad(y1, [x, lin.weight, lin.bias], g)
    g2 = torch.autograd.grad(y2, [x, dense.weight, dense.bias], g)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    assert isinstance(dense, nn.Linear)


def test_unidiffuser_keeps_its_parameter_names(monkeypatch):
    from diffsheg_tpu_torch.config import ModelConfig
    from diffsheg_tpu_torch.models import attention, blocks, denoiser
    from diffsheg_tpu_torch.models.unidiffuser import UniDiffuser
    cfg = ModelConfig(latent_dim=32, num_layers=1, num_heads=2, ff_size=64,
                      add_hubert=False)

    def build():
        torch.manual_seed(0)
        return UniDiffuser(cfg)

    routed = build()
    dense = [m for m in routed.modules() if isinstance(m, Dense)]
    assert dense and all(type(m) is Dense for m in dense)
    for mod in (attention, blocks, denoiser):
        monkeypatch.setattr(mod, "Dense", nn.Linear)
    plain = build()
    assert not any(isinstance(m, Dense) for m in plain.modules())
    sd_r, sd_p = routed.state_dict(), plain.state_dict()
    assert list(sd_r) == list(sd_p)
    for k in sd_r:
        assert torch.equal(sd_r[k], sd_p[k])


@pytest.mark.parametrize("case,expected", [
    # training's rows at the model's widths, narrow layers included
    (("cuda", torch.float32, 85000, 512, 512), True),
    (("cuda", torch.float32, 85000, 128, 128), True),
    (("cuda", torch.float32, 85000, 51, 512), True),
    # the work threshold, at and just under it
    (("cuda", torch.float32, MIN_WORK // (1024 * 512), 1024, 512), True),
    (("cuda", torch.float32, MIN_WORK // (1024 * 512) - 1, 1024, 512),
     False),
    # widths count as the kernel pads them: 1023 as 1024
    (("cuda", torch.float32, MIN_WORK // (1024 * 256), 1023, 256), True),
    # a three-window stream's f32 level cache: narrow, small
    (("cuda", torch.float32, 2550, 128, 128), False),
    # wide enough, but fewer rows than the crossover measured
    (("cuda", torch.float32, MIN_ROWS, 2048, 2048), True),
    (("cuda", torch.float32, MIN_ROWS - 1, 2048, 2048), False),
    (("cuda", torch.float32, 34, 512, 512), False),
    (("cuda", torch.bfloat16, 85000, 512, 512), False),
    (("cpu", torch.float32, 85000, 512, 512), False),
    # the speech encoder's: a frontend chunk of 64 windows, 7232 rows
    # (q / k / v / out, fc1, fc2, the feature projection)
    (("cuda", torch.float32, 7232, 1024, 1024), True),
    (("cuda", torch.float32, 7232, 1024, 4096), True),
    (("cuda", torch.float32, 7232, 4096, 1024), True),
    (("cuda", torch.float32, 7232, 512, 1024), True),
    # offline extraction: a 60 s clip's three 20 s chunks in one batch;
    # one chunk alone takes fc1 / fc2, its 1024 -> 1024 products fall just
    # under 2^30 multiply-adds
    (("cuda", torch.float32, 3000, 1024, 1024), True),
    (("cuda", torch.float32, 1000, 1024, 4096), True),
    (("cuda", torch.float32, 1000, 1024, 1024), False),
    # WavLM's gate on every head's rows: 5.9e7 multiply-adds
    (("cuda", torch.float32, 7232 * 16, 64, 8), False),
    # a training step's last chunk of 4 windows
    (("cuda", torch.float32, 452, 1024, 4096), False),
    # the streams' bf16 encoder
    (("cuda", torch.bfloat16, 7232, 1024, 1024), False),
])
def test_route_rule(case, expected):
    assert takes_tf32x3(*case) is expected


@pytest.mark.parametrize("M,N", [(512, 512), (1024, 512), (512, 1024),
                                 (1024, 896)])
def test_dw_contraction_split_over_k(M, N):
    K, sms = 85000, 132
    kps, splits = split_plan(M, N, K, sms)
    tiles = -(-M // 128) * -(-N // 128)
    k_steps = -(-K // 32)
    assert splits > 1 and tiles * splits <= sms
    assert (splits - 1) * kps < k_steps <= splits * kps   # none empty
    assert split_plan(85000, N, 512, sms)[1] == 1


def test_every_kernel_is_named_gemm():
    src = (Path(products.__file__).resolve().parent.parent / "csrc"
           / products.KERNEL_SOURCE).read_text()
    names = re.findall(r"__global__\s+(?:void\s+)?"
                       r"(?:__launch_bounds__\([^)]*\)\s+)?"
                       r"(?:void\s+)?(\w+)\s*\(", src)
    assert len(names) == 3
    assert all("gemm" in n for n in names), names
