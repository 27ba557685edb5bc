"""Port parity: the linear-attention kernel wrapper against the JAX Pallas
kernel.

On the CPU the port's ``fused_linear_attention`` runs the kernel's plain
version (everything in f32, ctx kept in f32); JAX's
``fused_linear_attention`` runs its Pallas kernel in interpret mode.  The
same numpy inputs go to both.  f32 rel-RMS <= 1e-5 (the same math in
another summation order); bf16 inputs against the JAX composition (which
rounds ctx to bf16) rel-RMS <= 8e-3; gradients through the autograd
function against ``jax.grad`` through the custom VJP, rel-RMS <= 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffsheg_tpu.ops.linear_attention import (  # noqa: E402
    fused_linear_attention as j_fused, linear_attention_reference as j_ref)
from diffsheg_tpu_torch.ops import linear_attention as P  # noqa: E402
from torch_parity import rel_rms  # noqa: E402

H = 4


def _qkv(B, T, D, seed, masked=False):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, D).astype(np.float32) for _ in range(3))
    if masked:   # the layer's additive key mask and value zeroing
        mask = np.ones((B, T, 1), np.float32)
        mask[:, -T // 4:] = 0.0
        k = k + (1.0 - mask) * -1e6
        v = v * mask
    return q, k, v


@pytest.mark.parametrize("T,masked", [(34, False), (88, False), (34, True)],
                         ids=["T34", "T88", "T34_masked"])
def test_f32_matches_pallas_kernel(T, masked):
    q, k, v = _qkv(2, T, 64, T, masked)
    ref = np.asarray(j_fused(
        *(jnp.asarray(a) for a in (q, k, v)), H, True))
    before = P.fused_linear_attention.launches
    got = P.fused_linear_attention(*(torch.tensor(a) for a in (q, k, v)), H)
    assert P.fused_linear_attention.launches == before   # CPU: no launch
    assert got.dtype == torch.float32 and got.shape == (2, T, 64)
    assert rel_rms(got.numpy(), ref) <= 1e-5, rel_rms(got.numpy(), ref)


@pytest.mark.parametrize("T", [34, 88])
def test_bf16_inputs_within_band_of_jax_composition(T):
    q, k, v = _qkv(2, T, 64, T + 1)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    ref = np.asarray(j_ref(*bf, H), np.float32)
    got = P.fused_linear_attention(
        *(torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)), H)
    assert got.dtype == torch.bfloat16
    assert rel_rms(got.float().numpy(), ref) <= 8e-3


def test_gradients_match_jax_custom_vjp():
    q, k, v = _qkv(2, 34, 64, 5, masked=True)
    g = np.random.RandomState(6).randn(2, 34, 64).astype(np.float32)

    def loss(a, b, c):
        return jnp.sum(j_fused(a, b, c, H, True)
                       * jnp.asarray(g))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    P.fused_linear_attention(tq, tk, tv, H).backward(torch.tensor(g))
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        assert rel_rms(got.numpy(), np.asarray(want)) <= 1e-5


def test_dispatch():
    q, k, v = (torch.tensor(a) for a in _qkv(1, 12, 32, 7))
    ref = P.linear_attention_reference(q, k, v, 2)
    # CPU tensors and cross-attention shapes take the composition
    assert torch.equal(P.linear_attention(q, k, v, 2), ref)
    before = P.fused_linear_attention.launches
    torch.testing.assert_close(P.linear_attention(q, k, v, 2, use_fused=True),
                               ref, rtol=1e-6, atol=1e-6)
    assert P.fused_linear_attention.launches == before
    kx, vx = k[:, :8], v[:, :8]
    assert torch.equal(P.linear_attention(q, kx, vx, 2, use_fused=True),
                       P.linear_attention_reference(q, kx, vx, 2))
    # the old import path keeps working
    from diffsheg_tpu_torch.models.attention import linear_attention_reference
    assert linear_attention_reference is P.linear_attention_reference
