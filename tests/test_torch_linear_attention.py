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


@pytest.mark.parametrize("T,masked,D,heads",
                         [(34, False, 64, H), (88, False, 64, H),
                          (34, True, 64, H), (12, False, 64, H),
                          (34, True, 128, 8), (34, True, 144, 1),
                          (88, False, 256, 2)],
                         ids=["T34", "T88", "T34_masked", "T12", "D128_H8",
                              "hd144", "hd128"])
def test_f32_matches_pallas_kernel(T, masked, D, heads):
    q, k, v = _qkv(2, T, D, T, masked)
    ref = np.asarray(j_fused(
        *(jnp.asarray(a) for a in (q, k, v)), heads, True))
    before = P.fused_linear_attention.launches
    by_shape = dict(P.fused_linear_attention.launches_by_shape)
    got = P.fused_linear_attention(*(torch.tensor(a) for a in (q, k, v)),
                                   heads)
    assert P.fused_linear_attention.launches == before   # CPU: no launch
    assert P.fused_linear_attention.launches_by_shape == by_shape
    assert got.dtype == torch.float32 and got.shape == (2, T, D)
    assert rel_rms(got.numpy(), ref) <= 1e-5, rel_rms(got.numpy(), ref)


# (B, T, D, H): BEAT's branch rows, SHOW classifier-free, the level
# cache's audio encoder (hd 16), a 12-frame live window, 512 frames (past
# whole-T staging), hd 32; heads wider than 64: hd 144 at one window, at
# a 352-frame classifier-free window (tiled) and at a training batch, hd
# 128 and hd 512 (a thread a column of k: 512 threads)
PLAN_SHAPES = [(1, 34, 512, 8), (2, 88, 512, 8), (750, 34, 128, 8),
               (1, 12, 512, 8), (1, 512, 512, 8), (2, 34, 256, 8),
               (1, 34, 1152, 8), (2, 352, 1152, 8), (256, 34, 1152, 8),
               (1, 34, 1024, 8), (1, 34, 512, 1)]


@pytest.mark.parametrize("vec", [True, False], ids=["vec", "scalar"])
@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["-".join(map(str, s)) for s in PLAN_SHAPES])
def test_launch_plan_covers_each_output_once(shape, vec):
    B, T, D, heads = shape
    hd = D // heads
    plan = P._launch_plan(B, T, D, heads, vec=vec)
    assert plan.vec == vec and plan.smem_bytes <= 232448
    # csrc: a thread a column of k, and ctx's columns within the threads'
    # accumulators
    assert plan.heads * hd <= plan.threads
    assert plan.heads * hd * plan.width <= plan.threads * 16
    # tiled exactly when all of T does not fit in a block
    whole = P._smem_bytes(hd, plan.heads, plan.width, T, True)
    assert (plan.mode == "tiled") == (whole > 232448)
    assert plan.tile_rows == T if plan.mode == "staged" else plan.tile_rows < T
    assert plan.smem_bytes == P._smem_bytes(hd, plan.heads, plan.width,
                                            plan.tile_rows,
                                            plan.mode == "staged")
    count = np.zeros((B, heads, hd), np.int32)
    for block in range(plan.grid):
        b, hs, cs = P._block_work(plan, heads, block)
        count[b, hs.start:hs.stop, cs.start:cs.stop] += 1
    assert (count == 1).all()


def test_launch_plan_modes_and_limits():
    beat = P._launch_plan(1, 34, 512, 8)
    assert beat.mode == "staged" and beat.grid > 8      # (row, head) split
    assert P._launch_plan(1, 512, 512, 8).mode == "tiled"
    audio = P._launch_plan(750, 34, 128, 8)
    assert audio.heads > 1 and audio.splits == 1        # narrow heads grouped
    # a head width that is not a multiple of four takes single columns
    odd = P._launch_plan(1, 34, 24, 8)
    assert not odd.vec and odd.width == 3
    # heads wider than 64, as the JAX kernel takes them: ctx's columns split
    # so that a block's threads hold them
    wide = P._launch_plan(1, 34, 1152, 8)
    assert wide.width * 144 <= wide.threads * 16 and wide.mode == "staged"
    assert P._launch_plan(1, 34, 512, 1).threads == 512   # hd 512
    with pytest.raises(ValueError):
        P._launch_plan(1, 34, 1024, 1)                  # hd 1024 > 512
    with pytest.raises(ValueError):
        P._launch_plan(1, 34, 500, 8)                   # 8 does not divide D


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
