"""Port parity: the plain versions of the fused-layer kernels against the
JAX Pallas kernels run in interpret mode.

``fused_layer`` / ``fused_branch`` on CPU tensors run the plain PyTorch
version (the CUDA kernel itself is held against it on the card by
chip_smoke.py).  Every weight leaf is random, so the zero-initialised
output projections of a fresh layer cannot hide the attention or FFN.
Tolerances: f32 max-abs 2e-5 (sums in another order); bf16 rel-RMS 1e-2
(a different accumulation order can flip a bf16 rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffsheg_tpu.ops import fused_layer as J  # noqa: E402
from diffsheg_tpu_torch.ops import fused_layer as P  # noqa: E402
from torch_parity import rel_rms  # noqa: E402

B, T, L, H, F = 2, 13, 64, 4, 128
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def weights(c_real, c_pad, seed, n=None):
    rng = np.random.RandomState(seed)
    lead = () if n is None else (n,)
    shapes = dict(
        fp_norm_scale=(c_pad,), fp_norm_bias=(c_pad,), fp_fc1_k=(c_pad, 2 * L),
        fp_fc1_b=(2 * L,), fp_fc2_k=(2 * L, L), fp_fc2_b=(L,),
        sa_norm_scale=(L,), sa_norm_bias=(L,), q_k=(L, L), q_b=(L,),
        k_k=(L, L), k_b=(L,), v_k=(L, L), v_b=(L,), sa_so_norm_scale=(L,),
        sa_so_norm_bias=(L,), sa_out_k=(L, L), sa_out_b=(L,),
        ffn_l1_k=(L, F), ffn_l1_b=(F,), ffn_l2_k=(F, L), ffn_l2_b=(L,),
        ffn_so_norm_scale=(L,), ffn_so_norm_bias=(L,), ffn_out_k=(L, L),
        ffn_out_b=(L,))
    w = {}
    for k in J.LayerParams._fields:
        shp = lead + shapes[k]
        a = rng.randn(*shp).astype(np.float32)
        a = a / np.sqrt(shp[-2]) if k.endswith("_k") else 0.2 * a
        if k.endswith("norm_scale"):
            a += 1.0
        w[k] = a
    for k in ("fp_norm_scale", "fp_norm_bias"):
        w[k][..., c_real:] = 0.0
    w["fp_fc1_k"][..., c_real:, :] = 0.0
    return w


def both(w, dt):
    jd, td = DTYPES[dt]
    return (J.LayerParams(**{k: jnp.asarray(v, jd) for k, v in w.items()}),
            P.LayerParams(**{k: torch.tensor(v).to(td) for k, v in w.items()}))


def arr(a, dt):
    jd, td = DTYPES[dt]
    return jnp.asarray(a, jd), torch.tensor(a).to(td)


def check(got, ref, dt):
    g = got.float().numpy()
    r = np.asarray(jnp.asarray(ref, jnp.float32))
    if dt == "f32":
        np.testing.assert_allclose(g, r, atol=2e-5, rtol=2e-5)
    else:
        assert rel_rms(g, r) < 1e-2


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("c_real,c_pad", [(L + 35, 128), (128, 128)])
def test_fused_layer_matches_pallas(c_real, c_pad, dt):
    # c_real = L + 35 is not a multiple of 128: exercises the masked LN
    rng = np.random.RandomState(1)
    jlp, tlp = both(weights(c_real, c_pad, 0), dt)
    feats = rng.randn(B, T, c_pad).astype(np.float32)
    feats[..., c_real:] = 0.0
    x, f, ms, mf = (arr(a, dt) for a in (
        rng.randn(B, T, L).astype(np.float32), feats,
        rng.randn(B, 2 * L).astype(np.float32),
        rng.randn(B, 2 * L).astype(np.float32)))
    ref = J.fused_layer(x[0], f[0], ms[0], mf[0], jlp, H, c_real,
                        interpret=True)
    got = P.fused_layer(x[1], f[1], ms[1], mf[1], tlp, H, c_real)
    assert got.dtype == x[1].dtype
    check(got, ref, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("null", [False, True], ids=["plain", "cfg_null"])
def test_fused_branch_matches_pallas(null, dt):
    n_layers, c_real, c_pad = 2, L + 35, 128
    rng = np.random.RandomState(2)
    jlp, tlp = both(weights(c_real, c_pad, 3, n=n_layers), dt)
    cond = rng.randn(B, T, c_pad - L).astype(np.float32)
    cond[..., c_real - L:] = 0.0
    x, c, m = (arr(a, dt) for a in (
        rng.randn(B, T, L).astype(np.float32), cond,
        rng.randn(n_layers, 2, B, 2 * L).astype(np.float32)))
    kw_j, kw_t = {}, {}
    if null:
        ne = rng.randn(1, c_pad).astype(np.float32)
        ne[:, c_real:] = 0.0
        nm = np.array([1.0, 0.0], np.float32)    # first half unconditional
        kw_j = dict(null_emb=arr(ne, dt)[0], null_mask=jnp.asarray(nm))
        kw_t = dict(null_emb=arr(ne, dt)[1], null_mask=torch.tensor(nm))
    ref = J.fused_branch(x[0], c[0], m[0], jlp, H, c_real, interpret=True,
                         **kw_j)
    got = P.fused_branch(x[1], c[1], m[1], tlp, H, c_real, **kw_t)
    check(got, ref, dt)


def test_per_layer_null_substitution_matches_pallas():
    # the per-layer path substitutes null rows with where() before padding
    c_real, c_pad = L + 35, 128
    rng = np.random.RandomState(4)
    jlp, tlp = both(weights(c_real, c_pad, 5), "f32")
    x = rng.randn(B, T, L).astype(np.float32)
    cond = rng.randn(B, T, c_real - L).astype(np.float32)
    null = rng.randn(1, c_real).astype(np.float32)
    feats = np.concatenate([x, cond], -1)
    feats[0] = null                                  # row 0 unconditional
    feats = np.pad(feats, ((0, 0), (0, 0), (0, c_pad - c_real)))
    ms, mf = rng.randn(2, B, 2 * L).astype(np.float32)
    ref = J.fused_layer(jnp.asarray(x), jnp.asarray(feats), jnp.asarray(ms),
                        jnp.asarray(mf), jlp, H, c_real, interpret=True)
    got = P.fused_layer(torch.tensor(x), torch.tensor(feats), torch.tensor(ms),
                        torch.tensor(mf), tlp, H, c_real)
    check(got, ref, "f32")


def test_chain_equals_per_layer():
    n_layers, c_real, c_pad = 3, L + 35, 128
    rng = np.random.RandomState(6)
    _, slp = both(weights(c_real, c_pad, 7, n=n_layers), "f32")
    x = torch.tensor(rng.randn(B, T, L).astype(np.float32))
    cond = torch.tensor(rng.randn(B, T, c_pad - L).astype(np.float32))
    cond[..., c_real - L:] = 0.0
    mods = torch.tensor(rng.randn(n_layers, 2, B, 2 * L).astype(np.float32))
    chain = P.fused_branch(x, cond, mods, slp, H, c_real)
    h = x
    for i in range(n_layers):
        feats = torch.cat([h, cond], -1)
        h = P.fused_layer(h, feats, mods[i, 0], mods[i, 1],
                          P.layer_at(slp, i), H, c_real)
    np.testing.assert_array_equal(chain.numpy(), h.numpy())


def test_gelu_matches_jax():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    np.testing.assert_allclose(P.gelu_as(torch.tensor(x)).numpy(),
                               np.asarray(J._gelu_exact(jnp.asarray(x))),
                               atol=1e-6)


def test_cpu_tensors_do_not_launch():
    _, tlp = both(weights(128, 128, 9), "f32")
    before = (P.fused_layer.launches, P.fused_branch.launches)
    P.fused_layer(torch.zeros(B, T, L), torch.zeros(B, T, 128),
                  torch.zeros(B, 2 * L), torch.zeros(B, 2 * L), tlp, H, 128)
    assert (P.fused_layer.launches, P.fused_branch.launches) == before


def test_traced_build_is_a_second_library_of_the_same_source():
    # the stamps are compiled only into a build of their own, so launches
    # that are not traced run code without them
    from diffsheg_tpu_torch.ops import build
    plain, traced = (build._split(s) for s in (P.KERNEL_SOURCE,
                                               build.TRACED_FUSED_LAYER))
    assert plain[0] == traced[0] and plain[0].exists()
    assert plain[1] == () and traced[1] == ("-DDIFFSHEG_TRACE",)
    assert build._target(P.KERNEL_SOURCE) != build._target(
        build.TRACED_FUSED_LAYER)
    assert set(build.BUILDS) >= {P.KERNEL_SOURCE, build.TRACED_FUSED_LAYER}
