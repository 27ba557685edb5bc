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


# --------------------------------------------------------------------------
# the kernel's shared-memory plan (k_pass_plan), checked on the host
# --------------------------------------------------------------------------

F32, BF16 = torch.float32, torch.bfloat16

# (dtype, qb, B, T, Cp, L, F, heads): every kernel shape PERF.md's table
# times (the branch and per-layer kernels at BEAT, SHOW, live, cli generate,
# evaluation and the examples' widths, bf16 / f32, int8 / int4)
SHIPPED = [(dt, qb, B, T, Cp, 512, 1024, 8)
           for dt in (F32, BF16) for qb in (0, 8, 4)
           for B, T, Cp in ((1, 34, 1024), (1, 34, 896), (2, 88, 1024),
                            (1, 12, 1024), (4, 34, 1024), (7, 34, 1024))] + [
    (F32, 0, 21, 12, 128, 32, 64, 4), (F32, 0, 1, 12, 128, 32, 64, 4),
    (F32, 0, 1, 34, 512, 128, 256, 4)]
# f32 widths past one pass: raw HuBERT features (BEAT expression 1792,
# gesture 1920 at one window and cli generate's four), ff_size 2048
WIDE_F32 = [(1, 34, 1792, 1024), (1, 34, 1920, 1024), (4, 34, 1920, 1024),
            (1, 34, 1024, 2048)]


def fits_plan(dt, qb, B, T, Cp, L, F, H, plan):
    """The kernel's own check of a plan (csrc ``fits_plan``), transcribed:
    the room for the operand rows it reads, the attention tiles (the whole
    window's, or chunks of tc frames and k feature groups of dg), the weight
    slice and the warps' partial tiles."""
    es = dt.itemsize
    kmax = max(Cp, 2 * L, F, L)
    lda = plan.kp + 8 if es == 2 else plan.kp + 16 - plan.kp % 32
    rows = plan.a_elems // lda
    hd = L // H
    if plan.tc == 0:
        if hd % 8:
            return False
        attn = 4 * (2 * T * (hd + 1) + T * 8 + hd * 8)
    else:
        if not (1 <= plan.tc <= T and (plan.tc == T or plan.tc % 4 == 0)
                and 1 <= plan.dg <= hd):
            return False
        attn = 4 * (plan.tc * (hd + 1 + 8) + hd * 8 + plan.dg * (4 * 8 + 10))
    wbytes = (4 * 8 * plan.kp * (1 if qb == 8 else 2) if es == 4
              else 2 * 8 * plan.kp * (2 if qb == 4 else 1))
    reach = es * lda * ((rows + 15) // 16 * 16)
    return (16 <= plan.kp <= kmax and plan.kp % 16 == 0
            and plan.smem_bytes <= P._SMEM_CAP and plan.w_off % 16 == 0
            and rows >= 16 and plan.w_off >= max(es * plan.a_elems, attn)
            and plan.part_off >= plan.w_off + wbytes
            and plan.smem_bytes >= plan.part_off + 4 * 8 * 64 * 8
            and plan.smem_bytes >= reach
            and plan.passes == -(-kmax // plan.kp))


@pytest.mark.parametrize("shape", SHIPPED)
def test_shipped_shapes_take_one_pass(shape):
    plan = P.k_pass_plan(*shape)
    dt, qb, B, T, Cp, L, F, H = shape
    assert plan.passes == 1 and plan.kp == max(Cp, 2 * L, F)
    assert fits_plan(*shape, plan)


@pytest.mark.parametrize("qb", [0, 8, 4])
@pytest.mark.parametrize("B,T,Cp,F", WIDE_F32)
def test_wide_f32_takes_passes(B, T, Cp, F, qb):
    shape = (F32, qb, B, T, Cp, 512, F, 8)
    plan = P.k_pass_plan(*shape)
    if qb == 8 and max(Cp, F) <= 1840:     # int8 codes: one slice tile
        assert plan.passes == 1
        return
    assert plan.passes == 2 and plan.kp == 1024
    assert fits_plan(*shape, plan)
    # the pass width keeps a 34-row window staged whole
    assert plan.a_elems // (plan.kp + 16) >= 34


def test_bf16_takes_passes_past_its_one_pass_widths():
    # one pass up to 4464 (3344 with int4 codes), passes of 1024 above
    for qb, edge in ((0, 4464), (8, 4464), (4, 3344)):
        for F, passes in ((edge, 1), (edge + 16, -(-(edge + 16) // 1024))):
            plan = P.k_pass_plan(BF16, qb, 1, 34, 1024, 512, F, 8)
            assert plan.passes == passes, (qb, F, plan)
    assert P.k_pass_plan(BF16, 0, 1, 34, 1024, 512, 6144, 8).passes == 6


def test_no_plan_exceeds_shared_memory():
    # widths 16 .. 8192 on each axis, windows up to 352 frames, heads 12,
    # 64, 128 and 144 wide: a plan the kernel takes, within 227 KB, and
    # none refused (the JAX kernels take every one of these shapes)
    rows = ((1, 1), (1, 16), (1, 34), (2, 32), (4, 34), (7, 34), (1, 88),
            (2, 88), (2, 128), (1, 256), (1, 264), (1, 300), (1, 352))
    refused = []
    for w in range(16, 8193, 16):
        widths = [(w, 16, 16, 2), (max(w, 512), 512, w, 8)]
        if w % 128 == 0:     # heads 64 and 128 wide
            widths += [(w, w, w, max(1, w // 64)), (w, w, w, w // 128)]
        if w % 48 == 0:      # heads 12 wide
            widths.append((w, w, w, w // 12))
        if w % 144 == 0:     # heads 144 wide
            widths.append((w, w, w, w // 144))
        for dt in (F32, BF16):
            for qb in (0, 8, 4):
                for B, T in rows:
                    for Cp, L, F, H in widths:
                        try:
                            plan = P.k_pass_plan(dt, qb, B, T, Cp, L, F, H)
                        except ValueError:
                            refused.append((dt, qb, B, T, Cp, L, F, H))
                            continue
                        assert plan.smem_bytes <= 227 * 1024
                        assert fits_plan(dt, qb, B, T, Cp, L, F, H, plan), (
                            dt, qb, B, T, Cp, L, F, H, plan)
    assert not refused, refused[:5]


def _pack_args(B, T, L, H, Cp, F, dt=F32):
    gen = torch.Generator().manual_seed(0)
    lp = P.layer_at(P.random_layer_params(1, L, F, Cp, Cp, dt, gen, "cpu"),
                    0)
    return (torch.zeros(B, T, L, dtype=dt), torch.zeros(B, T, Cp, dtype=dt),
            torch.zeros(B, 2 * L, dtype=dt), torch.zeros(B, 2 * L, dtype=dt),
            0, lp, 1, H, Cp, False, None, None)


@pytest.mark.parametrize("case,args,chunked", [
    # the shapes the kernel once refused by name, each of which the JAX
    # kernel takes, now planned: a window past 256 frames and a head
    # wider than 128 (each the whole window in one tile at these widths),
    # and a 256-frame window of 128-wide heads, whose tiles outgrow shared
    # memory (in chunks of T)
    ("window", (1, 264, 64, 4, 128, 128), False),
    ("head", (1, 34, 144, 1, 256, 128), False),
    ("attention", (1, 256, 1024, 8, 1024, 1024), True),
], ids=lambda v: v if isinstance(v, str) else "")
def test_pack_refuses_by_name(case, args, chunked, monkeypatch):
    # planned and packed without a launch: CPU tensors suffice, and a CPU
    # word stands in for the grid barrier's
    monkeypatch.setattr(P, "_barrier_word",
                        lambda dev: torch.zeros(4, dtype=torch.int32))
    B, T, L, H, Cp, F = args
    cargs, out, scratch, plan = P._pack(*_pack_args(*args))
    assert plan.smem_bytes <= 227 * 1024
    assert fits_plan(F32, 0, B, T, Cp, L, F, H, plan)
    assert (0 < plan.tc < T) == chunked
    ints = list(cargs[2])
    assert ints[-2:] == [plan.tc, plan.dg] and out.shape == (B, T, L)
    # the kernel's scratch: 8 f32 rows of L, then the operands, per row
    assert scratch.numel() == B * T * (8 * L * 4 + (L + max(2 * L, F)
                                                     + max(Cp, L)) * 4)


def test_refusal_codes_are_named():
    args = _pack_args(1, 34, 64, 4, 128, 128)
    plan = P.k_pass_plan(F32, 0, 1, 34, 128, 64, 128, 4)
    ints = [0] * len(P.LayerParams._fields) + [
        0, 0, 1, 1, 34, 64, 128, 128, 128, 4, 0]
    cargs = (0, None, ints)
    for code, text in P._REFUSALS.items():
        msg = P._refused(code, args[0], plan, cargs)
        assert text in msg and "CUDA error" not in msg
        assert "Cp=128" in msg and "heads=4" in msg
    assert "CUDA error 2" in P._refused(2, args[0], plan, cargs)
