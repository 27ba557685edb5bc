"""Port parity at the last shapes the JAX kernels take that the layer and
linear-attention kernels took only in their ragged forms: widths off a
multiple of 16 and heads wider than one chunk.

- The plain layer and branch (what ``fused_layer`` / ``fused_branch`` run
  on CPU tensors) against JAX's Pallas kernels in interpret mode at L 40 /
  5 heads / F 80 and L 36 / 4 heads / F 72 (hd 9; Cp 80 and 72, also off
  16), with null rows and with int8 codes: f32, rel-RMS <= 1e-5 and
  max-abs <= 1e-5 of max |ref| (the same math, sums in another order).
- Linear attention at (1, 34, 1024) and (2, 88, 1040), one head, against
  the Pallas kernel: f32 rel-RMS <= 1e-5.
- A torch emulation of the ragged build's products (operand columns and
  weight rows zero-filled to a multiple of 16, each matrix's columns in
  items of 8 with the last one narrower, split TF32 in the warps' order)
  and of its ctx column groups: the layer within 1e-6 rel-RMS of the plain
  unpadded layer, the groups bit for bit the whole item's.
- The plans and packs of every new shape (the ragged build, within what
  the kernel checks) and of every shipped shape (the parent's plans, not
  one field moved); the named refusals that remain.
- A two-window stream of a latent-40 model (ff_size 72) through the port's
  generator on the branch kernel's path against JAX's, same weights
  (``load_flax_tree``) and replayed noise: rel-RMS and max-abs <= 1e-5 of
  the window's scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffsheg_tpu.ops import fused_layer as J  # noqa: E402
from diffsheg_tpu.ops.linear_attention import (  # noqa: E402
    fused_linear_attention as j_attention)
from diffsheg_tpu_torch.ops import fused_layer as P  # noqa: E402
from diffsheg_tpu_torch.ops import linear_attention as LA  # noqa: E402
from test_torch_fused_layer import _pack_args, fits_plan  # noqa: E402
from test_torch_long_window import (_inputs, check,  # noqa: E402
                                    chunked_attention)
from test_torch_split_tf32 import split_product  # noqa: E402
from torch_parity import (config_pair, jax_denoiser, rel_rms,  # noqa: E402
                          stream_noise, torch_denoiser)

F32, BF16 = torch.float32, torch.bfloat16

# (B, T, L, heads, F, null rows): hd 8 with every width off 16; hd 9 (not
# a multiple of 8: chunked attention) with a classifier-free pair
CASES = {"L40": (1, 34, 40, 5, 80, False), "L36": (2, 34, 36, 4, 72, True)}


def _both(w, quant):
    """Each package's LayerParams of the same weights, and with ``quant``
    'int8' each quantizes its own copy (codes bit-equal, test_torch_
    quantize.py)."""
    jlp = J.LayerParams(**{k: jnp.asarray(v) for k, v in w.items()})
    tlp = P.LayerParams(**{k: torch.tensor(v) for k, v in w.items()})
    if quant == "none":
        return (jlp, None), (tlp, None)
    return J.quantize_layer_params(jlp, 8), P.quantize_layer_params(tlp, 8)


@pytest.mark.parametrize("case,quant", [("L40", "none"), ("L36", "int8")])
def test_layer_matches_pallas(case, quant):
    B, T, L, H, F, null = CASES[case]
    w, x, cond, ne, nm, c_real = _inputs(B, T, L, F, null, 60)
    feats = np.concatenate([x, cond], -1)
    if null:                                   # null rows substituted
        feats = np.where(nm[:, None, None] > 0, ne[None], feats)
    rng = np.random.RandomState(61)
    ms, mf = (rng.randn(B, 2 * L).astype(np.float32) for _ in range(2))
    (jlp, js), (tlp, ts) = _both(w, quant)
    ref = J.fused_layer(jnp.asarray(x), jnp.asarray(feats), jnp.asarray(ms),
                        jnp.asarray(mf), jlp, H, c_real, sc=js,
                        interpret=True)
    got = P.fused_layer(torch.tensor(x), torch.tensor(feats),
                        torch.tensor(ms), torch.tensor(mf), tlp, H, c_real,
                        sc=ts)
    check(got, ref)


@pytest.mark.parametrize("case,quant", [("L40", "int8"), ("L36", "none")])
def test_branch_matches_pallas(case, quant):
    B, T, L, H, F, null = CASES[case]
    n_layers = 2
    w, x, cond, ne, nm, c_real = _inputs(B, T, L, F, null, 62, n=n_layers)
    mods = np.random.RandomState(63).randn(
        n_layers, 2, B, 2 * L).astype(np.float32)
    (jlp, js), (tlp, ts) = _both(w, quant)
    kw_j = kw_t = {}
    if null:
        kw_j = dict(null_emb=jnp.asarray(ne), null_mask=jnp.asarray(nm))
        kw_t = dict(null_emb=torch.tensor(ne), null_mask=torch.tensor(nm))
    ref = J.fused_branch(jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mods),
                         jlp, H, c_real, ssc=js, interpret=True, **kw_j)
    got = P.fused_branch(torch.tensor(x), torch.tensor(cond),
                         torch.tensor(mods), tlp, H, c_real, ssc=ts, **kw_t)
    check(got, ref)


@pytest.mark.parametrize("B,T,D", [(1, 34, 1024), (2, 88, 1040)],
                         ids=["hd1024", "hd1040"])
def test_wide_head_attention_matches_pallas(B, T, D):
    rng = np.random.RandomState(D)
    q, k, v = (rng.randn(B, T, D).astype(np.float32) for _ in range(3))
    k[:, T - T // 8:] += -1e6                 # masked frames
    ref = np.asarray(j_attention(*(jnp.asarray(a) for a in (q, k, v)), 1,
                                 True))
    got = LA.fused_linear_attention(*(torch.tensor(a) for a in (q, k, v)), 1)
    assert got.shape == (B, T, D)
    assert rel_rms(got.numpy(), ref) <= 1e-5, rel_rms(got.numpy(), ref)


# --------------------------------------------------------------------------
# the ragged build's products and ctx column groups, emulated
# --------------------------------------------------------------------------

def ragged_product(a, w, ncol, warps=8):
    """a @ w as the ragged build computes it in f32: the contraction
    zero-filled to a multiple of 16 (operand columns and weight rows), each
    of the w's matrices of ``ncol`` columns cut into items of 8, the last
    zero-filled past the edge and stored only up to it; each warp's K / 8
    share of the 16-row steps a split-TF32 product, the shares summed in
    warp order."""
    K, N = w.shape
    kq = -(-K // 16) * 16
    a = torch.nn.functional.pad(a, (0, kq - K))
    mats = []
    for m0 in range(0, N, ncol):               # QKV: three matrices
        wm = w[:, m0:m0 + ncol]
        mats.append(torch.nn.functional.pad(wm, (0, -ncol % 8, 0, kq - K)))
    wp = torch.cat(mats, 1)
    steps = kq // 16
    per = -(-steps // warps)
    out = torch.zeros(a.shape[0], wp.shape[1])
    for wi in range(warps):
        k0, k1 = 16 * min(steps, wi * per), 16 * min(steps, (wi + 1) * per)
        if k1 > k0:
            out = out + split_product(a[:, k0:k1], wp[k0:k1])
    keep = torch.cat([torch.arange(i * (ncol + -ncol % 8),
                                   i * (ncol + -ncol % 8) + ncol)
                      for i in range(N // ncol)])
    return out[:, keep]


def emulated_layer(x, feats, ms, mf, lp, H, c_real):
    """P.layer_math (f32) with every product as :func:`ragged_product`."""
    saved = torch.matmul

    def mm(a, w):
        if w.dim() == 2 and a.shape[-1] == w.shape[0]:
            ncol = w.shape[1] // 3 if w.shape[1] == 3 * x.shape[-1] else \
                w.shape[1]
            return ragged_product(a.reshape(-1, w.shape[0]), w, ncol
                                  ).reshape(*a.shape[:-1], w.shape[1])
        return saved(a, w)

    torch.matmul = mm
    try:
        return P.layer_math(x, feats, ms, mf, lp, H, c_real)
    finally:
        torch.matmul = saved


@pytest.mark.parametrize("L,H,F,Cp", [(40, 5, 80, 128), (36, 4, 72, 128),
                                      (520, 8, 1032, 1024)],
                         ids=["L40", "L36", "L520"])
def test_ragged_products_match_plain(L, H, F, Cp):
    c_real = Cp - 21
    gen = torch.Generator().manual_seed(L)
    lp = P.layer_at(P.random_layer_params(1, L, F, Cp, c_real, F32, gen,
                                          "cpu"), 0)
    x = torch.randn(1, 12, L, generator=gen)
    feats = torch.randn(1, 12, Cp, generator=gen)
    feats[..., c_real:] = 0.0
    ms, mf = (0.3 * torch.randn(1, 2 * L, generator=gen) for _ in range(2))
    plain = P.layer_math(x, feats, ms, mf, lp, H, c_real)
    got = emulated_layer(x, feats, ms, mf, lp, H, c_real)
    assert rel_rms(got.numpy(), plain.numpy()) <= 1e-6


def column_groups(q, k, v, tc, dg, cg, cols):
    """y's columns ``cols`` (one item's) as attention_chunks computes them
    with ctx's columns in groups of ``cg``: (a) - (d) once a group, each on
    the group's columns of v alone."""
    return torch.cat([_chunked_columns(q, k, v, tc, dg, cols[c0:c0 + cg])
                      for c0 in range(0, len(cols), cg)], -1)


def _chunked_columns(q, k, v, tc, dg, sel):
    """chunked_attention's y restricted to ctx's columns ``sel``: the
    same sums, each column's from its own column of v."""
    T, hd = k.shape
    vs = torch.zeros(T, hd)
    vs[:, sel] = v[:, sel]
    return chunked_attention(q, k, vs, tc, dg)[:, sel]


@pytest.mark.parametrize("hd,tc,dg", [(264, 4, 33), (100, 8, 25)],
                         ids=["hd264", "hd100"])
def test_ctx_column_groups_order(hd, tc, dg):
    rng = np.random.RandomState(hd)
    T = 34
    q, k, v = (torch.tensor(rng.randn(T, hd).astype(np.float32) * 2.0)
               for _ in range(3))
    k[T - T // 8:] += -1e6
    whole = chunked_attention(q, k, v, tc, dg)
    ctx = torch.einsum("td,te->de", torch.softmax(k, 0), v)
    plain = torch.softmax(q, -1) @ ctx
    # the first item and the head's last (narrower) one
    for c in (0, (hd - 1) // 8):
        cols = list(range(8 * c, min(hd, 8 * c + 8)))
        for cg in (4, 2, 1):
            got = column_groups(q, k, v, tc, dg, cg, cols)
            assert torch.equal(got, whole[:, cols]), (c, cg)
        assert rel_rms(whole[:, cols].numpy(), plain[:, cols].numpy()) <= 1e-6


# --------------------------------------------------------------------------
# plans and packs
# --------------------------------------------------------------------------

# (dtype, qb, B, T, Cp, L, F, heads, ctx column groups): the widths off 16
# (BEAT's at latent 520 / ff_size 1032 too), and one head wider than a
# chunk of 4 frames beside ctx's 8 columns
NEW_SHAPES = [(dt, qb, B, T, 128, L, F, H, 0)
              for dt in (F32, BF16) for qb in (0, 8, 4) for B, T in
              ((1, 34), (2, 34), (1, 300))
              for L, F, H in ((40, 80, 5), (36, 72, 4))] + [
    (dt, qb, 1, 34, 1024, 520, 1032, 8, 0)
    for dt in (F32, BF16) for qb in (0, 8, 4)] + [
    (F32, 0, 1, 34, 4224, 4160, 4160, 1, 4),
    (BF16, 0, 1, 34, 4352, 4224, 4224, 1, 4)]


@pytest.mark.parametrize("shape", NEW_SHAPES, ids=[
    "-".join(map(str, (str(s[0])[6:],) + s[1:])) for s in NEW_SHAPES])
def test_new_shapes_plan_on_the_ragged_build(shape):
    *args, cg = shape
    plan = P.k_pass_plan(*args)
    assert plan.ragged and plan.cg == cg
    assert plan.smem_bytes <= 227 * 1024 and fits_plan(*args, plan)


def _empty_pack_args(B, T, L, H, Cp, F):
    """_pack's arguments for one layer, every tensor allocated and never
    written (only shapes, dtypes and addresses are packed)."""
    shapes = P.LayerParams(
        (Cp,), (Cp,), (Cp, 2 * L), (2 * L,), (2 * L, L), (L,), (L,), (L,),
        (L, L), (L,), (L, L), (L,), (L, L), (L,), (L,), (L,), (L, L), (L,),
        (L, F), (F,), (F, L), (L,), (L,), (L,), (L, L), (L,))
    lp = P.LayerParams(*(torch.empty(s) for s in shapes))
    return (torch.empty(B, T, L), torch.empty(B, T, Cp),
            torch.empty(B, 2 * L), torch.empty(B, 2 * L), 0, lp, 1, H, Cp,
            False, None, None)


@pytest.mark.parametrize("case,args", [
    ("L40", (1, 34, 40, 5, 128, 80)), ("L36", (2, 34, 36, 4, 128, 72)),
    ("L36-Cp72", (1, 34, 36, 4, 72, 72)),
    ("hd4160", (1, 34, 4160, 1, 4224, 4160))])
def test_new_shapes_pack(case, args, monkeypatch):
    # planned and packed without a launch (the shapes _pack refused by
    # name before: "widths must be multiples of 16", and a head too wide
    # for a chunk); a CPU word stands in for the grid barrier's
    monkeypatch.setattr(P, "_barrier_word",
                        lambda dev: torch.zeros(4, dtype=torch.int32))
    B, T, L, H, Cp, F = args
    cargs, out, scratch, plan = P._pack(*_empty_pack_args(*args))
    assert plan.ragged and fits_plan(F32, 0, B, T, Cp, L, F, H, plan)
    assert list(cargs[2])[-3:] == [plan.tc, plan.dg, plan.cg]
    assert out.shape == (B, T, L)


def test_remaining_refusals_are_named(monkeypatch):
    monkeypatch.setattr(P, "_barrier_word",
                        lambda dev: torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="heads must divide"):
        P._pack(*_pack_args(1, 34, 40, 3, 128, 80))
    # int4 codes pack two columns a byte: an odd F (71) has no packing
    args = list(_pack_args(1, 34, 36, 4, 128, 72))
    lp, sc = P.quantize_layer_params(args[5], 4)
    args[5] = lp._replace(ffn_l1_k=lp.ffn_l1_k[:, :35].contiguous(),
                          ffn_l1_b=lp.ffn_l1_b[:71].contiguous(),
                          ffn_l2_k=lp.ffn_l2_k[:71].contiguous())
    with pytest.raises(ValueError, match="must be even"):
        P._pack(*args, sc)
    with pytest.raises(ValueError, match="heads that do not divide|bad shape"):
        LA._launch_plan(1, 34, 1040, 3)
    with pytest.raises(ValueError, match="ctx values"):
        LA._launch_plan(1, 34, 8208, 1)


def test_ragged_launches_take_their_own_build():
    from diffsheg_tpu_torch.ops import build
    plain, ragged = (build._split(s) for s in (P.KERNEL_SOURCE,
                                               build.RAGGED_FUSED_LAYER))
    assert plain[0] == ragged[0] and ragged[1] == ("-DDIFFSHEG_RAGGED",)
    assert build.RAGGED_FUSED_LAYER in build.BUILDS
    assert P._REFUSALS[-5].startswith("a width off a multiple of 16")
    with pytest.raises(ValueError, match="traced build"):
        P._lib(traced=True, ragged=True)


# every shape PERF.md's table times, as the parent commit planned it
# (dtype, qb, B, T, Cp, L, F, heads) -> (kp, passes, a_elems, w_off,
# part_off, smem_bytes, tc, dg)
SHIPPED_PLANS = [
    ((F32, 0, 1, 34, 1024, 512, 1024, 8),
     (1024, 1, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 0, 1, 34, 896, 512, 1024, 8),
     (1024, 1, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 0, 2, 88, 1024, 512, 1024, 8),
     (1024, 1, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 0, 1, 12, 1024, 512, 1024, 8),
     (1024, 1, 16640, 66560, 132096, 148480, 0, 0)),
    ((F32, 0, 4, 34, 1024, 512, 1024, 8),
     (1024, 1, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 0, 7, 34, 1024, 512, 1024, 8),
     (1024, 1, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 8, 1, 34, 1024, 512, 1024, 8),
     (1024, 1, 41600, 166400, 199168, 228800, 0, 0)),
    ((F32, 8, 1, 34, 896, 512, 1024, 8),
     (1024, 1, 41600, 166400, 199168, 228800, 0, 0)),
    ((F32, 8, 2, 88, 1024, 512, 1024, 8),
     (1024, 1, 41600, 166400, 199168, 228800, 0, 0)),
    ((F32, 8, 1, 12, 1024, 512, 1024, 8),
     (1024, 1, 16640, 66560, 99328, 128960, 0, 0)),
    ((F32, 8, 4, 34, 1024, 512, 1024, 8),
     (1024, 1, 41600, 166400, 199168, 228800, 0, 0)),
    ((F32, 8, 7, 34, 1024, 512, 1024, 8),
     (1024, 1, 41600, 166400, 199168, 228800, 0, 0)),
    ((F32, 4, 1, 34, 1024, 512, 1024, 8),
     (1024, 1, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 4, 1, 34, 896, 512, 1024, 8),
     (1024, 1, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 4, 2, 88, 1024, 512, 1024, 8),
     (1024, 1, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 4, 1, 12, 1024, 512, 1024, 8),
     (1024, 1, 16640, 66560, 132096, 148480, 0, 0)),
    ((F32, 4, 4, 34, 1024, 512, 1024, 8),
     (1024, 1, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 4, 7, 34, 1024, 512, 1024, 8),
     (1024, 1, 36400, 145600, 211136, 227520, 0, 0)),
    ((BF16, 0, 1, 34, 1024, 512, 1024, 8),
     (1024, 1, 49536, 99072, 115456, 131840, 0, 0)),
    ((BF16, 0, 1, 34, 896, 512, 1024, 8),
     (1024, 1, 49536, 99072, 115456, 131840, 0, 0)),
    ((BF16, 0, 2, 88, 1024, 512, 1024, 8),
     (1024, 1, 66048, 132096, 148480, 164864, 0, 0)),
    ((BF16, 0, 1, 12, 1024, 512, 1024, 8),
     (1024, 1, 16512, 33024, 49408, 65792, 0, 0)),
    ((BF16, 0, 4, 34, 1024, 512, 1024, 8),
     (1024, 1, 66048, 132096, 148480, 164864, 0, 0)),
    ((BF16, 0, 7, 34, 1024, 512, 1024, 8),
     (1024, 1, 66048, 132096, 148480, 164864, 0, 0)),
    ((BF16, 8, 1, 34, 1024, 512, 1024, 8),
     (1024, 1, 49536, 99072, 115456, 131840, 0, 0)),
    ((BF16, 8, 1, 34, 896, 512, 1024, 8),
     (1024, 1, 49536, 99072, 115456, 131840, 0, 0)),
    ((BF16, 8, 2, 88, 1024, 512, 1024, 8),
     (1024, 1, 66048, 132096, 148480, 164864, 0, 0)),
    ((BF16, 8, 1, 12, 1024, 512, 1024, 8),
     (1024, 1, 16512, 33024, 49408, 65792, 0, 0)),
    ((BF16, 8, 4, 34, 1024, 512, 1024, 8),
     (1024, 1, 66048, 132096, 148480, 164864, 0, 0)),
    ((BF16, 8, 7, 34, 1024, 512, 1024, 8),
     (1024, 1, 66048, 132096, 148480, 164864, 0, 0)),
    ((BF16, 4, 1, 34, 1024, 512, 1024, 8),
     (1024, 1, 49536, 99072, 131840, 148224, 0, 0)),
    ((BF16, 4, 1, 34, 896, 512, 1024, 8),
     (1024, 1, 49536, 99072, 131840, 148224, 0, 0)),
    ((BF16, 4, 2, 88, 1024, 512, 1024, 8),
     (1024, 1, 66048, 132096, 164864, 181248, 0, 0)),
    ((BF16, 4, 1, 12, 1024, 512, 1024, 8),
     (1024, 1, 16512, 33024, 65792, 82176, 0, 0)),
    ((BF16, 4, 4, 34, 1024, 512, 1024, 8),
     (1024, 1, 66048, 132096, 164864, 181248, 0, 0)),
    ((BF16, 4, 7, 34, 1024, 512, 1024, 8),
     (1024, 1, 66048, 132096, 164864, 181248, 0, 0)),
    ((F32, 0, 21, 12, 128, 32, 64, 4),
     (128, 1, 9216, 36864, 45056, 61440, 0, 0)),
    ((F32, 0, 1, 12, 128, 32, 64, 4),
     (128, 1, 2304, 9216, 17408, 33792, 0, 0)),
    ((F32, 0, 1, 34, 512, 128, 256, 4),
     (512, 1, 25344, 101376, 134144, 150528, 0, 0)),
    ((F32, 0, 1, 34, 1792, 512, 1024, 8),
     (1024, 2, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 0, 1, 34, 1920, 512, 1024, 8),
     (1024, 2, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 0, 4, 34, 1920, 512, 1024, 8),
     (1024, 2, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 0, 1, 34, 1024, 512, 2048, 8),
     (1024, 2, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 8, 1, 34, 1792, 512, 1024, 8),
     (1792, 1, 30736, 122944, 180288, 231424, 0, 0)),
    ((F32, 8, 1, 34, 1920, 512, 1024, 8),
     (1024, 2, 41600, 166400, 199168, 228800, 0, 0)),
    ((F32, 8, 4, 34, 1920, 512, 1024, 8),
     (1024, 2, 41600, 166400, 199168, 228800, 0, 0)),
    ((F32, 8, 1, 34, 1024, 512, 2048, 8),
     (1024, 2, 41600, 166400, 199168, 228800, 0, 0)),
    ((F32, 4, 1, 34, 1792, 512, 1024, 8),
     (1024, 2, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 4, 1, 34, 1920, 512, 1024, 8),
     (1024, 2, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 4, 4, 34, 1920, 512, 1024, 8),
     (1024, 2, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 4, 1, 34, 1024, 512, 2048, 8),
     (1024, 2, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 0, 1, 300, 1024, 512, 1024, 8),
     (1024, 1, 36400, 145600, 211136, 227520, 300, 64)),
    ((F32, 8, 1, 300, 1024, 512, 1024, 8),
     (1024, 1, 41600, 167648, 200416, 228800, 0, 0)),
    ((BF16, 0, 1, 300, 1024, 512, 1024, 8),
     (1024, 1, 66048, 167648, 184032, 200416, 0, 0)),
    ((BF16, 8, 1, 300, 1024, 512, 1024, 8),
     (1024, 1, 66048, 167648, 184032, 200416, 0, 0)),
    ((F32, 0, 2, 352, 1024, 512, 1024, 8),
     (1024, 1, 36400, 145600, 211136, 227520, 352, 64)),
    ((BF16, 0, 2, 352, 1024, 512, 1024, 8),
     (1024, 1, 66048, 196352, 212736, 229120, 0, 0)),
    ((F32, 0, 1, 256, 1536, 1024, 1024, 8),
     (1024, 2, 36400, 148352, 213888, 230272, 224, 128)),
    ((F32, 0, 1, 34, 1664, 1152, 1024, 8),
     (1024, 3, 36400, 145600, 211136, 227520, 0, 0)),
    ((F32, 0, 1, 300, 1664, 1152, 1024, 8),
     (1024, 3, 36400, 148752, 214288, 230672, 196, 144)),
    ((F32, 0, 1, 88, 224, 96, 192, 8),
     (224, 1, 15360, 61440, 75776, 92160, 88, 12)),
    ((F32, 0, 1, 34, 1536, 1024, 1024, 1),
     (1024, 2, 36400, 145600, 211136, 227520, 4, 512)),
    ((BF16, 0, 1, 34, 1920, 512, 1024, 8),
     (1920, 1, 61696, 123392, 154112, 170496, 0, 0)),
    ((BF16, 0, 1, 34, 1024, 512, 6144, 8),
     (1024, 6, 49536, 99072, 115456, 131840, 0, 0)),
]


def test_shipped_plans_are_the_parents():
    for shape, want in SHIPPED_PLANS:
        plan = P.k_pass_plan(*shape)
        assert tuple(plan)[:8] == want, (shape, plan)
        assert plan.cg == 0 and not plan.ragged, (shape, plan)


@pytest.mark.parametrize("shape", [(1, 34, 512, 8), (2, 88, 512, 8),
                                   (750, 34, 128, 8), (1, 512, 512, 8),
                                   (2, 34, 256, 8), (1, 34, 1152, 8),
                                   (2, 352, 1152, 8), (1, 34, 512, 1)])
def test_attention_plans_keep_their_kernels(shape):
    # every head a block's threads cover: one thread a column of k, as
    # before; only wider heads take the wide kernels
    plan = LA._launch_plan(*shape)
    B, T, D, H = shape
    assert plan.heads * (D // H) <= plan.threads


@pytest.mark.parametrize("shape", [(1, 34, 1024, 1), (2, 88, 1040, 1),
                                   (1, 12, 1024, 1), (1, 34, 8192, 1)])
def test_wide_head_attention_plans(shape):
    B, T, D, H = shape
    plan = LA._launch_plan(*shape)
    assert plan.threads == 512 and plan.heads == 1 and D > plan.threads
    assert D * plan.width <= plan.threads * 16
    assert plan.smem_bytes == LA._smem_bytes(D, 1, plan.width,
                                             plan.tile_rows,
                                             plan.mode == "staged")
    assert plan.smem_bytes <= 232448 and plan.grid == B * (D // plan.width)


# --------------------------------------------------------------------------
# a stream of a latent-40 model
# --------------------------------------------------------------------------

def test_latent40_stream_matches_jax():
    # two windows (0 and 30) of a 64-frame stream through the branch
    # kernel's path (its plain version on the CPU): L 40, 4 heads (hd 10),
    # ff_size 72; one layer a branch and DDIM-5 keep JAX's compile short
    from diffsheg_tpu.sampling.generator import WindowGenerator as JGen
    from diffsheg_tpu.sampling.streamer import StreamingGenerator as JS
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator as PGen
    from diffsheg_tpu_torch.sampling.streamer import (StreamingGenerator as PS,
                                                      window_starts)
    jcfg, tcfg = config_pair("beat", model={"latent_dim": 40, "ff_size": 72,
                                            "num_layers": 1},
                             diffusion={"jump_n_sample": 2,
                                        "respacing": "ddim5"})
    tcfg = tcfg.replace(diffusion=dataclasses.replace(tcfg.diffusion,
                                                      fused_layer="chain"))
    variables = jax_denoiser(jcfg, seed=64)
    jgen = JGen(jcfg, jax.tree.map(jnp.asarray, variables))
    pgen = PGen(tcfg, torch_denoiser(tcfg, variables), device="cpu")
    assert pgen.use_fast
    m = jcfg.model
    rng = np.random.RandomState(65)
    T, W = 64, jcfg.data.n_poses
    starts = window_starts(T, W, W - jcfg.stream.overlap_len)
    assert starts == [0, 30]
    mel = rng.randn(1, T, m.audio_dim).astype(np.float32)
    hub = rng.randn(1, T, m.hubert_dim).astype(np.float32)
    pid = np.eye(m.style_dim, dtype=np.float32)[[2]]
    key = jax.random.PRNGKey(66)
    ref = np.asarray(JS(jgen).generate_fused(
        jnp.asarray(mel), jnp.asarray(pid), key, jnp.asarray(hub)))
    noise = stream_noise(key, len(starts), 1, W, m.motion_dim, jgen._plain,
                         jgen._harmonize)
    before = P.fused_branch.launches
    got = PS(pgen).generate_fused(torch.tensor(mel), torch.tensor(pid),
                                  noise, torch.tensor(hub)).numpy()
    assert P.fused_branch.launches == before          # CPU: no launch
    assert got.shape == ref.shape == (1, T, m.motion_dim)
    assert np.isfinite(got).all()
    err = rel_rms(got, ref), np.abs(got - ref).max() / np.abs(ref).max()
    assert err[0] <= 1e-5 and err[1] <= 1e-5, err
