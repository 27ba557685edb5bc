"""Port parity at the windows and head widths the layer kernels take in
chunks of T: windows past 256 frames and heads 12 and 144 wide.

- The plain layer and branch (what ``fused_layer`` / ``fused_branch`` run
  on CPU tensors) against JAX's Pallas kernels in interpret mode at T 300,
  (2, 264) with null rows, hd 12 (L 96, 8 heads) and hd 144 (L 144, one
  head): f32, rel-RMS <= 1e-5 and max-abs <= 1e-5 of max |ref| (the same
  math, sums in another order).
- The kernel's shared-memory plan at every window up to 352 frames and
  heads 12, 64, 128 and 144 wide at BEAT's and SHOW's widths: planned,
  never refused, within what the kernel checks.
- A torch emulation of the order in which csrc ``attention_chunks`` adds
  (each feature's softmax over time in four parts, ctx's four partial sums
  carried across chunks, the rnd points): every chunking equal bit for bit
  to the one-tile order, and within 1e-6 rel-RMS (f32) of the plain
  attention at T 352, hd 64 and hd 144.
- A 264-frame window stream through the port's generator on the branch
  kernel's path against JAX's on the same weights (``load_flax_tree``)
  and replayed noise: rel-RMS and max-abs <= 1e-5 of the window's scale
  (see test_torch_sampler.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffsheg_tpu.ops import fused_layer as J  # noqa: E402
from diffsheg_tpu_torch.ops import fused_layer as P  # noqa: E402
from test_torch_fused_layer import SHIPPED, fits_plan  # noqa: E402
from torch_parity import (config_pair, jax_denoiser, rel_rms,  # noqa: E402
                          stream_noise, torch_denoiser)


def weights(L, F, c_real, c_pad, seed, n=None):
    """Seeded numpy weights of one layer (``n``: a stack), every leaf
    perturbed, the padded feats channels zero."""
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


def check(got, ref):
    g, r = got.numpy(), np.asarray(ref)
    assert g.shape == r.shape and np.isfinite(g).all()
    err = rel_rms(g, r), np.abs(g - r).max() / np.abs(r).max()
    assert err[0] <= 1e-5 and err[1] <= 1e-5, err


# (B, T, L, heads, F, null rows): a 300-frame window, a classifier-free
# pair of 264-frame windows (the first row null), heads 12 and 144 wide
CASES = {"t300": (1, 300, 64, 4, 128, False),
         "t264-cfg": (2, 264, 64, 4, 128, True),
         "hd12": (1, 88, 96, 8, 192, False),
         "hd144": (2, 34, 144, 1, 288, True)}


def _inputs(B, T, L, F, null, seed, n=None):
    c_pad = 2 * L
    c_real = c_pad - 13
    rng = np.random.RandomState(seed)
    w = weights(L, F, c_real, c_pad, seed + 1, n)
    x = rng.randn(B, T, L).astype(np.float32)
    cond = rng.randn(B, T, c_pad - L).astype(np.float32)
    cond[..., c_real - L:] = 0.0
    ne = rng.randn(1, c_pad).astype(np.float32)
    ne[:, c_real:] = 0.0
    nm = (np.arange(B) < B // 2).astype(np.float32) if null else None
    return w, x, cond, ne, nm, c_real


@pytest.mark.parametrize("case", list(CASES))
def test_layer_matches_pallas(case):
    B, T, L, H, F, null = CASES[case]
    w, x, cond, ne, nm, c_real = _inputs(B, T, L, F, null, 40)
    feats = np.concatenate([x, cond], -1)
    if null:                                   # null rows substituted
        feats = np.where(nm[:, None, None] > 0, ne[None], feats)
    rng = np.random.RandomState(41)
    ms, mf = (rng.randn(B, 2 * L).astype(np.float32) for _ in range(2))
    jlp = J.LayerParams(**{k: jnp.asarray(v) for k, v in w.items()})
    tlp = P.LayerParams(**{k: torch.tensor(v) for k, v in w.items()})
    ref = J.fused_layer(jnp.asarray(x), jnp.asarray(feats), jnp.asarray(ms),
                        jnp.asarray(mf), jlp, H, c_real, interpret=True)
    got = P.fused_layer(torch.tensor(x), torch.tensor(feats),
                        torch.tensor(ms), torch.tensor(mf), tlp, H, c_real)
    check(got, ref)


@pytest.mark.parametrize("case", list(CASES))
def test_branch_matches_pallas(case):
    B, T, L, H, F, null = CASES[case]
    n_layers = 2
    w, x, cond, ne, nm, c_real = _inputs(B, T, L, F, null, 42, n=n_layers)
    mods = np.random.RandomState(43).randn(
        n_layers, 2, B, 2 * L).astype(np.float32)
    jlp = J.LayerParams(**{k: jnp.asarray(v) for k, v in w.items()})
    tlp = P.LayerParams(**{k: torch.tensor(v) for k, v in w.items()})
    kw_j = kw_t = {}
    if null:
        kw_j = dict(null_emb=jnp.asarray(ne), null_mask=jnp.asarray(nm))
        kw_t = dict(null_emb=torch.tensor(ne), null_mask=torch.tensor(nm))
    ref = J.fused_branch(jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mods),
                         jlp, H, c_real, interpret=True, **kw_j)
    got = P.fused_branch(torch.tensor(x), torch.tensor(cond),
                         torch.tensor(mods), tlp, H, c_real, **kw_t)
    check(got, ref)


# --------------------------------------------------------------------------
# the plan at every window and head width the JAX kernel takes
# --------------------------------------------------------------------------

F32, BF16 = torch.float32, torch.bfloat16
WINDOWS = [(1, T) for T in (1, 12, 34, 88, 255, 256, 257, 264, 268, 300, 352)
           ] + [(2, 88), (2, 264), (2, 352), (4, 34), (7, 34)]
# (Cp beyond L, F) of BEAT's expression and gesture branches and SHOW's
# branches (feats padded to 1024 at L 512)
BRANCHES = ((384, 1024), (512, 1024))


@pytest.mark.parametrize("hd,H", [(12, 8), (12, 4), (64, 8), (128, 8),
                                  (128, 4), (144, 8), (144, 4)])
def test_every_window_and_head_plans(hd, H):
    L = hd * H
    for dt in (F32, BF16):
        for qb in (0, 8, 4):
            for B, T in WINDOWS:
                for extra, F in BRANCHES:
                    shape = (dt, qb, B, T, L + extra, L, F, H)
                    plan = P.k_pass_plan(*shape)
                    assert fits_plan(*shape, plan), (shape, plan)


@pytest.mark.parametrize("shape", SHIPPED)
def test_shipped_shapes_keep_the_one_tile_attention(shape):
    # every shape the kernel ran before chunks existed: the same plan, the
    # whole window in one tile (csrc attention, the code it ran before)
    plan = P.k_pass_plan(*shape)
    assert plan.tc == plan.dg == 0


def test_shipped_launch_groups():
    # a batch is split into launches of whole windows, 256 rows a launch;
    # a longer window is a launch of its own
    assert P._batch_groups(7, 34) == [slice(0, 7)]
    assert P._batch_groups(8, 34) == [slice(0, 7), slice(7, 8)]
    assert P._batch_groups(2, 88) == [slice(0, 2)]
    assert P._batch_groups(2, 352) == [slice(0, 1), slice(1, 2)]


# --------------------------------------------------------------------------
# the order in which csrc attention_chunks adds, emulated
# --------------------------------------------------------------------------

def _fma(a, b, c):
    """fmaf: the product exact in f64, then rounded once to f32."""
    return (a.double() * b.double() + c.double()).float()


def _exp(x):
    """expf of f32 values, the same for an element wherever it lies (f64
    exp, rounded)."""
    return torch.exp(x.double()).float()


def chunked_attention(q, k, v, tc, dg):
    """y of one (batch row, head) as attention_chunks computes it in f32:
    q, k, v (T, hd); chunks of ``tc`` frames (a multiple of 4, or T), k
    features in groups of ``dg``, ctx columns in items of 8."""
    T, hd = k.shape
    parts, AC = 4, 8
    ctx = torch.zeros(hd, hd)
    for g0 in range(0, hd, dg):
        kg = k[:, g0:g0 + dg]
        gw = kg.shape[1]
        mx = torch.full((gw, parts), -torch.finfo(torch.float32).max)
        sx = torch.zeros(gw, parts)
        for t0 in range(0, T, tc):            # (a) each part's max
            for t in range(t0, min(T, t0 + tc)):
                mx[:, t % 4] = torch.maximum(mx[:, t % 4], kg[t])
        md = torch.maximum(torch.maximum(mx[:, 0], mx[:, 1]),
                           torch.maximum(mx[:, 2], mx[:, 3]))
        for t0 in range(0, T, tc):            # (b) each part's sum, in order
            for t in range(t0, min(T, t0 + tc)):
                sx[:, t % 4] = sx[:, t % 4] + _exp(kg[t] - md)
        sd = (sx[:, 0] + sx[:, 1]) + (sx[:, 2] + sx[:, 3])
        acc = torch.zeros(4, gw, hd)          # (c) ctx's partial sums
        for t0 in range(0, T, tc):
            rows = min(tc, T - t0)
            kp = _exp(kg[t0:t0 + rows] - md) / sd
            vc = v[t0:t0 + rows]
            quads = rows // 4 * 4
            for t in range(0, quads, 4):
                for j in range(4):
                    acc[j] = _fma(kp[t + j][:, None], vc[t + j][None], acc[j])
            for t in range(quads, rows):
                acc[0] = _fma(kp[t][:, None], vc[t][None], acc[0])
        ctx[g0:g0 + gw] = (acc[0] + acc[1]) + (acc[2] + acc[3])
    qp = torch.softmax(q, -1)                 # (d) per frame, then y
    y = torch.zeros(4, T, hd)
    for d in range(0, hd // 4 * 4, 4):
        for j in range(4):
            y[j] = _fma(qp[:, d + j][:, None], ctx[d + j][None], y[j])
    for d in range(hd // 4 * 4, hd):
        y[0] = _fma(qp[:, d][:, None], ctx[d][None], y[0])
    assert AC == 8     # an item's columns only select which of y is written
    return (y[0] + y[1]) + (y[2] + y[3])


@pytest.mark.parametrize("T,hd,chunks", [
    (352, 64, [(352, 64), (96, 64), (100, 32), (4, 64)]),
    (352, 144, [(352, 144), (196, 144), (120, 72), (48, 5)]),
    (90, 12, [(90, 12), (8, 12), (12, 5)])], ids=["T352-hd64",
                                                  "T352-hd144", "T90-hd12"])
def test_chunked_attention_order(T, hd, chunks):
    rng = np.random.RandomState(T + hd)
    q, k, v = (torch.tensor(rng.randn(T, hd).astype(np.float32) * 2.0)
               for _ in range(3))
    k[T - T // 8:] += -1e6                    # masked frames, as padding gets
    whole = chunked_attention(q, k, v, *chunks[0])
    for tc, dg in chunks[1:]:
        assert torch.equal(chunked_attention(q, k, v, tc, dg), whole), (tc, dg)
    # the plain attention of layer_math (f32, nothing to round)
    ctx = torch.einsum("td,te->de", torch.softmax(k, 0), v)
    plain = torch.softmax(q, -1) @ ctx
    assert rel_rms(whole.numpy(), plain.numpy()) <= 1e-6


# --------------------------------------------------------------------------
# a stream of 264-frame windows
# --------------------------------------------------------------------------

def test_264_frame_stream_matches_jax():
    # two windows (0 and a left-shifted 136) of a 400-frame stream through
    # the branch kernel's path (its plain version on the CPU)
    from diffsheg_tpu.sampling.generator import WindowGenerator as JGen
    from diffsheg_tpu.sampling.streamer import StreamingGenerator as JS
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator as PGen
    from diffsheg_tpu_torch.sampling.streamer import (StreamingGenerator as PS,
                                                      window_starts)
    jcfg, tcfg = config_pair("beat", data={"n_poses": 264},
                             diffusion={"jump_n_sample": 2})
    tcfg = tcfg.replace(diffusion=dataclasses.replace(tcfg.diffusion,
                                                      fused_layer="chain"))
    variables = jax_denoiser(jcfg, seed=44)
    jgen = JGen(jcfg, jax.tree.map(jnp.asarray, variables))
    pgen = PGen(tcfg, torch_denoiser(tcfg, variables), device="cpu")
    assert pgen.use_fast
    m = jcfg.model
    rng = np.random.RandomState(45)
    T = 400
    starts = window_starts(T, 264, 264 - jcfg.stream.overlap_len)
    assert starts == [0, 136]
    mel = rng.randn(1, T, m.audio_dim).astype(np.float32)
    hub = rng.randn(1, T, m.hubert_dim).astype(np.float32)
    pid = np.eye(m.style_dim, dtype=np.float32)[[2]]
    key = jax.random.PRNGKey(46)
    ref = np.asarray(JS(jgen).generate_fused(
        jnp.asarray(mel), jnp.asarray(pid), key, jnp.asarray(hub)))
    noise = stream_noise(key, len(starts), 1, 264, m.motion_dim, jgen._plain,
                         jgen._harmonize)
    before = P.fused_branch.launches
    got = PS(pgen).generate_fused(torch.tensor(mel), torch.tensor(pid),
                                  noise, torch.tensor(hub)).numpy()
    assert P.fused_branch.launches == before          # CPU: no launch
    assert got.shape == ref.shape == (1, T, m.motion_dim)
    assert np.isfinite(got).all()
    err = rel_rms(got, ref), np.abs(got - ref).max() / np.abs(ref).max()
    assert err[0] <= 1e-5 and err[1] <= 1e-5, err


def test_group_rows_of_the_null_mask_are_aligned():
    # the second window of a classifier-free pair past 256 frames is a
    # launch of its own: its null-mask row starts 4 bytes into the vector,
    # which the kernel's 16-byte check refuses, so the wrapper copies it
    mask = torch.tensor([1.0, 0.0])
    rows = [P._aligned(mask[g]) for g in P._batch_groups(2, 352)]
    assert [r.data_ptr() % 16 for r in rows] == [0, 0]
    assert [r.tolist() for r in rows] == [[1.0], [0.0]]
    assert P._aligned(mask) is mask                   # aligned: no copy
