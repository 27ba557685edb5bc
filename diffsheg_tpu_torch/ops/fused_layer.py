"""Whole-layer and whole-branch denoiser kernels, with their plain versions.

Counterpart of ``diffsheg_tpu/ops/fused_layer.py``.  One
DiffusionTransformerLayer on the sampler's fast path is: masked LayerNorm
of the padded feats -> fc1 -> SiLU -> fc2 + residual; LayerNorm -> Q/K/V
-> per-head linear attention; LayerNorm -> AdaLN (precomputed mods) ->
SiLU -> out + residual; FFN (l1 -> A&S-erf GELU -> l2) -> LayerNorm ->
AdaLN -> SiLU -> out + residual.

- :func:`fused_layer` runs one layer on pre-assembled feats;
- :func:`fused_branch` runs a branch's whole layer stack in one launch,
  assembling concat(h, cond) per layer with the optional classifier-free
  null-row blend.

Both take optional per-output-column scales (:class:`LayerScales`) for
weight-only int8 or nibble-packed int4 matrices made by
:func:`quantize_layer_params` (the ``diffusion.quantize`` serving knob):
each product then dequantizes its f32 accumulator, ``acc * s + b``.

On a CUDA tensor each wrapper launches the hand-written kernel of
``csrc/fused_layer.cu`` (built at first use, see ``ops/build.py``) or
raises; on a CPU tensor it runs the plain PyTorch version
(:func:`fused_layer_reference`, :func:`fused_branch_reference`), the
exact transcription of the JAX ``_layer_math``.  Each wrapper counts its
kernel launches in ``.launches``; :func:`fused_layer` counts them by the
launch's (B, T, L) in ``.launches_by_shape`` too, and both by (Cp, F,
passes) in ``.launches_by_width``.  :func:`k_pass_plan` lays out the
kernel's shared memory: a product whose contraction is wider than a block
can stage beside one weight slice runs in passes (csrc
``product_passes``), an attention phase whose window does not fit beside
the products' room (or whose head width is not a multiple of 8) runs in
chunks of T (csrc ``attention_chunks``), and a shape no plan fits is
refused by name before any launch.  :func:`branch_phase_ns` and
:func:`kernel_probe` measure inside the kernel (per-phase and in-phase
times from a traced build, the grid barriers' floor, the operand copy's
rate); ``chip_smoke.py`` prints them.  :func:`random_layer_params` makes
the seeded weights those checks and ``cli doctor`` launch the kernels on.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import List, NamedTuple, Optional

import torch

LN_EPS = 1e-5
KERNEL_SOURCE = "fused_layer.cu"
# rows (B * T) a launch takes of a batch: a larger batch is split into
# launches of whole windows (a window longer than this is a launch of its
# own), which keeps the launch shapes the main paths were timed at
_LAUNCH_ROWS = 256


def gelu_as(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU with the Abramowitz & Stegun 7.1.26 erf (max abs error
    1.5e-7), the same formula as the JAX kernel and its oracle."""
    z = x * 0.7071067811865476
    s = torch.sign(z)
    a = torch.abs(z)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf = s * (1.0 - poly * torch.exp(-a * a))
    return 0.5 * x * (1.0 + erf)


class LayerParams(NamedTuple):
    """One layer's weights, kernel-ready, in the JAX layout: matrices are
    ``(in, out)``; the ``fp_*`` tensors are zero-padded on the feats axis
    to ``c_pad``.  Stacked form: a leading ``(num_layers,)`` axis."""

    fp_norm_scale: torch.Tensor   # (Cp,)
    fp_norm_bias: torch.Tensor    # (Cp,)
    fp_fc1_k: torch.Tensor        # (Cp, 2L)
    fp_fc1_b: torch.Tensor        # (2L,)
    fp_fc2_k: torch.Tensor        # (2L, L)
    fp_fc2_b: torch.Tensor        # (L,)
    sa_norm_scale: torch.Tensor   # (L,)
    sa_norm_bias: torch.Tensor
    q_k: torch.Tensor             # (L, L)
    q_b: torch.Tensor
    k_k: torch.Tensor
    k_b: torch.Tensor
    v_k: torch.Tensor
    v_b: torch.Tensor
    sa_so_norm_scale: torch.Tensor
    sa_so_norm_bias: torch.Tensor
    sa_out_k: torch.Tensor        # (L, L)
    sa_out_b: torch.Tensor
    ffn_l1_k: torch.Tensor        # (L, F)
    ffn_l1_b: torch.Tensor        # (F,)
    ffn_l2_k: torch.Tensor        # (F, L)
    ffn_l2_b: torch.Tensor
    ffn_so_norm_scale: torch.Tensor
    ffn_so_norm_bias: torch.Tensor
    ffn_out_k: torch.Tensor       # (L, L)
    ffn_out_b: torch.Tensor


def extract_layer_params(layer, c_real: int, c_pad: int,
                         dtype: torch.dtype) -> LayerParams:
    """A :class:`~diffsheg_tpu_torch.models.blocks.DiffusionTransformerLayer`
    -> LayerParams on the layer's device, cast to ``dtype``, feats-axis
    tensors zero-padded from ``c_real`` to ``c_pad`` (inert: the masked
    LayerNorm's pads normalise to zero and the fc1 pad rows are zero)."""
    pad = c_pad - c_real

    def v(t):
        return t.detach().to(dtype).contiguous()

    def k(lin):  # nn.Linear (out, in) -> (in, out)
        return v(lin.weight.t())

    fp, sa, ffn = layer.feat_proj, layer.sa_block, layer.ffn
    return LayerParams(
        fp_norm_scale=torch.nn.functional.pad(v(fp.norm.weight), (0, pad)),
        fp_norm_bias=torch.nn.functional.pad(v(fp.norm.bias), (0, pad)),
        fp_fc1_k=torch.nn.functional.pad(k(fp.fc1), (0, 0, 0, pad)),
        fp_fc1_b=v(fp.fc1.bias), fp_fc2_k=k(fp.fc2), fp_fc2_b=v(fp.fc2.bias),
        sa_norm_scale=v(sa.norm.weight), sa_norm_bias=v(sa.norm.bias),
        q_k=k(sa.query), q_b=v(sa.query.bias),
        k_k=k(sa.key), k_b=v(sa.key.bias),
        v_k=k(sa.value), v_b=v(sa.value.bias),
        sa_so_norm_scale=v(sa.proj_out.norm.weight),
        sa_so_norm_bias=v(sa.proj_out.norm.bias),
        sa_out_k=k(sa.proj_out.out_proj), sa_out_b=v(sa.proj_out.out_proj.bias),
        ffn_l1_k=k(ffn.linear1), ffn_l1_b=v(ffn.linear1.bias),
        ffn_l2_k=k(ffn.linear2), ffn_l2_b=v(ffn.linear2.bias),
        ffn_so_norm_scale=v(ffn.proj_out.norm.weight),
        ffn_so_norm_bias=v(ffn.proj_out.norm.bias),
        ffn_out_k=k(ffn.proj_out.out_proj),
        ffn_out_b=v(ffn.proj_out.out_proj.bias),
    )


class LayerScales(NamedTuple):
    """Per-output-column f32 dequantization scales of the nine weight
    matrices (same field names as in LayerParams): ``(N,)`` per layer,
    ``(n, N)`` stacked.  ``w ~= q * s[None, :]``, so a product dequantizes
    its accumulator: ``a @ (q * s) == (a @ q) * s``."""

    fp_fc1_k: torch.Tensor
    fp_fc2_k: torch.Tensor
    q_k: torch.Tensor
    k_k: torch.Tensor
    v_k: torch.Tensor
    sa_out_k: torch.Tensor
    ffn_l1_k: torch.Tensor
    ffn_l2_k: torch.Tensor
    ffn_out_k: torch.Tensor


def quantize_layer_params(lp: LayerParams, bits: int = 8):
    """Symmetric per-output-column int8 / int4 codes of every weight matrix
    (the JAX ``quantize_layer_params``); vectors keep their dtype.  One
    layer or the stacked form (the reduction is over the contraction axis,
    ``-2``).  Returns ``(lp_quant, LayerScales)``.

    ``bits=4`` packs two codes per int8 byte along the output axis: the
    left column half in the high nibble, the right half in the low one, so
    a packed matrix is ``(K, N/2)`` int8 against ``(N,)`` scales.  Codes
    are clipped to [-7, 7] (int4) or [-127, 127] (int8)."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    qmax = 127.0 if bits == 8 else 7.0
    qs, scales = {}, []
    for name in LayerScales._fields:
        w = getattr(lp, name).float()
        amax = w.abs().amax(dim=-2, keepdim=True)
        s = torch.clamp(amax, min=1e-30) / qmax
        q = torch.clamp(torch.round(w / s), -qmax, qmax).to(torch.int32)
        if bits == 4:
            n = q.shape[-1]
            if n % 2:
                raise ValueError(f"{name}: int4 packing needs an even "
                                 f"width, got {tuple(q.shape)}")
            # shifted in int32: hi in [-7, 7] << 4 plus the low nibble
            # stays inside int8's range, so the cast keeps the value
            q = (q[..., :n // 2] << 4) | (q[..., n // 2:] & 0xF)
        qs[name] = q.to(torch.int8).contiguous()
        scales.append(s.squeeze(-2).contiguous())
    return lp._replace(**qs), LayerScales(*scales)


def random_layer_params(n: int, L: int, F: int, Cp: int, c_real: int,
                        dtype: torch.dtype, gen: torch.Generator,
                        device) -> LayerParams:
    """Seeded weights of ``n`` stacked layers for the kernels' checks on
    the card (``cli doctor``, ``chip_smoke.py``): every leaf perturbed
    (zero-init output projections would hide the attention and the FFN),
    the padded concat channels from ``c_real`` on zero, as
    :func:`extract_layer_params` pads them.  Drawn on the CPU from
    ``gen``, then moved to ``device`` in ``dtype``."""

    def mat(k, m):
        return torch.randn(n, k, m, generator=gen) / k ** 0.5

    def vec(m, base=0.0, s=0.1):
        return base + s * torch.randn(n, m, generator=gen)

    f = dict(
        fp_norm_scale=vec(Cp, 1.0), fp_norm_bias=vec(Cp),
        fp_fc1_k=mat(Cp, 2 * L), fp_fc1_b=vec(2 * L),
        fp_fc2_k=mat(2 * L, L), fp_fc2_b=vec(L),
        sa_norm_scale=vec(L, 1.0), sa_norm_bias=vec(L),
        q_k=mat(L, L), q_b=vec(L), k_k=mat(L, L), k_b=vec(L),
        v_k=mat(L, L), v_b=vec(L),
        sa_so_norm_scale=vec(L, 1.0), sa_so_norm_bias=vec(L),
        sa_out_k=mat(L, L), sa_out_b=vec(L),
        ffn_l1_k=mat(L, F), ffn_l1_b=vec(F), ffn_l2_k=mat(F, L),
        ffn_l2_b=vec(L), ffn_so_norm_scale=vec(L, 1.0),
        ffn_so_norm_bias=vec(L), ffn_out_k=mat(L, L), ffn_out_b=vec(L))
    for k in ("fp_norm_scale", "fp_norm_bias"):
        f[k][:, c_real:] = 0.0
    f["fp_fc1_k"][:, c_real:] = 0.0
    return LayerParams(**{k: v.to(device=device, dtype=dtype).contiguous()
                          for k, v in f.items()})


def stack_layer_params(lps: List[LayerParams]) -> LayerParams:
    """Stack per-layer LayerParams along a new leading layer axis."""
    return LayerParams(*(torch.stack(f).contiguous() for f in zip(*lps)))


def layer_at(slp, i: int):
    """Layer ``i`` of stacked LayerParams or LayerScales."""
    return type(slp)(*(f[i] for f in slp))


# --------------------------------------------------------------------------
# plain versions (exact transcription of the JAX _layer_math)
# --------------------------------------------------------------------------

def unpack_int4(w: torch.Tensor):
    """Nibble-packed int8 ``(K, N/2)`` -> the exact f32 codes of the left
    (high nibble) and right (low nibble) column halves.  Unpacked in f32,
    as the JAX kernel does: a left shift of a torch int8 tensor would
    overflow."""
    wf = w.float()
    hi = torch.floor(wf * (1.0 / 16.0))
    lo = wf - 16.0 * hi
    return hi, lo - torch.where(lo >= 8.0, 16.0, 0.0)


def layer_math(x, feats, mod_sa, mod_ffn, lp: LayerParams, num_heads: int,
               c_real: int, sc: Optional[LayerScales] = None) -> torch.Tensor:
    """The whole layer on (B, T, .) rows: f32 activations, product inputs
    rounded to the compute dtype (that of the vectors) with f32
    accumulation (bf16 values are exact in f32, so an f32 product of the
    rounded operands is the JAX ``preferred_element_type=f32`` dot).  With
    ``sc`` the nine matrices are int8 codes (or packed int4, detected from
    the shape) and each product is ``(a @ q) * s + b``."""
    f32 = torch.float32
    cdtype = lp.fp_norm_scale.dtype

    def c(a):  # round to the weight dtype, compute in f32
        return a.to(cdtype).to(f32)

    def mm(a, w, b, name=None):
        s = None if sc is None else getattr(sc, name)
        if s is None:
            return torch.matmul(c(a), w.to(f32)) + b.to(f32)
        if w.shape[-1] * 2 == s.shape[-1]:
            y = torch.cat([torch.matmul(c(a), half) for half in unpack_int4(w)],
                          dim=-1)
        else:
            y = torch.matmul(c(a), w.to(f32))
        return y * s.to(f32) + b.to(f32)

    def ln(h, scale, bias):
        mu = h.mean(-1, keepdim=True)
        var = ((h - mu) ** 2).mean(-1, keepdim=True)
        return (h - mu) * torch.rsqrt(var + LN_EPS) * scale.to(f32) + bias.to(f32)

    silu = torch.nn.functional.silu
    x = x.to(f32)
    feats = feats.to(f32)
    B, T, L = x.shape

    # condition projection: statistics masked to the true feats width
    Cp = feats.shape[-1]
    valid = (torch.arange(Cp, device=feats.device) < c_real).to(f32)
    mu = feats.sum(-1, keepdim=True) / c_real
    var = (((feats - mu) ** 2) * valid).sum(-1, keepdim=True) / c_real
    nf = ((feats - mu) * torch.rsqrt(var + LN_EPS)
          * lp.fp_norm_scale.to(f32) + lp.fp_norm_bias.to(f32))
    a1 = silu(mm(nf, lp.fp_fc1_k, lp.fp_fc1_b, "fp_fc1_k"))
    x1 = mm(a1, lp.fp_fc2_k, lp.fp_fc2_b, "fp_fc2_k") + x

    # linear self-attention (all-ones mask)
    n1 = ln(x1, lp.sa_norm_scale, lp.sa_norm_bias)
    hd = L // num_heads
    q = mm(n1, lp.q_k, lp.q_b, "q_k").view(B, T, num_heads, hd).softmax(-1)
    k = mm(n1, lp.k_k, lp.k_b, "k_k").view(B, T, num_heads, hd).softmax(1)
    v = mm(n1, lp.v_k, lp.v_b, "v_k").view(B, T, num_heads, hd)
    ctx = torch.einsum("bthd,bthe->bhde", c(k), c(v))
    y = torch.einsum("bthd,bhde->bthe", c(q), c(ctx)).reshape(B, T, L)

    scale_sa, shift_sa = mod_sa.to(f32).chunk(2, dim=-1)
    z = ln(y, lp.sa_so_norm_scale, lp.sa_so_norm_bias)
    z = silu(z * (1.0 + scale_sa[:, None]) + shift_sa[:, None])
    x2 = x1 + mm(z, lp.sa_out_k, lp.sa_out_b, "sa_out_k")

    f = gelu_as(mm(x2, lp.ffn_l1_k, lp.ffn_l1_b, "ffn_l1_k"))
    g = mm(f, lp.ffn_l2_k, lp.ffn_l2_b, "ffn_l2_k")
    scale_f, shift_f = mod_ffn.to(f32).chunk(2, dim=-1)
    z2 = ln(g, lp.ffn_so_norm_scale, lp.ffn_so_norm_bias)
    z2 = silu(z2 * (1.0 + scale_f[:, None]) + shift_f[:, None])
    return x2 + mm(z2, lp.ffn_out_k, lp.ffn_out_b, "ffn_out_k")


def fused_layer_reference(x, feats, mod_sa, mod_ffn, lp: LayerParams,
                          num_heads: int, c_real: int,
                          sc: Optional[LayerScales] = None) -> torch.Tensor:
    """Plain version of :func:`fused_layer`."""
    return layer_math(x, feats, mod_sa, mod_ffn, lp, num_heads, c_real,
                      sc).to(x.dtype)


def chain_feats(h, cond, null_emb, null_mask) -> torch.Tensor:
    """concat(h, cond) and, for classifier-free rows, the all-f32 blend
    toward ``null_emb`` over the full padded concat (JAX _chain_step)."""
    feats = torch.cat([h.to(cond.dtype), cond], dim=-1)
    if null_emb is None:
        return feats
    m = null_mask.to(torch.float32)[:, None, None]
    return feats.float() * (1.0 - m) + null_emb.float()[None] * m


def fused_branch_reference(x, cond, mods, slp: LayerParams, num_heads: int,
                           c_real: int, null_emb=None, null_mask=None,
                           ssc: Optional[LayerScales] = None) -> torch.Tensor:
    """Plain version of :func:`fused_branch`: sequential layers, each
    layer's output rounded to ``x.dtype`` as the kernel's resident state
    is."""
    h = x
    for i in range(slp.fp_fc1_k.shape[0]):
        feats = chain_feats(h, cond, None if null_emb is None else null_emb[0],
                            null_mask)
        h = layer_math(h, feats, mods[i, 0], mods[i, 1], layer_at(slp, i),
                       num_heads, c_real,
                       None if ssc is None else layer_at(ssc, i)).to(x.dtype)
    return h


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib(probe: bool = False, traced: bool = False):
    """The kernel's C entry (``probe``: the probes' entry); ``traced``: from
    the library built with the stamps compiled in."""
    from diffsheg_tpu_torch.ops.build import TRACED_FUSED_LAYER, library
    lib = library(TRACED_FUSED_LAYER if traced else KERNEL_SOURCE)
    fn = lib.diffsheg_fused_layers_probe if probe else lib.diffsheg_fused_layers
    if fn.argtypes is None:     # 64-bit stream handle, not ctypes' default int
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
                       ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
        if probe:
            fn.argtypes += [ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
                            ctypes.POINTER(ctypes.c_int64)]
        fn.restype = ctypes.c_int
    return fn


_barrier_words = {}


def _barrier_word(device: torch.device) -> torch.Tensor:
    """The kernel's grid-barrier word for launches on ``device``'s current
    stream: zero before the first launch, left as a launch found it up to
    its top bit, so the launches of a stream, which run one after another,
    share it (csrc ``barrier_arrive``).  Each stream has a word of its own:
    two launches that could run side by side never count on the same."""
    key = (torch.device(device).index,
           torch.cuda.current_stream(device).cuda_stream)
    word = _barrier_words.get(key)
    if word is None:
        word = _barrier_words[key] = torch.zeros(4, dtype=torch.int32,
                                                 device=device)
    return word


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _quant_bits(slp: LayerParams, sc, L: int) -> int:
    """0 (no scales), 8 (int8 codes) or 4 (packed int4), from fc1's width
    against its scales' (the JAX kernel's shape rule)."""
    if sc is None:
        return 0
    if not isinstance(sc, LayerScales):
        raise TypeError(f"scales must be LayerScales, got {type(sc)}")
    n = slp.fp_fc1_k.shape[-1]
    if n == 2 * L:
        return 8
    if n == L:
        return 4
    raise ValueError(f"fp_fc1_k width {n} is neither 2L={2 * L} (int8) nor "
                     f"L={L} (packed int4)")


# The kernel's shared memory, laid out here alone (csrc fits_plan holds a
# layout to what the kernel touches): its constants NT, RB, TN, AC and
# A_BUDGET, and the dynamic bytes a block may take beside the static ones.
_SMEM_CAP = 227 * 1024 - 1024
_NT, _RB, _TN, _AC = 256, 64, 8, 8
_A_BUDGET = 160 * 1024
_PASS_WIDTH = 1024   # at most 1024: a 34-row f32 window is staged whole


class KPassPlan(NamedTuple):
    """How a launch stages its products and its attention
    (:func:`k_pass_plan`)."""

    kp: int           # widest contraction a product stages at once
    passes: int       # passes of the widest product (1 with tc 0: the
                      # one-pass kernel; else the K-pass one, csrc plan_of)
    a_elems: int      # operand room (elements)
    w_off: int        # byte offsets of the weight-slice room ...
    part_off: int     # ... and of the warps' partial tiles
    smem_bytes: int   # dynamic shared memory of one block
    tc: int = 0       # attention: 0, the whole window in one tile; else
    dg: int = 0       # frames a chunk and k features a group


def _attention_bytes(T: int, hd: int, tc: int = 0, dg: int = 0) -> int:
    """Shared bytes of the kernel's attention phase: with ``tc`` 0 the
    whole window's q and k tiles, its v columns and ctx (csrc
    ``attention``); else a tile of ``tc`` frames, ctx, and per feature of a
    group of ``dg`` the softmax's and ctx's partial sums (csrc
    ``chunk_floats``)."""
    if tc == 0:
        return 4 * (2 * T * (hd + 1) + T * _AC + hd * _AC)
    return 4 * (tc * (hd + 1 + _AC) + hd * _AC + dg * (4 * _AC + 10))


def _attention_chunks(T: int, hd: int, room: int):
    """(tc, dg) of attention in chunks within ``room`` bytes: every k
    feature in one group and the longest chunk that fits (the whole window,
    or a multiple of 4 frames), halving the group while not even 4 frames
    fit; None if no group does."""
    dg = hd
    while True:
        # frames that fit: one, and as many more as the room leaves
        frame = 4 * (hd + 1 + _AC)
        n = (room - _attention_bytes(T, hd, 1, dg)) // frame + 1
        if n >= T:
            return T, dg
        if n >= 4:
            return n // 4 * 4, dg
        if dg == 1:
            return None
        dg = (dg + 1) // 2


def _layout(esize: int, qb: int, M: int, kp: int, attn: int):
    """(operand rows, a_elems, w_off, part_off, bytes) at pass width
    ``kp`` with ``attn`` bytes of attention tiles: [operand rows | attention
    tiles] (the larger), the weight slice room, the warps' partial tiles.
    bf16: the operand gets up to ``_A_BUDGET`` bytes in blocks of 16 rows,
    up to all M; f32: the room holds one item's split slice and the operand
    what is left, with 15 rows of its width free behind it (a last tile
    reads past the staged rows)."""
    def up16(n):
        return (n + 15) // 16 * 16

    lda = kp + 8 if esize == 2 else kp + 16 - kp % 32   # csrc lda_of
    part = 4 * (_NT // 32) * _RB * _TN
    if esize == 2:
        rows = min(_RB, up16(M), _A_BUDGET // (lda * 2) // 16 * 16)
        wbytes = 2 * kp * _TN * (2 if qb == 4 else 1)
        tail = 0
    else:
        row = 4 * lda
        # QB 0: the hi and lo tiles; QB 8: one of codes; QB 4: two of nibbles
        wbytes = 4 * _TN * kp * (1 if qb == 8 else 2)
        rows = min((_SMEM_CAP - min(_SMEM_CAP, wbytes + part)) // row,
                   _SMEM_CAP // row - 15, _RB, up16(M))
        rows = rows if rows >= 16 else 0
        tail = row * (rows + 15)
    a_elems = rows * lda
    w_off = up16(max(a_elems * esize, attn))
    part_off = w_off + wbytes
    return rows, a_elems, w_off, part_off, max(part_off + part, tail)


@functools.lru_cache(maxsize=256)   # asked at every launch: off the host path
def k_pass_plan(dtype: torch.dtype, qb: int, B: int, T: int, Cp: int,
                L: int, F: int, H: int) -> KPassPlan:
    """The launch's shared-memory plan: one pass when a block can hold one
    work item's weight slice at the widest contraction ``max(Cp, 2L, F,
    L)`` beside 16 operand rows (every shape the kernel ran before passes
    existed), else passes of ``_PASS_WIDTH``; the attention's whole window
    in one tile where it fits beside them and the head width is a multiple
    of 8 (every shape the kernel ran before chunks existed: the same plan),
    else in chunks of T.  Raises ``ValueError``, naming the limit, for a
    shape no plan fits."""
    esize = dtype.itemsize
    M, hd = B * T, L // H
    kmax = max(Cp, 2 * L, F, L)
    kps = (kmax, min(kmax, _PASS_WIDTH))
    if hd % _AC == 0:
        for kp in kps:
            rows, a_elems, w_off, part_off, smem = _layout(
                esize, qb, M, kp, _attention_bytes(T, hd))
            if rows >= 16 and smem <= _SMEM_CAP:
                return KPassPlan(kp, -(-kmax // kp), a_elems, w_off,
                                 part_off, smem)
    for kp in kps:
        rows, _, w_off, part_off, smem = _layout(esize, qb, M, kp, 0)
        room = (_SMEM_CAP - (part_off - w_off) - 4 * (_NT // 32) * _RB * _TN
                ) // 16 * 16
        chunk = _attention_chunks(T, hd, room) if rows >= 16 else None
        if chunk is None:
            continue
        rows, a_elems, w_off, part_off, smem = _layout(
            esize, qb, M, kp, _attention_bytes(T, hd, *chunk))
        if rows >= 16 and smem <= _SMEM_CAP:
            return KPassPlan(kp, -(-kmax // kp), a_elems, w_off, part_off,
                             smem, *chunk)
    kind = {0: str(dtype), 8: f"{dtype} with int8 codes",
            4: f"{dtype} with int4 codes"}[qb]
    raise ValueError(
        f"fused layer kernel: no shared-memory plan fits B*T={M}, T={T}, "
        f"head width {hd}, widest contraction {kmax} (Cp={Cp}, L={L}, "
        f"F={F}), {kind}: at pass width {kps[-1]} the products leave "
        f"{room} of the {_SMEM_CAP} bytes, and the attention takes "
        f"{_attention_bytes(T, hd, 4, 1)} at its least (chunks of 4 frames, "
        f"k features one at a time); the JAX kernel takes this shape")


def _pack(x, feats, mod_sa, mod_ffn, mod_layer_stride, slp, n_layers,
          num_heads, c_real, chain, null_emb, null_mask, sc=None, *,
          trace=None):
    """Check everything the kernel assumes, plan and allocate; returns the
    C interface's (dtype code, ptrs, ints), the output, the scratch buffer
    and the :class:`KPassPlan`."""
    dev, dt = x.device, x.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"kernel supports float32/bfloat16, got {dt}")
    B, T, L = x.shape
    Cp = slp.fp_fc1_k.shape[-2]
    F = slp.ffn_l1_b.shape[-1]
    if num_heads < 1 or L % num_heads:
        raise ValueError(f"{num_heads} heads must divide the width L={L}")
    if L % 16 or Cp % 16 or F % 16 or not L <= c_real <= Cp:
        raise ValueError(f"widths must be multiples of 16 with L <= c_real "
                         f"<= Cp (L={L}, c_real={c_real}, Cp={Cp}, F={F})")
    qb = _quant_bits(slp, sc, L)
    lead = (n_layers,) if chain else ()
    shapes = LayerParams(
        (Cp,), (Cp,), (Cp, 2 * L), (2 * L,), (2 * L, L), (L,), (L,), (L,),
        (L, L), (L,), (L, L), (L,), (L, L), (L,), (L,), (L,), (L, L), (L,),
        (L, F), (F,), (F, L), (L,), (L,), (L,), (L, L), (L,))
    for name, t, shp in zip(LayerParams._fields, slp, shapes):
        if qb and name in LayerScales._fields:
            # codes: (K, N) int8, or (K, N/2) int8 packed; scales (N,) f32
            _check(name, t, lead + (shp[0], shp[1] // (2 if qb == 4 else 1)),
                   torch.int8, dev)
            _check(f"scales.{name}", getattr(sc, name), lead + shp[1:],
                   torch.float32, dev)
        else:
            _check(name, t, lead + shp, dt, dev)
    _check("x", x, (B, T, L), dt, dev)
    _check("feats" if not chain else "cond", feats,
           (B, T, Cp if not chain else Cp - L), dt, dev)
    if null_emb is not None:
        _check("null_emb", null_emb, (Cp,), dt, dev)
        _check("null_mask", null_mask, (B,), torch.float32, dev)
    plan = k_pass_plan(dt, qb, B, T, Cp, L, F, num_heads)
    out = torch.empty_like(x)
    M = B * T
    scratch = torch.empty(M * 8 * L * 4 + M * (L + max(2 * L, F) + max(Cp, L))
                          * x.element_size(), dtype=torch.uint8, device=dev)
    scales = tuple(sc) if qb else ()
    ptrs = [t.data_ptr() for t in slp] + [
        x.data_ptr(), feats.data_ptr(), mod_sa.data_ptr(), mod_ffn.data_ptr(),
        0 if null_emb is None else null_emb.data_ptr(),
        0 if null_mask is None else null_mask.data_ptr(),
        out.data_ptr(), scratch.data_ptr(),
        0 if trace is None else trace.data_ptr()] + (
        [t.data_ptr() for t in scales] or [0] * len(LayerScales._fields)) + [
        _barrier_word(dev).data_ptr()]

    def layer_bytes(t):   # bytes between layers of a stacked field
        return t[0].numel() * t.element_size() if chain else 0

    ints = [layer_bytes(t) for t in slp] + [
        mod_layer_stride, int(chain), n_layers, B, T, L, Cp, c_real, F,
        num_heads, qb] + ([layer_bytes(t) for t in scales]
                          or [0] * len(LayerScales._fields)) + [
        plan.kp, plan.a_elems, plan.w_off, plan.part_off, plan.smem_bytes,
        plan.tc, plan.dg]
    return (_DTYPE_CODE[dt], (ctypes.c_uint64 * len(ptrs))(*ptrs),
            (ctypes.c_int64 * len(ints))(*ints)), out, scratch, plan


# csrc Refusal: arguments the kernel refuses before any launch
_REFUSALS = {-3: "the host's shared-memory plan does not fit the kernel",
             -4: "no barrier word, a trace without the traced build, a "
                 "quantization other than int8 / int4, or heads that do "
                 "not divide L"}


def _refused(err: int, x, plan: KPassPlan, cargs) -> str:
    """The message for the C entry's return code ``err`` (not 0)."""
    if err in _REFUSALS:
        ints = list(cargs[2])
        B, T, L, Cp, c_real, F, H = ints[len(LayerParams._fields) + 3:][:7]
        return (f"fused layer kernel refused {tuple(x.shape)} {x.dtype} "
                f"(Cp={Cp}, c_real={c_real}, F={F}, heads={H}): "
                f"{_REFUSALS[err]} ({plan})")
    return f"fused layer kernel launch failed: CUDA error {err}"


def _launch(x, *args, trace=None, **kwargs):
    """Check, plan, allocate, launch (arguments: see :func:`_pack`);
    returns the output and the plan."""
    cargs, out, _scratch, plan = _pack(x, *args, trace=trace, **kwargs)
    err = _lib(traced=trace is not None)(
        *cargs, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(_refused(err, x, plan, cargs))
    return out, plan


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address: a copy where a batch
    group's rows of a short vector start inside a 16-byte word."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _batch_groups(B: int, T: int):
    """The launches of a batch: whole windows, up to ``_LAUNCH_ROWS``
    rows each (a window needs all its frames for the attention)."""
    per = max(1, _LAUNCH_ROWS // T)
    return [slice(s, min(B, s + per)) for s in range(0, B, per)]


def fused_layer(x: torch.Tensor,        # (B, T, L)
                feats: torch.Tensor,    # (B, T, Cp) pre-concat/substituted/padded
                mod_sa: torch.Tensor,   # (B, 2L)
                mod_ffn: torch.Tensor,  # (B, 2L)
                lp: LayerParams,
                num_heads: int,
                c_real: int,
                sc: Optional[LayerScales] = None) -> torch.Tensor:
    """One denoiser layer; ``sc``: the scales of int8 / packed int4
    matrices.  CUDA tensors: the kernel of ``csrc/fused_layer.cu``
    (replaces the Pallas ``fused_layer``, diffsheg_tpu/ops/fused_layer.py:505,
    both its variants).  CPU tensors: the plain version."""
    if x.device.type == "cpu":
        return fused_layer_reference(x, feats, mod_sa, mod_ffn, lp,
                                     num_heads, c_real, sc)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    outs = []
    for g in _batch_groups(x.shape[0], x.shape[1]):
        ms, mf = mod_sa[g].contiguous(), mod_ffn[g].contiguous()
        for name, t in (("mod_sa", ms), ("mod_ffn", mf)):
            _check(name, t, (ms.shape[0], 2 * x.shape[-1]), x.dtype, x.device)
        out, plan = _launch(x[g].contiguous(), feats[g].contiguous(), ms,
                            mf, 0, lp, 1, num_heads, c_real, False, None,
                            None, sc)
        outs.append(out)
        fused_layer.launches += 1
        fused_layer.launches_by_shape[tuple(x[g].shape)] += 1
        fused_layer.launches_by_width[_width_key(lp, plan)] += 1
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _width_key(lp: LayerParams, plan: KPassPlan):
    """(Cp, F, passes of the widest product): a launch's widths."""
    return (lp.fp_fc1_k.shape[-2], lp.ffn_l1_b.shape[-1], plan.passes)


fused_layer.launches = 0
fused_layer.launches_by_shape = collections.Counter()
fused_layer.launches_by_width = collections.Counter()


def fused_branch(x: torch.Tensor,      # (B, T, L) embedded input (post PE)
                 cond: torch.Tensor,   # (B, T, Cp - L) condition, zero-padded
                 mods: torch.Tensor,   # (num_layers, 2, B, 2L)
                 slp: LayerParams,     # stacked over layers
                 num_heads: int,
                 c_real: int,
                 null_emb: Optional[torch.Tensor] = None,   # (1, Cp)
                 null_mask: Optional[torch.Tensor] = None,  # (B,) 0/1 rows
                 ssc: Optional[LayerScales] = None,  # stacked (n, N)
                 ) -> torch.Tensor:
    """A branch's whole layer stack in one launch; ``ssc``: the stacked
    scales of int8 / packed int4 matrices.  CUDA tensors: the kernel of
    ``csrc/fused_layer.cu`` in chain mode (replaces the Pallas
    ``fused_branch``, diffsheg_tpu/ops/fused_layer.py:398, both its
    variants).  CPU tensors: the plain version."""
    if x.device.type == "cpu":
        return fused_branch_reference(x, cond, mods, slp, num_heads, c_real,
                                      null_emb, null_mask, ssc)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n_layers = slp.fp_fc1_k.shape[0]
    L = x.shape[-1]
    outs = []
    for g in _batch_groups(x.shape[0], x.shape[1]):
        Bg = g.stop - g.start
        m = mods[:, :, g].contiguous()
        _check("mods", m, (n_layers, 2, Bg, 2 * L), x.dtype, x.device)
        ne = None if null_emb is None else null_emb.reshape(-1).contiguous()
        nm = None if null_mask is None else \
            _aligned(null_mask[g].to(torch.float32))
        out, plan = _launch(x[g].contiguous(), cond[g].contiguous(),
                            m[0, 0], m[0, 1], 2 * Bg * 2 * L, slp, n_layers,
                            num_heads, c_real, True, ne, nm, ssc)
        outs.append(out)
        fused_branch.launches += 1
        fused_branch.launches_by_width[_width_key(slp, plan)] += 1
    return outs[0] if len(outs) == 1 else torch.cat(outs)


fused_branch.launches = 0
fused_branch.launches_by_width = collections.Counter()


PHASES = ("ln_feats", "fc1", "fc2", "ln", "qkv", "attention", "ln_adaln",
          "sa_out", "ffn_l1", "ffn_l2", "ln_adaln", "ffn_out")
N_SUB = 5   # block 0's stamps inside a phase (csrc NSUB)
# what ends at each stamp inside a product phase / the attention phase; the
# grid barrier then takes the rest of the phase.  Row phases stamp only the
# last ("work": the whole row pass).
PRODUCT_STEPS = ("operand", "weights", "multiply", "epilogue", "more_items")
ATTENTION_STEPS = ("stage", "softmax", "ctx", "y", "more_items")


def _branch_args(x, cond, mods, slp, num_heads, c_real, null_emb, null_mask,
                 ssc):
    n_layers = slp.fp_fc1_k.shape[0]
    B, _, L = x.shape
    return (x, cond, mods[0, 0], mods[0, 1], 2 * B * 2 * L, slp, n_layers,
            num_heads, c_real, True,
            None if null_emb is None else null_emb.reshape(-1),
            None if null_mask is None else null_mask.float(), ssc)


def branch_phase_ns(x, cond, mods, slp: LayerParams, num_heads: int,
                    c_real: int, null_emb=None, null_mask=None,
                    ssc: Optional[LayerScales] = None, reps: int = 1):
    """Traced launches of the branch kernel (CUDA tensors, batch within
    one launch), averaged over ``reps``: the device-clock nanoseconds of
    each phase, shape (num_layers, len(PHASES)), and of the steps inside
    it as block 0 saw them, shape (num_layers, len(PHASES), N_SUB + 1):
    the N_SUB steps named in PRODUCT_STEPS / ATTENTION_STEPS (a row
    phase's whole pass falls into the last) and then the wait at the grid
    barrier.  Block 0 stamps the global timer after every grid barrier, so
    a phase's time is that of its slowest block.  Not counted in
    ``fused_branch.launches``."""
    import numpy as np
    n_layers = slp.fp_fc1_k.shape[0]
    n = len(PHASES) * n_layers
    steps = np.zeros((n, N_SUB + 1))
    for _ in range(reps):
        trace = torch.zeros(1 + n + n * N_SUB, dtype=torch.int64,
                            device=x.device)
        _launch(*_branch_args(x, cond, mods, slp, num_heads, c_real, null_emb,
                              null_mask, ssc), trace=trace)
        stamps = trace.cpu().numpy()
        # phase start | block 0's stamps inside | phase end.  A stamp a
        # phase does not make (a row phase's first four) stays 0: the
        # running maximum carries the previous one forward, so that step
        # reads as 0
        edges = np.concatenate([stamps[:n, None],
                                stamps[1 + n:].reshape(n, N_SUB),
                                stamps[1:1 + n, None]], axis=1)
        steps += np.diff(np.maximum.accumulate(edges, axis=1), axis=1) / reps
    steps = steps.reshape(n_layers, len(PHASES), N_SUB + 1)
    return steps.sum(-1), steps


def kernel_probe(kind: str, n: int, x, cond, mods, slp: LayerParams,
                 num_heads: int, c_real: int,
                 ssc: Optional[LayerScales] = None):
    """One of the probes of ``csrc/fused_layer.cu``, on the grid and
    dynamic shared memory the branch kernel gets for these arguments:
    ``'barrier'`` runs ``n`` grid barriers and nothing else; ``'copy'`` has
    every block stage the operand rows of the widest product ``n`` times
    out of L2, all blocks the same rows, as a product phase does.  Returns
    ``(launch, info)``: a function that launches the probe once, and
    ``dict(blocks, smem_bytes, rows, row_elems)``, the geometry and what a
    block copies per repeat.  No launch counter moves."""
    code = {"barrier": 0, "copy": 1}[kind]
    cargs, _out, _scratch, _plan = _pack(*_branch_args(
        x, cond, mods, slp, num_heads, c_real, None, None, ssc))
    fn = _lib(probe=True)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = (ctypes.c_int64 * 4)()

    def call(n_, buf_ptr=0):
        err = fn(*cargs, stream, code, n_, buf_ptr, out)
        if err != 0:
            raise RuntimeError(f"fused layer probe failed: CUDA error {err}")

    call(-1)                                       # geometry only
    info = dict(blocks=out[0], smem_bytes=out[1], rows=out[2],
                row_elems=out[3])
    buf = torch.zeros(4 * out[2] * out[3] if code else 1, dtype=x.dtype,
                      device=x.device)             # csrc COPY_SETS row sets
    return (lambda: call(n, buf.data_ptr())), info
