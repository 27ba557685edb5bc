"""f32 matrix products on the tensor cores: split TF32, and the dense layer
that routes to it.

- :func:`split_tf32` writes each f32 value as ``hi + lo`` as the tensor
  cores read it: ``hi`` x rounded to TF32 (10 mantissa bits, the low 13
  bits zero, to nearest), ``lo`` the rest ``x - hi`` truncated to TF32;
  ``|x - (hi + lo)| <= 2^-22 |x|`` for normal x whose ``lo`` is normal.
  An infinite x keeps ``hi = x``, ``lo = 0``; a NaN gives a NaN ``lo``.
- :func:`gemm_tf32x3` is ``csrc/gemm_tf32x3.cu``: C = op(a) op(b) (+ bias)
  with each product ``lo*hi + hi*lo + hi*hi`` accumulated in f32 (three
  TF32 products on the tensor cores, f32-grade).  ``layout`` 'nt': a
  (M, K), b (N, K), C = a b^T (the forward of a dense layer, with its
  bias); 'nn': a (M, K), b (K, N) (its dX); 'tn': a (K, M), b (K, N),
  C = a^T b (its dW).  It replaces no TPU kernel (the JAX package leaves
  these products to XLA's ``dot``).  On a CPU tensor it runs
  :func:`gemm_tf32x3_reference`, the same split and the three f32
  products summed in the kernel's order; on a CUDA tensor it launches the
  kernel or raises.  Launches are counted in ``gemm_tf32x3.launches`` and
  by (M, N, K, layout) in ``gemm_tf32x3.launches_by_shape``; each runs in
  a ``launch.gemm_tf32x3`` span (``utils/profiling.py``).
- :func:`linear_tf32x3` is ``F.linear`` through the kernel, forward and
  backward (dX 'nn', dW 'tn', db a column sum), at any widths (those off
  a multiple of 4 padded with zeros for the kernel's 16-byte rows).
- :class:`Dense` is ``nn.Linear`` with the route: :func:`takes_tf32x3`
  (f32 on the card, at least :data:`MIN_ROWS` rows and :data:`MIN_WORK`
  multiply-adds) sends its forward and backward through
  :func:`linear_tf32x3`; everything else, the CPU, bf16 and small
  products, runs ``F.linear`` exactly as ``nn.Linear`` does.  Parameters
  and the state dict are ``nn.Linear``'s.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from diffsheg_tpu_torch.utils.profiling import span

KERNEL_SOURCE = "gemm_tf32x3.cu"
LAYOUTS = ("nt", "nn", "tn")

# the kernel's tile (csrc/gemm_tf32x3.cu: BM, BN, BK)
_BM, _BN, _BK = 128, 128, 32
_MIN_KPS = 32        # k-steps a split takes at least, where k is split

# Where a dense layer's f32 products take the kernel, measured on the H100
# (``chip_smoke.py --only crossover``: forward, dX and dW together against
# cuBLAS f32, at every (in, out) of a BEAT training step, 512 to 16 384
# rows; PERF.md): the kernel won at every point of rows x in x out
# (widths rounded up to 4) >= 2^30 multiply-adds and lost at points up to
# 2^29, narrow layers (128 -> 128, 52 -> 512) at every row count measured.
# MIN_ROWS is the least row count measured.
MIN_ROWS = 512
MIN_WORK = 1 << 30


def _bits(x: torch.Tensor) -> torch.Tensor:
    """f32 -> its bits as non-negative int64."""
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _from_bits(u: torch.Tensor) -> torch.Tensor:
    """Non-negative int64 bits -> f32."""
    return ((u ^ 0x80000000) - 0x80000000).to(torch.int32).view(torch.float32)


def _tf32_rna(u: torch.Tensor) -> torch.Tensor:
    """Round f32 bits to TF32, to nearest (ties away from zero): half an
    ulp added to the magnitude, the low 13 bits dropped."""
    return (u + 0x1000) & 0xFFFFE000


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 x -> (hi, lo), both TF32, x = hi + lo to 2^-22 relative: the
    kernel keeps ``x - hi`` (exact in f32) and the tensor cores read it
    truncated to TF32."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, got {x.dtype}")
    hi = _from_bits(_tf32_rna(_bits(x)))
    lo = torch.where(x == hi, torch.zeros_like(x), x - hi)
    return hi, _from_bits(_bits(lo) & 0xFFFFE000)


def _shapes(a: torch.Tensor, b: torch.Tensor,
            layout: str) -> Tuple[int, int, int]:
    """(M, N, K) of op(a) op(b); raises on a layout or shapes that do not
    multiply."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}, expected one of {LAYOUTS}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"2-d operands expected, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    M, K = a.shape if layout[0] == "n" else a.shape[::-1]
    N, Kb = b.shape if layout[1] == "t" else b.shape[::-1]
    if K != Kb:
        raise ValueError(f"{layout}: {tuple(a.shape)} and {tuple(b.shape)} "
                         "do not multiply")
    return M, N, K


def gemm_tf32x3_reference(a: torch.Tensor, b: torch.Tensor, layout: str,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the kernel: both operands split, then
    ``lo*hi + hi*lo + hi*hi`` as three f32 products (each TF32 x TF32
    product is exact in f32), the bias last."""
    _shapes(a, b, layout)
    A = a if layout[0] == "n" else a.t()
    B = b.t() if layout[1] == "t" else b
    ah, al = split_tf32(A)
    bh, bl = split_tf32(B)
    out = al @ bh
    out += ah @ bl
    out += ah @ bh
    if bias is not None:
        out += bias
    return out


@functools.lru_cache(maxsize=None)
def split_plan(M: int, N: int, K: int, sms: int) -> Tuple[int, int]:
    """TN's (k-steps of 32 a split takes, splits): its contraction (every
    row of the batch) is split over k where its tiles leave SMs idle and
    each split keeps at least ``_MIN_KPS`` k-steps."""
    tiles = -(-M // _BM) * -(-N // _BN)
    k_steps = -(-K // _BK)
    splits = max(1, min(sms // tiles, k_steps // _MIN_KPS))
    kps = -(-k_steps // splits)
    return kps, -(-k_steps // kps)


def _lib():
    from diffsheg_tpu_torch.ops.build import library
    fn = library(KERNEL_SOURCE).diffsheg_gemm_tf32x3
    if fn.argtypes is None:     # 64-bit pointers, not ctypes' default int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


_REFUSALS = {-1: "an inner dimension is not a multiple of 4",
             -2: "an operand is not 16-byte aligned",
             -3: "bad layout or shape",
             -4: "the driver has no cuTensorMapEncodeTiled",
             -5: "the driver refused a tensor map"}


def _launch(a: torch.Tensor, b: torch.Tensor, layout: str,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    M, N, K = _shapes(a, b, layout)
    for name, t in (("a", a), ("b", b), ("bias", bias)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != a.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, expected "
                             f"float32 on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"bias has shape {tuple(bias.shape)}, expected "
                         f"{(N,)}")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    if layout == "tn":      # scratch: the splits' partials
        kps, splits = split_plan(M, N, K, sms)
        shape = (splits, M, N) if splits > 1 else None
    else:                   # scratch: B's hi and lo, K-major
        kps, shape = -(-K // _BK), (2, N, K)
    scratch = (None if shape is None else
               torch.empty(shape, dtype=torch.float32, device=a.device))
    err = _lib()(LAYOUTS.index(layout), a.data_ptr(), b.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 M, N, K, kps, sms,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        why = _REFUSALS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"gemm_tf32x3 {layout} {(M, N, K)}: {why}")
    return out


def gemm_tf32x3(a: torch.Tensor, b: torch.Tensor, layout: str,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """op(a) op(b) (+ bias) in split TF32.  CUDA tensors: the kernel; CPU
    tensors: its plain version."""
    if a.device.type == "cpu":
        return gemm_tf32x3_reference(a, b, layout, bias)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    with span("launch.gemm_tf32x3"):
        out = _launch(a, b, layout, bias)
    M, N, K = _shapes(a, b, layout)
    gemm_tf32x3.launches += 1
    gemm_tf32x3.launches_by_shape[(M, N, K, layout)] += 1
    return out


gemm_tf32x3.launches = 0
gemm_tf32x3.launches_by_shape = collections.Counter()


def _padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """t (r, c) with zero rows and columns appended to (rows, cols)."""
    r, c = t.shape
    if (r, c) == (rows, cols):
        return t
    return F.pad(t, (0, cols - c, 0, rows - r))


class _LinearTF32x3(torch.autograd.Function):
    """x (M, K) w (N, K)^T + b.  The kernel loads whole 16-byte rows, so a
    width off a multiple of 4 (the gesture branch's 947-wide condition
    concat, the 141- and 51-channel heads) is padded with zeros: x's K to
    K4 once in the forward (kept for dW), w to (N4, K4), dY's N to N4 in
    the backward; the zeros add nothing."""

    @staticmethod
    def forward(ctx, x, w, b):
        N, K = w.shape
        N4, K4 = -(-N // 4) * 4, -(-K // 4) * 4
        x = _padded(x.contiguous(), x.shape[0], K4)
        w = _padded(w.contiguous(), N4, K4)
        ctx.save_for_backward(x, w)
        ctx.widths = (N, K)
        ctx.has_bias = b is not None
        if b is not None and N4 != N:
            b = F.pad(b, (0, N4 - N))
        y = gemm_tf32x3(x, w, "nt", b)
        return y if N4 == N else y[:, :N].contiguous()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        N, K = ctx.widths
        g = _padded(g.contiguous(), g.shape[0], w.shape[0])
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = gemm_tf32x3(g, w, "nn")[:, :K]
        if ctx.needs_input_grad[1]:
            gw = gemm_tf32x3(g, x, "tn")[:N, :K].contiguous()
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = g[:, :N].sum(0)
        return gx, gw, gb


def linear_tf32x3(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear(x, w, b)`` with every product in split TF32: x (..., in),
    w (out, in), b (out,) -> (..., out); any widths."""
    y = _LinearTF32x3.apply(x.reshape(-1, x.shape[-1]), w, b)
    return y.reshape(*x.shape[:-1], w.shape[0])


def takes_tf32x3(device_type: str, dtype: torch.dtype, rows: int,
                 in_features: int, out_features: int) -> bool:
    """The route: a dense layer's products take the kernel for f32 on the
    card at :data:`MIN_ROWS` rows or more and :data:`MIN_WORK`
    multiply-adds or more (widths as the kernel pads them)."""
    work = rows * (-(-in_features // 4) * 4) * (-(-out_features // 4) * 4)
    return (device_type == "cuda" and dtype == torch.float32
            and rows >= MIN_ROWS and work >= MIN_WORK)


class Dense(nn.Linear):
    """``nn.Linear`` whose f32 products on the card, where
    :func:`takes_tf32x3` takes them, run in split TF32 on the tensor cores
    (:func:`linear_tf32x3`); anything else is ``F.linear``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (self.weight.dtype == x.dtype
                and takes_tf32x3(x.device.type, x.dtype,
                                 x.numel() // self.in_features,
                                 self.in_features, self.out_features)):
            return linear_tf32x3(x, self.weight, self.bias)
        return F.linear(x, self.weight, self.bias)
