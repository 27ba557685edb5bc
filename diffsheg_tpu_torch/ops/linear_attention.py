"""Linear-attention core: the kernel, its plain versions and the dispatch.

Counterpart of ``diffsheg_tpu/ops/linear_attention.py``.  Per (batch row,
head), on pre-softmax, pre-masked q, k, v (B, T, D):

    q' = softmax(q, axis=feature)        # per head
    k' = softmax(k, axis=time)
    ctx = k'^T v                          # (hd, hd)
    y  = q' ctx                           # (T, hd)

- :func:`linear_attention_reference` is the composition the JAX package
  runs for bf16 activations and cross-attention shapes: both contractions
  accumulate in f32 and ctx is rounded to q's dtype before the second.
- :func:`fused_linear_attention` is the kernel (``csrc/linear_attention.cu``,
  replacing the Pallas ``fused_linear_attention``,
  diffsheg_tpu/ops/linear_attention.py:115): everything in f32, ctx kept
  in f32, the output in the input dtype.  On a CPU tensor it runs the
  kernel's plain version (the composition on f32 copies); on a CUDA
  tensor it launches the kernel or raises.  It is differentiable: the
  backward recomputes through the composition, as the JAX custom VJP does.
  Launches are counted in ``fused_linear_attention.launches``, and by
  (B, T, D, heads) in ``fused_linear_attention.launches_by_shape``; each
  runs in a ``launch.linear_attention`` span (``utils/profiling.py``).  How the
  work is cut into blocks is :func:`_launch_plan`'s choice, made here and
  passed to the kernel.
- :func:`linear_attention` dispatches as the JAX package does, with "on
  TPU" read as "on CUDA": the kernel for f32 self-attention on the card,
  the composition otherwise (the TPU-measured choice for bf16 is kept
  until an H100 measurement says otherwise).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from diffsheg_tpu_torch.utils.profiling import span

KERNEL_SOURCE = "linear_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's constants (csrc/linear_attention.cu) and the card's
_THREADS = 256                # threads per block
_THREADS_LONG = 512           # ... when a block takes one head of T >= 64
                              # or a head wider than 256
_ACC = 16                     # ctx values a thread holds, at most
_LONG_ROWS = 64
_PAD = 4                      # floats after each staged row
_SMEM_MAX = 232448            # shared bytes a block can use (H100)
_SMS = 132                    # streaming multiprocessors (H100 SXM)
_TILE_ROWS = 128              # rows per tile in the tiled mode, at most
_NARROW = 16                  # head widths that group heads in a block
_GROUP_WIDTH = 128            # columns of D a grouped block takes, at most


class LaunchPlan(NamedTuple):
    """How the kernel cuts (B, T, D, H) into blocks.  Block ``i`` takes
    batch row ``i // (splits * groups)``, heads ``heads * ((i // splits) %
    groups)`` onward and output columns ``width * (i % splits)`` onward of
    each (``groups = H // heads``).  ``mode`` 'staged': all of T in shared
    memory at once; 'tiled': tiles of ``tile_rows`` rows."""
    mode: str
    grid: int
    heads: int
    splits: int
    width: int
    tile_rows: int
    vec: bool
    threads: int
    smem_bytes: int


def _smem_bytes(hd: int, heads: int, width: int, rows: int,
                staged: bool) -> int:
    """The kernel's shared bytes: k (and q, staged) rows of heads * hd + PAD
    floats, v rows of heads * width + PAD, ctx, the row sums of exp(q)."""
    cw = heads * hd
    return 4 * (rows * ((cw + _PAD) * (2 if staged else 1)
                        + heads * width + _PAD) + cw * width + rows * heads)


@functools.lru_cache(maxsize=None)
def _launch_plan(B: int, T: int, D: int, H: int,
                 vec: bool = True) -> LaunchPlan:
    """The plan for (B, T, D) with H heads.  ``vec``: the pointers allow
    16-byte loads (the plan then also needs hd % 4 == 0).  Narrow
    heads (hd <= 16) are grouped, as many as fill 128 columns of D,
    while the grid keeps a block per SM; otherwise, at small B*H, each
    (row, head) is split over its output columns (multiples of four) as
    far as one wave of blocks allows, and a head wider than 64 as far as a
    block's threads hold its ctx columns.  All of T is staged when it fits
    in a block's shared memory; past that, tiles.  A block of one head runs
    512 threads from T 64 on (shorter chains on the critical path) or when
    the head is wider than 256 (a thread a column of k; past 512, the wide
    kernels, a thread every 512th column), every other block 256 (on the
    H100, 256 won at T 12 and 34, 512 at 88 and 512).  Raises
    ``ValueError`` for heads that do not divide D, and for a head wider
    than 8192, whose ctx columns no block's accumulators hold."""
    if B < 1 or T < 1 or H < 1 or D % H:
        raise ValueError(f"bad shape (B, T, D) = {(B, T, D)}, {H} heads")
    hd = D // H
    if hd > _THREADS_LONG * _ACC:
        raise ValueError(f"head width {D}/{H} = {hd}: a block's {_THREADS_LONG}"
                         f" threads hold {_THREADS_LONG * _ACC} ctx values, "
                         f"not one column of {hd}")
    vec = vec and hd % 4 == 0
    heads = 1
    if vec and hd <= _NARROW:
        heads = max(n for n in range(1, H + 1)
                    if H % n == 0 and n * hd <= _GROUP_WIDTH
                    and (n == 1 or B * (H // n) >= _SMS))
    threads = (_THREADS_LONG if heads == 1 and (T >= _LONG_ROWS
                                                or hd > _THREADS)
               else _THREADS)
    width = hd
    if vec and heads == 1:
        fits = [w for w in range(4, hd + 1, 4)
                if hd % w == 0 and B * H * (hd // w) <= _SMS]
        width = min(fits, default=hd)
    if heads * hd * width > threads * _ACC:     # only heads wider than 64
        fits = [w for w in range(1, hd + 1)
                if hd % w == 0 and hd * w <= threads * _ACC]
        if vec and not any(w % 4 == 0 for w in fits):   # hd past 2048
            vec = False
        width = max(w for w in fits if w % 4 == 0 or not vec)
    rows, staged = T, True
    if _smem_bytes(hd, heads, width, T, True) > _SMEM_MAX:
        rows, staged = min(T, _TILE_ROWS), False
        while _smem_bytes(hd, heads, width, rows, False) > _SMEM_MAX:
            rows //= 2
    splits = hd // width
    return LaunchPlan("staged" if staged else "tiled",
                      B * (H // heads) * splits, heads, splits, width, rows,
                      vec, threads, _smem_bytes(hd, heads, width, rows,
                                                staged))


def _block_work(plan: LaunchPlan, H: int,
                block: int) -> Tuple[int, range, range]:
    """(batch row, heads, output columns) that block ``block`` writes, by
    the kernel's own index arithmetic; it walks all of T (in tiles of
    ``tile_rows`` in the tiled mode)."""
    groups = H // plan.heads
    j, g = block % plan.splits, (block // plan.splits) % groups
    return (block // (plan.splits * groups),
            range(g * plan.heads, (g + 1) * plan.heads),
            range(j * plan.width, (j + 1) * plan.width))


def linear_attention_core(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """The two-einsum contraction on (B, T, H, hd) inputs, q already
    softmaxed over hd and k over T, v masked: f32 accumulation, ctx rounded
    to q's dtype before the second product, the result in q's dtype."""
    ctx = torch.einsum("bnhd,bnhl->bhdl", k.float(), v.float())
    y = torch.einsum("bnhd,bhdl->bnhl", q.float(), ctx.to(q.dtype).float())
    return y.to(q.dtype)


def linear_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """q (B, T, D), k and v (B, N, D) pre-softmax -> (B, T, D) in q's
    dtype: the softmaxes, then :func:`linear_attention_core`, as in the JAX
    composition."""
    B, T, D = q.shape
    N = k.shape[1]
    hd = D // num_heads
    qs = q.reshape(B, T, num_heads, hd).softmax(-1)
    ks = k.reshape(B, N, num_heads, hd).softmax(1)
    vv = v.reshape(B, N, num_heads, hd)
    return linear_attention_core(qs, ks, vv).reshape(B, T, D)


def fused_linear_attention_reference(q, k, v, num_heads: int) -> torch.Tensor:
    """Plain version of the kernel: the composition on f32 copies (so ctx
    stays f32), rounded to the input dtype at the end."""
    return linear_attention_reference(q.float(), k.float(), v.float(),
                                      num_heads).to(q.dtype)


def _lib():
    from diffsheg_tpu_torch.ops.build import library
    fn = library(KERNEL_SOURCE).diffsheg_linear_attention
    if fn.argtypes is None:     # 64-bit pointers, not ctypes' default int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, num_heads: int) -> torch.Tensor:
    """Check what the kernel assumes, allocate the output, launch with
    :func:`_launch_plan`'s plan."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel supports float32/bfloat16, got {q.dtype}")
    B, T, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, expected "
                             f"{q.dtype} on {q.device}")
        if tuple(t.shape) != (B, T, D):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(B, T, D)} (self-attention only)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(q)
    align = 4 * q.element_size()          # four elements a load
    vec = all(t.data_ptr() % align == 0 for t in (q, k, v, out))
    plan = _launch_plan(B, T, D, num_heads, vec=vec)
    err = _lib()(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), B, T, D, num_heads,
                 plan.heads, plan.width, plan.tile_rows,
                 int(plan.mode == "staged"), int(plan.vec), plan.threads,
                 plan.smem_bytes,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"linear attention kernel launch failed: CUDA "
                           f"error {err}")
    return out


class _FusedLinearAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads = num_heads
        if q.device.type == "cpu":
            return fused_linear_attention_reference(q, k, v, num_heads)
        if q.device.type != "cuda":
            raise ValueError(f"unsupported device {q.device}")
        with span("launch.linear_attention"):
            out = _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                          num_heads)
        fused_linear_attention.launches += 1
        fused_linear_attention.launches_by_shape[(*q.shape, num_heads)] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            y = linear_attention_reference(*qkv, ctx.num_heads)
            grads = torch.autograd.grad(y, qkv, g)
        return (*grads, None)


def fused_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """Fused softmax-q / softmax-k linear attention, (B, T, D) ->
    (B, T, D).  CUDA tensors: the kernel; CPU tensors: its plain
    version."""
    return _FusedLinearAttention.apply(q, k, v, num_heads)


fused_linear_attention.launches = 0
fused_linear_attention.launches_by_shape = collections.Counter()


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int,
                     use_fused: Optional[bool] = None) -> torch.Tensor:
    """The kernel for f32 activations on the card (``use_fused=None``),
    the composition otherwise.  A memory of another shape than the queries
    (``q.shape != k.shape``: a cross-attention over a memory of another
    length) always takes the composition, as in JAX; the decoder's
    cross-attention, whose memory has the window's length, takes the
    kernel."""
    if use_fused is None:
        use_fused = q.is_cuda and q.dtype == torch.float32
    if q.shape != k.shape:
        use_fused = False
    if use_fused:
        return fused_linear_attention(q, k, v, num_heads)
    return linear_attention_reference(q, k, v, num_heads)
