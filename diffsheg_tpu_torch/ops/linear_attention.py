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
  Launches are counted in ``fused_linear_attention.launches``.
- :func:`linear_attention` dispatches as the JAX package does, with "on
  TPU" read as "on CUDA": the kernel for f32 self-attention on the card,
  the composition otherwise (the TPU-measured choice for bf16 is kept
  until an H100 measurement says otherwise).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

KERNEL_SOURCE = "linear_attention.cu"
_MAX_HEAD = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def linear_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """q (B, T, D), k and v (B, N, D) pre-softmax -> (B, T, D) in q's
    dtype; both contractions accumulate in f32 and ctx is rounded to q's
    dtype before the second, as in the JAX composition."""
    B, T, D = q.shape
    N = k.shape[1]
    hd = D // num_heads
    qs = q.reshape(B, T, num_heads, hd).softmax(-1)
    ks = k.reshape(B, N, num_heads, hd).softmax(1)
    vv = v.reshape(B, N, num_heads, hd)
    ctx = torch.einsum("bnhd,bnhl->bhdl", ks.float(), vv.float())
    y = torch.einsum("bnhd,bhdl->bnhl", qs.float(),
                     ctx.to(qs.dtype).float())
    return y.to(q.dtype).reshape(B, T, D)


def fused_linear_attention_reference(q, k, v, num_heads: int) -> torch.Tensor:
    """Plain version of the kernel: the composition on f32 copies (so ctx
    stays f32), rounded to the input dtype at the end."""
    return linear_attention_reference(q.float(), k.float(), v.float(),
                                      num_heads).to(q.dtype)


def _lib():
    from diffsheg_tpu_torch.ops.build import library
    fn = library(KERNEL_SOURCE).diffsheg_linear_attention
    if fn.argtypes is None:     # 64-bit pointers, not ctypes' default int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, num_heads: int) -> torch.Tensor:
    """Check what the kernel assumes, allocate the output, launch."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel supports float32/bfloat16, got {q.dtype}")
    B, T, D = q.shape
    if D % num_heads or D // num_heads > _MAX_HEAD:
        raise ValueError(f"head width {D}/{num_heads} must divide and be at "
                         f"most {_MAX_HEAD}")
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
    err = _lib()(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), B, T, D, num_heads,
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
        out = _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                      num_heads)
        fused_linear_attention.launches += 1
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


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int,
                     use_fused: Optional[bool] = None) -> torch.Tensor:
    """The kernel for f32 self-attention on the card (``use_fused=None``),
    the composition otherwise; cross-attention shapes always take the
    composition."""
    if use_fused is None:
        use_fused = q.is_cuda and q.dtype == torch.float32
    if q.shape != k.shape:
        use_fused = False
    if use_fused:
        return fused_linear_attention(q, k, v, num_heads)
    return linear_attention_reference(q, k, v, num_heads)
