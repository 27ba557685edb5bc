"""The streamlined eta=0 DDIM + RePaint step: kernel and plain version.

Counterpart of ``diffsheg_tpu/ops/step_math.py``.  For the serving
configuration (``mean_type='epsilon'``, no clipping, eta = 0) the DDIM
update's reconstructed epsilon is the model output, so one step is

    x0   = r x - rm1 eps;  mean = sqrt(ab_prev) x0 + sqrt(1-ab_prev) eps
    head = saved tail if valid else sqrt(ab_prev) gt + sqrt(1-ab_prev) n
    head = linear blend toward mean when sqrt(1-ab_prev) < 0.2

with the level's scalars ``scal = (ab_prev, r, rm1, prev_valid)`` held
on the host as float32 values.

- :func:`ddim_repaint_step_reference` is the plain version;
- :func:`fused_ddim_repaint_step` launches the kernel of
  ``csrc/step_math.cu`` (replacing the Pallas ``fused_ddim_repaint_step``,
  diffsheg_tpu/ops/step_math.py:111) on a CUDA tensor, or raises; on a
  CPU tensor it runs the plain version.  Launches are counted in
  ``fused_ddim_repaint_step.launches``, each in a ``launch.ddim_step``
  span (``utils/profiling.py``).  The launch shape (four channels a
  thread or one) is :func:`_step_plan`'s choice, made here;
- :func:`ddim_repaint_step` is the dispatcher between the two (the
  kernel for CUDA tensors unless told otherwise);
- :func:`empty_launch` launches a kernel that does nothing, with a plan's
  shape: the floor under the step kernel's time.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from diffsheg_tpu_torch.utils.profiling import span

KERNEL_SOURCE = "step_math.cu"

# (ab_prev, r, rm1, prev_valid), each a float32 value
StepScalars = Tuple[float, float, float, float]

_MAX_THREADS = 256
_MAX_GRID_Y = 65535


class StepPlan(NamedTuple):
    """Launch shape: ``vec`` four channels a thread (float4) or one;
    ``grid_x`` blocks of ``threads`` across the channels, ``grid_y``
    blocks down the B*T frame rows (each walks rows ``grid_y`` apart)."""
    vec: bool
    threads: int
    grid_x: int
    grid_y: int


def _step_plan(B: int, T: int, C: int, aligned: bool = True) -> StepPlan:
    """Four channels a thread when C % 4 == 0 and every pointer is 16-byte
    aligned (``aligned``), else one; a block row per frame row."""
    vec = aligned and C % 4 == 0
    lanes = C // 4 if vec else C
    threads = min(_MAX_THREADS, -(-lanes // 32) * 32)
    return StepPlan(vec, threads, -(-lanes // threads),
                    min(B * T, _MAX_GRID_Y))


def blend_weights(ov: int, device) -> torch.Tensor:
    """``linspace(0, 1, ov)`` as ``i / max(ov - 1, 1)`` (f32 division, the
    kernel's formula)."""
    return (torch.arange(ov, dtype=torch.float32, device=device)
            / float(max(ov - 1, 1))).reshape(1, ov, 1)


def ddim_repaint_step_reference(
    x: torch.Tensor,                      # (B, T, C) current sample
    eps_out: torch.Tensor,                # (B, T, C) model epsilon
    scal: StepScalars,
    gt: Optional[torch.Tensor],           # (B, T, C) or None
    gt_noise: Optional[torch.Tensor],     # (B, T, C)
    prev_tail: Optional[torch.Tensor],    # (B, ov, C) saved noisy tail
    overlap_len: int,
    add_blend: bool,
) -> torch.Tensor:
    """Plain version, f32, each product and sum rounded on its own."""
    f32 = np.float32
    ab_prev, r, rm1, prev_valid = (f32(s) for s in scal)
    sqrt_ab_prev = float(np.sqrt(ab_prev))
    noise_w = np.sqrt(f32(1.0) - ab_prev)
    x0 = float(r) * x - float(rm1) * eps_out
    mean = sqrt_ab_prev * x0 + float(noise_w) * eps_out
    if gt is None:
        return mean
    ov = overlap_len
    head = (sqrt_ab_prev * gt[:, :ov] + float(noise_w) * gt_noise[:, :ov])
    if prev_tail is not None and prev_valid > 0:
        head = prev_tail
    if add_blend and noise_w < f32(0.2):
        w = blend_weights(ov, x.device)
        head = head * (1.0 - w) + mean[:, :ov] * w
    return torch.cat([head, mean[:, ov:]], dim=1)


def _lib():
    from diffsheg_tpu_torch.ops.build import library
    fn = library(KERNEL_SOURCE).diffsheg_ddim_repaint_step
    if fn.argtypes is None:     # 64-bit pointers, not ctypes' default int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name} is {t.dtype} on {t.device}, expected "
                         f"float32 on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_ddim_repaint_step(x, eps_out, scal: StepScalars, gt, gt_noise,
                            prev_tail, overlap_len: int,
                            add_blend: bool) -> torch.Tensor:
    """One step's update after the model call.  CUDA tensors: the kernel
    of ``csrc/step_math.cu``; CPU tensors: the plain version."""
    if x.device.type == "cpu":
        return ddim_repaint_step_reference(x, eps_out, scal, gt, gt_noise,
                                           prev_tail, overlap_len, add_blend)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    with span("launch.ddim_step"):
        B, T, C = x.shape
        has_gt = gt is not None
        ov = overlap_len if has_gt else 0
        _check("x", x, (B, T, C), x.device)
        _check("eps_out", eps_out, (B, T, C), x.device)
        if has_gt:
            if not 1 <= ov <= T:
                raise ValueError(f"overlap_len {ov} outside [1, {T}]")
            _check("gt", gt, (B, T, C), x.device)
            _check("gt_noise", gt_noise, (B, T, C), x.device)
        if prev_tail is not None:
            if not has_gt:
                raise ValueError("prev_tail needs gt")
            _check("prev_tail", prev_tail, (B, ov, C), x.device)
        out = torch.empty_like(x)

        def ptr(t):
            return 0 if t is None else t.data_ptr()

        ab_prev, r, rm1, valid = (float(np.float32(s)) for s in scal)
        plan = _step_plan(B, T, C, all(
            t.data_ptr() % 16 == 0
            for t in (x, eps_out, gt, gt_noise, prev_tail, out)
            if t is not None))
        err = _lib()(x.data_ptr(), eps_out.data_ptr(), ptr(gt), ptr(gt_noise),
                     ptr(prev_tail), out.data_ptr(), B, T, C, ov, ab_prev, r,
                     rm1, valid, int(has_gt), int(prev_tail is not None),
                     int(add_blend and has_gt), int(plan.vec), plan.threads,
                     plan.grid_x, plan.grid_y,
                     torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"step kernel launch failed: CUDA error {err}")
    fused_ddim_repaint_step.launches += 1
    return out


fused_ddim_repaint_step.launches = 0


def ddim_repaint_step(x, eps_out, scal: StepScalars, gt, gt_noise, prev_tail,
                      overlap_len: int, add_blend: bool,
                      use_fused: Optional[bool] = None) -> torch.Tensor:
    """The step's dispatcher.  ``use_fused=None``: the kernel for CUDA
    tensors, the plain version for CPU tensors; ``True``: the kernel's
    wrapper (which itself runs the plain version on CPU tensors);
    ``False``: the plain version.  No environment switch turns the kernel
    off."""
    if use_fused is None:
        use_fused = x.is_cuda
    step = (fused_ddim_repaint_step if use_fused
            else ddim_repaint_step_reference)
    return step(x, eps_out, scal, gt, gt_noise, prev_tail, overlap_len,
                add_blend)


def empty_launch(plan: StepPlan, device) -> None:
    """A kernel that does nothing, launched with ``plan``'s shape on the
    current stream of ``device`` (a CUDA device): the floor under a step
    kernel launch of that shape."""
    from diffsheg_tpu_torch.ops.build import library
    fn = library(KERNEL_SOURCE).diffsheg_empty_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(plan.grid_x, plan.grid_y, plan.threads,
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty launch failed: CUDA error {err}")
