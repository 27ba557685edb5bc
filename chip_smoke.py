#!/usr/bin/env python3
"""The port's on-card check: ``diffsheg_tpu_torch`` on one NVIDIA card.

An index of its phases, in the order they run; each ``phase_*``
function's docstring says what the phase runs and holds.

1. device   — the card's name and power limit (nvidia-smi).
2. build    — the CUDA kernels of ``diffsheg_tpu_torch/csrc`` (nvcc).
3. kernels  — every kernel against its plain version at the main paths'
              shapes, timed beside its bound, and the kernels' cases past
              them (``phase_kernels``; the closing ``kernels`` line's rows
              are ``KERNEL_ROWS``).
4. stream   — short streams held to the numerics bands against kernel-free
              f32 references, quantized, wide, long and ragged models too
              (``phase_stream``).
5. e2e      — the BEAT serving pipeline on 60 s of audio through the
              branch kernel, a short stream through the per-layer kernel,
              quantized serving (``phase_e2e``).
6. uncached — the f32 module forward with the step kernel, on the level
              cache and without it (``phase_uncached``).
7. live     — the serving daemon through ``MotionClient`` sessions
              (``phase_live``).
8. variants — every model variant through the module forward
              (``phase_variants``).
9. generate — ``cli generate`` from a wav to BVH and face JSON
              (``phase_generate``).
10. train   — ``cli train`` at the published batch, the kernel against its
              plain version inside steps, evaluation (``phase_train``).
11. data    — ``cli build-cache``, ``train``, ``eval`` and ``test-stream``
              on synthetic raw splits (``phase_data``).
12. scale   — the speech frontend inside the step; several processes
              (``phase_scale``).
13. tools   — ``cli doctor --calibrate``, the bench guards, the data plane,
              the config reference (``phase_tools``).
14. examples — the examples through their entry points (``phase_examples``).

Each main path runs with every kernel's launch count set to 0 just before
it and read just after, and the counts are asserted exactly
(``gemm_tf32x3``'s by (M, N, K, layout)).  TF32 is off in every phase that
holds an f32 band.  Phases 3-14 each log ``<phase>: phase <s> s``, the
build ``build: <s> s`` and the run ``total: <s> s``.  A timing that a
benchmark cell (``BENCHMARK.json``) takes at the same configuration is
left to the cell.  Prints its findings, a ``kernels`` JSON line, the
nvidia-smi line, and ends with ``{"ok": true, "device": {...}}``.  Any
failed phase raises and the exit code is non-zero; with no CUDA device it
exits 1 and prints no result.

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --only kernels
    python3 chip_smoke.py --only qkernels   # the quantized kernel cases
    python3 chip_smoke.py --only speech     # HuBERT beside WavLM
    python3 chip_smoke.py --only crossover  # gemm_tf32x3 against cuBLAS
    python3 chip_smoke.py --only live       # the serving daemon
    python3 chip_smoke.py --only variants   # every model variant
    python3 chip_smoke.py --only generate   # cli generate, wav to BVH
    python3 chip_smoke.py --only train      # cli train, evaluation
    python3 chip_smoke.py --only data       # build-cache, train, eval, test-stream
    python3 chip_smoke.py --only scale      # frontend in the step, 2 processes
    python3 chip_smoke.py --only tools      # cli doctor, guards, data plane
    python3 chip_smoke.py --only examples [--full] [--examples capacity,show]
        # the examples (all, or the items named)
    python3 chip_smoke.py --only kernels --ab OLD/linear_attention.cu [--ab-exact]
        # first time a kernel beside another version of its source (e.g.
        # the parent commit's), in one process; the file name picks the
        # kernel: fused_layer.cu, linear_attention.cu or step_math.cu; a
        # version that refuses a case (a width it cannot stage) is shown
        # refusing it
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# the H100's data-sheet peaks, as the benchmark's readers take them
from benchmark.flops.model import PEAKS

HBM_BYTES_PER_S = PEAKS["hbm_bytes_per_s"]
PEAK_FLOPS = {torch.bfloat16: PEAKS["bf16_flops"],
              torch.float32: PEAKS["f32_simt_flops"]}
TF32_FLOPS = PEAKS["tf32_flops"]   # its tensor cores in TF32, dense


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def device_ms(fn, reps: int) -> float:
    """Median device milliseconds of one call of ``fn``: CUDA events
    around each call, queued behind a sleep kernel that holds the device
    while the host enqueues the call, so the events time the device's work
    and not the host's launch overhead.  One call at a time: the plain
    branch's ~500 small launches per call stay inside the device's launch
    queue, which many calls back to back would overflow (the host would
    then pace the device again)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(4e9 * host_s + 1e6))   # ~2x host_s at ~2 GHz
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int) -> float:
    """Host milliseconds per synchronised call (launch overhead included)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean().sqrt() / (b ** 2).mean().sqrt())


def no_tf32() -> None:
    """Full-f32 products and convolutions (cuDNN defaults to TF32 for
    convolutions, e.g. the HuBERT conv encoder): called at the top of every
    phase that holds an f32 band."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def counters():
    """Every kernel wrapper of the port, by name; each counts its launches
    in ``.launches``."""
    from diffsheg_tpu_torch.ops.fused_layer import fused_branch, fused_layer
    from diffsheg_tpu_torch.ops.linear_attention import fused_linear_attention
    from diffsheg_tpu_torch.ops.products import gemm_tf32x3
    from diffsheg_tpu_torch.ops.step_math import fused_ddim_repaint_step
    return {"fused_branch": fused_branch, "fused_layer": fused_layer,
            "fused_linear_attention": fused_linear_attention,
            "fused_ddim_repaint_step": fused_ddim_repaint_step,
            "gemm_tf32x3": gemm_tf32x3}


def zero_counts() -> None:
    """Every kernel's launch count to 0, linear attention's, the per-layer
    kernel's and gemm_tf32x3's by shape too, the layer kernels' by
    width."""
    for fn in counters().values():
        fn.launches = 0
    counters()["fused_linear_attention"].launches_by_shape.clear()
    counters()["fused_layer"].launches_by_shape.clear()
    counters()["fused_layer"].launches_by_width.clear()
    counters()["fused_branch"].launches_by_width.clear()
    counters()["gemm_tf32x3"].launches_by_shape.clear()


class Launches(dict):
    """Launches by kernel name; ``.gemm`` holds gemm_tf32x3's by (M, N, K,
    layout), read at the same moment."""
    gemm: dict = {}


def launch_counts() -> Launches:
    out = Launches((n, fn.launches) for n, fn in counters().items())
    out.gemm = dict(counters()["gemm_tf32x3"].launches_by_shape)
    return out


def launch_gap(counts, want, gemm=None) -> str:
    """'' where ``counts`` are ``want`` exactly (a kernel not named: no
    launch) and gemm_tf32x3's launches by shape are ``gemm`` (none if not
    given); else what differs."""
    gemm = dict(gemm or {})
    want = {n: want.get(n, 0) for n in counters()}
    want["gemm_tf32x3"] = sum(gemm.values())
    got = getattr(counts, "gemm", gemm)
    if counts == want and got == gemm:
        return ""
    return (f"launches {dict(counts)}, expected {want}" + (
        "" if got == gemm else
        f"; gemm_tf32x3 by (M, N, K, layout) {got}, expected {gemm}"))


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(ms, 'bytes' | 'operations'): the least time for the work."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def layer_bound(nbytes: float, ops: tuple, dtype, quantized: bool) -> tuple:
    """(ms, 'bytes' | 'operations', route) of the fused-layer kernels, on
    the route they take: bf16 products and attention at the bf16
    tensor-core rate; f32 weight products as split TF32 on the tensor
    cores (three TF32 products each, two with int8 / int4 codes, which are
    exact in TF32) plus the attention on the CUDA cores at the f32 rate.
    ``ops``: (the weight products' operations, the attention's)."""
    prods, attn = ops
    if dtype == torch.bfloat16:
        return (*bound(nbytes, prods + attn, dtype), "bf16 tensor cores")
    n = 2 if quantized else 3
    tb = nbytes / HBM_BYTES_PER_S
    tf = n * prods / TF32_FLOPS + attn / PEAK_FLOPS[torch.float32]
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations",
            f"{n}xTF32 products at {TF32_FLOPS / 1e12:g} + attention at "
            f"{PEAK_FLOPS[torch.float32] / 1e12:g} TFLOP/s")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

QUANT_BITS = {"int8": 8, "int4": 4}


def case_inputs(dtype, B, T, Cp, c_real, null, dev, seed, quant="none",
                L=512, H=8, F=1024, n_layers=8):
    """Seeded inputs of one fused-layer kernel case: (x, cond, mods, slp,
    null_emb, null_mask, ssc), the nine matrices unquantized or as int8 /
    packed int4 codes (``quant``)."""
    from diffsheg_tpu_torch.ops.fused_layer import (quantize_layer_params,
                                                    random_layer_params)
    gen = torch.Generator().manual_seed(seed)
    slp = random_layer_params(n_layers, L, F, Cp, c_real, dtype, gen, dev)
    ssc = None
    if quant != "none":
        slp, ssc = quantize_layer_params(slp, QUANT_BITS[quant])
    x = torch.randn(B, T, L, generator=gen).to(dev, dtype)
    cond = torch.randn(B, T, Cp - L, generator=gen)
    cond[..., c_real - L:] = 0.0
    cond = cond.to(dev, dtype)
    mods = (0.3 * torch.randn(n_layers, 2, B, 2 * L, generator=gen)
            ).to(dev, dtype)
    null_emb = null_mask = None
    if null:
        ne = torch.randn(1, Cp, generator=gen)
        ne[:, c_real:] = 0.0
        null_emb = ne.to(dev, dtype)
        null_mask = (torch.arange(B) < B // 2).float().to(dev)
    return x, cond, mods, slp, null_emb, null_mask, ssc


def kernel_case(name, dtype, B, T, Cp, c_real, null, dev, seed, reps,
                quant="none", L=512, H=8, F=1024, n_layers=8):
    """Both kernels at one shape, unquantized or with the nine matrices as
    int8 / packed int4 codes (``quant``; the plain version gets the same
    codes and scales); returns a dict of findings."""
    from diffsheg_tpu_torch.ops.fused_layer import (fused_branch,
                                                    fused_branch_reference)
    x, cond, mods, slp, null_emb, null_mask, ssc = case_inputs(
        dtype, B, T, Cp, c_real, null, dev, seed, quant, L, H, F, n_layers)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    out = {}

    # fused_branch: the whole stack
    got = fused_branch(x, cond, mods, slp, H, c_real, null_emb, null_mask, ssc)
    ref = fused_branch_reference(x, cond, mods, slp, H, c_real, null_emb,
                                 null_mask, ssc)
    torch.cuda.synchronize()
    e_rel, e_abs = rel_rms(got, ref), float((got.float() - ref.float()).abs().max())
    def kernel():
        fused_branch(x, cond, mods, slp, H, c_real, null_emb, null_mask, ssc)

    def plain():
        fused_branch_reference(x, cond, mods, slp, H, c_real, null_emb,
                               null_mask, ssc)

    branch_ms, branch_wall = device_ms(kernel, reps), wall_ms(kernel, reps)
    plain_ms = device_ms(plain, max(3, reps // 4))
    # the bytes as stored: vectors, codes (int4: packed) and scales
    w_bytes = sum(t.numel() * t.element_size()
                  for t in (*slp, *(ssc or ())))
    io_bytes = sum(t.numel() * t.element_size() for t in (x, cond, mods, x))
    ops = layer_ops(B, T, Cp, L, H, F)
    b_ms, b_by, route = layer_bound(w_bytes + io_bytes,
                                    tuple(n_layers * o for o in ops), dtype,
                                    ssc is not None)
    out["fused_branch"] = dict(
        rel_rms=e_rel, max_abs_err=e_abs, ms=branch_ms, wall_ms=branch_wall,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, route=route,
        **plan_fields(x, slp, H, ssc))

    out["fused_layer"] = layer_result(x, cond, mods, slp, H, c_real,
                                      null_emb, null_mask, ssc, reps,
                                      w_bytes / n_layers, ops)
    log(f"weights[{name}]: {w_bytes / 1e6:.2f} MB stored per branch")
    if name.startswith("beat-ges") or name == "raw-ges-f32":
        trace_lines(name, x, cond, mods, slp, H, c_real, null_emb, null_mask,
                    ssc)
    if name in ("beat-ges-bf16", "beat-ges-f32"):
        probe_lines(name, reps, x, cond, mods, slp, H, c_real)
    check_lines(name, out, tol)
    return out


def layer_result(x, cond, mods, slp, H, c_real, null_emb, null_mask, ssc,
                 reps, layer_bytes, ops):
    """The per-layer kernel on layer 0 (assembled, padded feats) against
    its plain version: errors, device and host ms, bound (``ops``: a
    layer's products' and attention's operations, ``layer_ops``)."""
    from diffsheg_tpu_torch.ops.fused_layer import (
        chain_feats, fused_layer, fused_layer_reference, layer_at)
    lp = layer_at(slp, 0)
    sc = None if ssc is None else layer_at(ssc, 0)
    feats = chain_feats(x, cond, None if null_emb is None else null_emb[0],
                        null_mask).to(x.dtype).contiguous()
    ms_, mf_ = mods[0, 0].contiguous(), mods[0, 1].contiguous()
    got = fused_layer(x, feats, ms_, mf_, lp, H, c_real, sc)
    ref = fused_layer_reference(x, feats, ms_, mf_, lp, H, c_real, sc)
    torch.cuda.synchronize()
    l_rel, l_abs = rel_rms(got, ref), float((got.float() - ref.float()).abs().max())

    def lkernel():
        fused_layer(x, feats, ms_, mf_, lp, H, c_real, sc)

    def lplain():
        fused_layer_reference(x, feats, ms_, mf_, lp, H, c_real, sc)

    layer_ms, layer_wall = device_ms(lkernel, reps), wall_ms(lkernel, reps)
    lplain_ms = device_ms(lplain, max(3, reps // 4))
    lio = sum(t.numel() * t.element_size() for t in (x, feats, ms_, mf_, x))
    b_ms, b_by, route = layer_bound(layer_bytes + lio, ops, x.dtype,
                                    ssc is not None)
    return dict(rel_rms=l_rel, max_abs_err=l_abs, ms=layer_ms,
                wall_ms=layer_wall, plain_ms=lplain_ms, bound_ms=b_ms,
                bound_by=b_by, route=route, **plan_fields(x, slp, H, ssc))


def plan_fields(x, slp, H, ssc):
    """The plan of a launch of these arguments (``k_pass_plan``, one
    window of the batch past 256 rows): the passes of the widest product
    (1: the one-pass kernel), the attention's frames a chunk, k features
    and ctx columns a group (``tc`` 0: the whole window in one tile), and
    whether the launch takes the ragged build."""
    from diffsheg_tpu_torch.ops.fused_layer import _batch_groups, k_pass_plan
    B, T, L = x.shape
    L2, Cp = slp.fp_fc1_k.shape[-1], slp.fp_fc1_k.shape[-2]
    qb = 0 if ssc is None else (8 if L2 == 2 * L else 4)
    g = _batch_groups(B, T)[0]
    plan = k_pass_plan(x.dtype, qb, g.stop - g.start, T, Cp, L,
                       slp.ffn_l1_b.shape[-1], H)
    return dict(passes=plan.passes, tc=plan.tc, dg=plan.dg, cg=plan.cg,
                ragged=plan.ragged)


def check_lines(name, out, tol):
    for k, r in out.items():
        log(f"kernel[{k} {name}]: rel_rms={r['rel_rms']:.3e} (tol {tol:g}) "
            f"max_abs={r['max_abs_err']:.3e} ms={r['ms']:.4f} "
            f"wall_ms={r['wall_ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}; {r['route']}) passes={r['passes']} "
            f"attention={'one tile' if r['tc'] == 0 else 'chunks'} "
            f"tc={r['tc']} dg={r['dg']} cg={r['cg']} "
            f"build={'ragged' if r['ragged'] else 'plain'}")
        if not r["rel_rms"] <= tol:
            raise AssertionError(f"{k} {name}: rel_rms {r['rel_rms']:.3e} "
                                 f"> {tol:g}")


def layer_ops(B, T, Cp, L=512, H=8, F=1024):
    """One layer's operations: (the seven weight products, the
    attention)."""
    return (2 * B * T * (Cp * 2 * L + 2 * L * L + 5 * L * L + 2 * L * F),
            4 * B * T * L * (L // H))


# the per-layer kernel at the gesture branch's shapes of other main paths:
# the live path's (bf16) 12-frame window and 4 speakers of a 34-frame
# window; cli generate's default, 4 speaker styles of a 34-frame window in
# f32; one launch of training's evaluation, 7 windows of 34 frames in f32
LIVE_LAYER_CASES = (("live-t12-bf16", 1, 12, torch.bfloat16),
                    ("live-b4-bf16", 4, 34, torch.bfloat16),
                    ("layer-beat-4spk-f32", 4, 34, torch.float32),
                    ("layer-eval-beat-f32", 7, 34, torch.float32))


# widths past one pass of the layer kernels (K passes, k_pass_plan): raw
# HuBERT features (model.encode_hubert=False) widen the BEAT expression
# branch's feats to 512 + 256 + 1024 = 1792 and the gesture branch's to
# 1843, padded to 1920; ff_size 2048; in bf16 one pass takes 1920 and
# ff_size 6144 takes passes.  (name, dtype, B, T, Cp, c_real, F, layers,
# passes): 8 layers runs both kernels, 1 the per-layer kernel alone (cli
# generate's four speakers)
WIDE_CASES = (("raw-exp-f32", torch.float32, 1, 34, 1792, 1792, 1024, 8, 2),
              ("raw-ges-f32", torch.float32, 1, 34, 1920, 1843, 1024, 8, 2),
              ("raw-ges-bf16", torch.bfloat16, 1, 34, 1920, 1843, 1024, 8,
               1),
              ("raw-ges-4spk-f32", torch.float32, 4, 34, 1920, 1843, 1024, 1,
               2),
              ("ff2048-f32", torch.float32, 1, 34, 1024, 947, 2048, 8, 2),
              ("ff6144-bf16", torch.bfloat16, 1, 34, 1024, 947, 6144, 8, 6))


def wide_case(name, dtype, B, T, Cp, c_real, F, n_layers, passes, dev, seed,
              reps, quant="none"):
    """The layer kernels at a width past one pass (both, or the per-layer
    kernel alone for ``n_layers`` 1, unquantized), held to their dtype's
    tolerance; fails unless the launch took ``passes`` passes."""
    out = (kernel_case(name, dtype, B, T, Cp, c_real, False, dev, seed, reps,
                       quant, F=F) if n_layers > 1 else
           example_layer_case(name, B, T, dtype, 512, 8, F, Cp, c_real, dev,
                              seed, reps))
    got = {k: r["passes"] for k, r in out.items()}
    if set(got.values()) != {passes}:
        raise AssertionError(f"{name}: passes {got}, expected {passes}")
    return out


# windows past 256 frames and heads the one-tile attention does not take
# (attention in chunks of T, k_pass_plan's tc and dg): SHOW's widths at a
# 300-frame window and a classifier-free pair of 352-frame windows (its
# server's widest window_frames, 4 x 88), f32 and bf16, and with int8
# codes; 128-wide heads at a 256-frame window (L 1024), heads 144 wide (L
# 1152) at one BEAT window and at 300 frames, heads 12 wide (L 96), one
# head 1024 wide (k features in two groups).  (name, dtype, B, T, Cp,
# c_real, null rows, L, heads, F, quant, layers, tc expected: 0 the one
# tile, else the frames a chunk)
LONG_CASES = (
    ("show-t300-f32", torch.float32, 1, 300, 1024, 999, False, 512, 8, 1024,
     "none", 8, 300),
    ("show-t300-bf16", torch.bfloat16, 1, 300, 1024, 999, False, 512, 8,
     1024, "none", 8, 0),
    ("show-cfg-t352-f32", torch.float32, 2, 352, 1024, 999, True, 512, 8,
     1024, "none", 8, 352),
    ("show-cfg-t352-bf16", torch.bfloat16, 2, 352, 1024, 999, True, 512, 8,
     1024, "none", 8, 0),
    ("show-t300-bf16-int8", torch.bfloat16, 1, 300, 1024, 999, False, 512,
     8, 1024, "int8", 8, 0),
    ("hd128-t256-f32", torch.float32, 1, 256, 1536, 1487, False, 1024, 8,
     1024, "none", 2, 224),
    ("hd144-f32", torch.float32, 1, 34, 1664, 1615, False, 1152, 8, 1024,
     "none", 2, 0),
    ("hd144-t300-f32", torch.float32, 1, 300, 1664, 1615, False, 1152, 8,
     1024, "none", 2, 196),
    ("hd12-f32", torch.float32, 1, 88, 224, 200, False, 96, 8, 192, "none",
     2, 88),
    ("hd1024-f32", torch.float32, 1, 34, 1536, 1487, False, 1024, 1, 1024,
     "none", 2, 4))


def long_case(name, dtype, B, T, Cp, c_real, null, L, H, F, quant, n_layers,
              tc, dev, seed, reps):
    """Both layer kernels at a window or head width past the one-tile
    attention, held to their dtype's tolerance; fails unless the launch
    took the attention ``tc`` says."""
    out = kernel_case(name, dtype, B, T, Cp, c_real, null, dev, seed, reps,
                      quant, L=L, H=H, F=F, n_layers=n_layers)
    got = {k: r["tc"] for k, r in out.items()}
    if set(got.values()) != {tc}:
        raise AssertionError(f"{name}: attention tc {got}, expected {tc}")
    return out


# widths off a multiple of 16 and one head wider than a chunk of 4 frames
# beside ctx's 8 columns, which take the ragged build (k_pass_plan's
# ragged, cg): L 40 (5 heads of 8, F 80) and L 36 (4 heads of 9, F 72) at
# Cp 128, with null rows and int8 / int4 codes; the BEAT gesture branch at
# latent 520 (8 heads of 65) and ff_size 1032, phase 4's model; one head
# 4160 wide in f32 and 4224 in bf16, ctx's columns in groups of 4 (one
# layer: 0.7-1.5 GB of weights a layer).
# (name, dtype, B, T, Cp, c_real, null rows, L, heads, F, quant, layers,
# cg expected)
ODD_CASES = (
    ("odd-L40-f32", torch.float32, 1, 34, 128, 113, False, 40, 5, 80,
     "none", 8, 0),
    ("odd-L40-bf16", torch.bfloat16, 1, 34, 128, 113, False, 40, 5, 80,
     "none", 8, 0),
    ("odd-L40-bf16-int4", torch.bfloat16, 1, 34, 128, 113, False, 40, 5,
     80, "int4", 8, 0),
    ("odd-L36-cfg-f32", torch.float32, 2, 34, 128, 101, True, 36, 4, 72,
     "none", 8, 0),
    ("odd-L36-bf16-int8", torch.bfloat16, 1, 34, 128, 101, False, 36, 4, 72,
     "int8", 8, 0),
    ("odd-L520-f32", torch.float32, 1, 34, 1024, 955, False, 520, 8, 1032,
     "none", 8, 0),
    ("odd-L520-bf16", torch.bfloat16, 1, 34, 1024, 955, False, 520, 8, 1032,
     "none", 8, 0),
    ("odd-L520-f32-int8", torch.float32, 1, 34, 1024, 955, False, 520, 8,
     1032, "int8", 8, 0),
    ("hd4160-f32", torch.float32, 1, 34, 4224, 4200, False, 4160, 1, 4160,
     "none", 1, 4),
    ("hd4224-bf16", torch.bfloat16, 1, 34, 4352, 4300, False, 4224, 1, 4224,
     "none", 1, 4))


def odd_case(name, dtype, B, T, Cp, c_real, null, L, H, F, quant, n_layers,
             cg, dev, seed, reps):
    """Both layer kernels at a shape of the ragged build, held to their
    dtype's tolerance; fails unless the launch took the ragged build with
    ctx columns in groups of ``cg``."""
    out = kernel_case(name, dtype, B, T, Cp, c_real, null, dev, seed, reps,
                      quant, L=L, H=H, F=F, n_layers=n_layers)
    got = {k: (r["ragged"], r["cg"]) for k, r in out.items()}
    if set(got.values()) != {(True, cg)}:
        raise AssertionError(f"{name}: (ragged, cg) {got}, expected "
                             f"{(True, cg)}")
    return out


def live_layer_case(name, B, T, dtype, dev, seed, reps):
    """``fused_layer`` alone at one shape, held to its dtype's tolerance."""
    Cp, c_real = 1024, 947
    x, cond, mods, slp, _, _, _ = case_inputs(
        dtype, B, T, Cp, c_real, False, dev, seed, n_layers=1)
    w_bytes = sum(t.numel() * t.element_size() for t in slp)
    out = {"fused_layer": layer_result(x, cond, mods, slp, 8, c_real, None,
                                       None, None, reps, w_bytes,
                                       layer_ops(B, T, Cp))}
    check_lines(name, out, 1e-5 if dtype == torch.float32 else 8e-3)
    return out


def trace_lines(name, x, cond, mods, slp, H, c_real, null_emb, null_mask,
                ssc):
    """Where a layer's time goes inside the branch kernel, from traced
    launches: each phase, and inside it block 0's steps and its wait at the
    grid barrier."""
    from diffsheg_tpu_torch.ops.fused_layer import (
        ATTENTION_STEPS, PHASES, PRODUCT_STEPS, branch_phase_ns)
    ns, sub = (a.mean(0) / 1e3 for a in branch_phase_ns(
        x, cond, mods, slp, H, c_real, null_emb, null_mask, ssc, reps=5))
    log(f"phases[fused_branch {name}] us/layer: " + " ".join(
        f"{p}={t:.2f}" for p, t in zip(PHASES, ns))
        + f" | sum={ns.sum():.2f}")
    parts = []
    for p, steps in zip(PHASES, sub):
        if p.startswith("ln"):
            names, steps = ("work", "barrier"), steps[-2:]
        else:
            names = (ATTENTION_STEPS if p == "attention" else PRODUCT_STEPS
                     ) + ("barrier",)
        parts.append(f"{p}(" + " ".join(
            f"{k}={t:.2f}" for k, t in zip(names, steps)) + ")")
    log(f"subphases[fused_branch {name}] us/layer: " + " ".join(parts)
        + f" | barrier wait, all phases: {sub[:, -1].sum():.2f}")


def probe_lines(name, reps, x, cond, mods, slp, H, c_real):
    """The floor the branch kernel's grid barriers set (the same grid
    through as many barriers and no work), and the rate at which its
    blocks copy operand rows from L2 into shared memory."""
    from diffsheg_tpu_torch.ops.fused_layer import PHASES, kernel_probe
    n_layers = slp.fp_fc1_k.shape[0]
    n_sync = 1 + len(PHASES) * n_layers
    args = (x, cond, mods, slp, H, c_real)
    launch0, info = kernel_probe("barrier", 0, *args)
    launchn, _ = kernel_probe("barrier", n_sync, *args)
    t0, tn = device_ms(launch0, reps), device_ms(launchn, reps)
    log(f"barrier[grid {info['blocks']} x 256, {name}, "
        f"{info['smem_bytes']} B shared]: {n_sync} barriers {tn * 1e3:.2f} us, "
        f"none {t0 * 1e3:.2f} us, each {(tn - t0) * 1e3 / n_sync:.3f} us, "
        f"per layer {(tn - t0) * 1e3 / n_layers:.2f} us")
    iters = 50
    per_block = info["rows"] * info["row_elems"] * x.element_size()
    launch1, _ = kernel_probe("copy", 1, *args)
    launchk, _ = kernel_probe("copy", 1 + iters, *args)
    t1, tk = device_ms(launch1, reps), device_ms(launchk, reps)
    each_us = (tk - t1) * 1e3 / iters
    log(f"l2copy[{name}]: {info['blocks']} blocks x {per_block} B "
        f"({info['rows']} rows x {info['row_elems']}) in {each_us:.3f} us "
        f"= {info['blocks'] * per_block / each_us / 1e6:.3f} TB/s out of L2 "
        f"into shared memory; first copy and launch {t1 * 1e3:.2f} us")


# linear attention: branch rows (BEAT B 1, SHOW classifier-free B 2,
# latent 512, 8 heads), the cache's audio encoder (25 levels x 30 windows
# of a 60 s stream, width 128, 8 heads; cli generate's 4 speaker styles of
# it, a 10 s stream of 5 windows and SHOW's 10 s of 4 windows of 88
# frames), a 12-frame live window and 512 frames, past what a block can
# stage whole
# (name, dtype, B, T, D, offset): 8 heads; the last two take the kernels
# that are not specialised to a shape, at hd 32 and with inputs one
# element past an aligned address (no 16-byte loads: single columns)
ATTENTION_CASES = (("beat-f32", torch.float32, 1, 34, 512, 0),
                   ("beat-bf16", torch.bfloat16, 1, 34, 512, 0),
                   ("show-cfg-f32", torch.float32, 2, 88, 512, 0),
                   ("audio-enc-f32", torch.float32, 750, 34, 128, 0),
                   ("audio-enc-b1-f32", torch.float32, 1, 34, 128, 0),
                   ("audio-enc-4spk-f32", torch.float32, 3000, 34, 128, 0),
                   ("audio-enc-10s-f32", torch.float32, 125, 34, 128, 0),
                   ("show-audio-enc-f32", torch.float32, 100, 88, 128, 0),
                   ("live-t12-f32", torch.float32, 1, 12, 512, 0),
                   ("long-t512-f32", torch.float32, 1, 512, 512, 0),
                   ("train-beat-f32", torch.float32, 2500, 34, 512, 0),
                   ("train-audio-enc-f32", torch.float32, 2500, 34, 128, 0),
                   ("eval-audio-enc-f32", torch.float32, 1600, 34, 128, 0),
                   # phase 11: cli train's one step on the 696 windows of
                   # the built cache, cli eval's level cache (25 x 32
                   # rows), cli test-stream's (a window's 25 levels)
                   ("data-train-beat-f32", torch.float32, 696, 34, 512, 0),
                   ("data-train-audio-enc-f32", torch.float32, 696, 34, 128,
                    0),
                   ("data-eval-audio-enc-f32", torch.float32, 800, 34, 128,
                    0),
                   ("stream-audio-enc-f32", torch.float32, 25, 34, 128, 0),
                   # phase 12: cli train with the speech frontend at batch
                   # 256, and each of 2 data-parallel processes' 128 rows
                   ("scale-train-beat-f32", torch.float32, 256, 34, 512, 0),
                   ("scale-train-audio-enc-f32", torch.float32, 256, 34, 128,
                    0),
                   ("scale-dp-beat-f32", torch.float32, 128, 34, 512, 0),
                   ("scale-dp-audio-enc-f32", torch.float32, 128, 34, 128,
                    0),
                   ("hd32-f32", torch.float32, 2, 34, 256, 0),
                   ("unaligned-f32", torch.float32, 1, 34, 512, 1),
                   # heads 144 wide (L 1152): a BEAT window, and a
                   # classifier-free pair of 352-frame windows (tiled)
                   ("hd144-f32", torch.float32, 1, 34, 1152, 0),
                   ("hd144-cfg-t352-f32", torch.float32, 2, 352, 1152, 0))
# one head wider than a block's 512 threads (the wide kernels): 1024 wide
# at a BEAT window (tiled) and a 12-frame one (staged), through an
# unaligned input too, and 1040 wide at a classifier-free pair of 88-frame
# windows in f32 and bf16; phase 4's one-head model runs (1, 34, 1024).
# (name, dtype, B, T, D, offset): one head
WIDE_ATTENTION_CASES = (
    ("hd1024-f32", torch.float32, 1, 34, 1024, 0),
    ("hd1024-t12-f32", torch.float32, 1, 12, 1024, 0),
    ("hd1024-unaligned-f32", torch.float32, 1, 34, 1024, 1),
    ("hd1040-cfg-t88-f32", torch.float32, 2, 88, 1040, 0),
    ("hd1040-cfg-t88-bf16", torch.bfloat16, 2, 88, 1040, 0))


def attention_inputs(dtype, B, T, D, dev, seed, offset=0):
    """Seeded q, k, v with the last eighth of the keys masked, as padded
    frames get; each starts ``offset`` elements into its own buffer."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, T, D, generator=gen) for _ in range(3))
    mask = torch.ones(B, T, 1)
    mask[:, T - T // 8:] = 0.0
    k, v = k + (1.0 - mask) * -1e6, v * mask
    out = []
    for a in (q, k, v):
        buf = torch.empty(offset + a.numel(), device=dev, dtype=dtype)
        out.append(buf[offset:].view(B, T, D).copy_(a))
    return tuple(out)


def cross_attention_inputs(B, T, D, C, dev, seed):
    """The decoder's cross-attention operands: q from a LayerNormed latent,
    k and v from a LayerNormed (B, T, C) condition, through seeded
    projections; nothing masked."""
    gen = torch.Generator().manual_seed(seed)
    ln = torch.nn.functional.layer_norm
    x = ln(torch.randn(B, T, D, generator=gen), (D,))
    cond = ln(torch.randn(B, T, C, generator=gen), (C,))
    wq = torch.randn(D, D, generator=gen) / D ** 0.5
    wk, wv = (torch.randn(C, D, generator=gen) / C ** 0.5 for _ in range(2))
    return tuple(a.contiguous().to(dev)
                 for a in (x @ wq, cond @ wk, cond @ wv))


def attention_case(name, dtype, B, T, D, offset, H, dev, seed, reps,
                   qkv=None):
    """The linear-attention kernel against its plain version.  The
    gradient check only shows that backward runs on the card behind the
    kernel's forward: the backward recomputes through the plain
    composition from the saved inputs, so it matches plain autograd by
    construction (the VJP itself is held against jax.grad on the CPU).
    In bf16 the composition the dispatch runs for bf16 is timed too."""
    from diffsheg_tpu_torch.ops.linear_attention import (
        _launch_plan, fused_linear_attention, fused_linear_attention_reference,
        linear_attention_reference)
    q, k, v = qkv or attention_inputs(dtype, B, T, D, dev, seed, offset)
    gen = torch.Generator().manual_seed(seed + 1)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    got = fused_linear_attention(q, k, v, H)
    ref = fused_linear_attention_reference(q, k, v, H)
    torch.cuda.synchronize()
    err, e_abs = rel_rms(got, ref), float((got.float() - ref.float()).abs().max())

    g = torch.randn(B, T, D, generator=gen).to(dev, dtype)
    kq, kk, kv = (a.clone().requires_grad_() for a in (q, k, v))
    fused_linear_attention(kq, kk, kv, H).backward(g)
    pq, pk, pv = (a.clone().requires_grad_() for a in (q, k, v))
    linear_attention_reference(pq, pk, pv, H).backward(g)
    g_err = max(rel_rms(a.grad, b.grad) for a, b in
                ((kq, pq), (kk, pk), (kv, pv)))

    def kernel():
        fused_linear_attention(q, k, v, H)

    def plain():
        fused_linear_attention_reference(q, k, v, H)

    ms, wall = device_ms(kernel, reps), wall_ms(kernel, reps)
    plain_ms = device_ms(plain, reps)
    comp = ""
    if dtype == torch.bfloat16:
        comp_ms = device_ms(lambda: linear_attention_reference(q, k, v, H),
                            reps)
        comp = f" bf16_composition_ms={comp_ms:.4f}"
    nbytes = 4 * B * T * D * q.element_size()
    flops = 4 * B * T * D * (D // H)            # both contractions, f32
    b_ms, b_by = bound(nbytes, flops, torch.float32)
    plan = _launch_plan(B, T, D, H, vec=not offset)
    log(f"kernel[fused_linear_attention {name}]: rel_rms={err:.3e} "
        f"(tol {tol:g}) max_abs={e_abs:.3e} grad_rel_rms={g_err:.3e} "
        f"ms={ms:.4f} wall_ms={wall:.4f} plain_ms={plain_ms:.4f}{comp} "
        f"bound_ms={b_ms:.5f} ({b_by}) plan={plan.mode} grid={plan.grid} "
        f"heads={plan.heads} splits={plan.splits} threads={plan.threads} "
        f"tile_rows={plan.tile_rows} vec={plan.vec} smem={plan.smem_bytes}")
    if not (err <= tol and g_err <= tol):
        raise AssertionError(f"fused_linear_attention {name}: {err:.3e}, "
                             f"grad {g_err:.3e} > {tol:g}")
    return dict(rel_rms=err, max_abs_err=e_abs, ms=ms, wall_ms=wall,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


# The dense layers' products in one BEAT training step at batch 2500 with
# remat, by (M, N, K, layout) as gemm_tf32x3 takes them: every Dense at
# 85 000 rows (forward NT, the layers inside remat's recomputed blocks
# twice; dX NN, not for an input that takes no gradient; dW TN) and the
# per-window products at 2500 rows; widths off a multiple of 4 zero-padded
# (the 51- and 141-channel heads to 52 and 144, the gesture branch's
# 947-wide condition to 948).  The route's rule (train_gemm) leaves the
# 32 -> 2048 timestep products to cuBLAS.
TRAIN_ROWS = 85000
TRAIN_GEMM = {
    (2500, 2048, 512, "nt"): 3, (2500, 2048, 2048, "nt"): 5,
    (85000, 128, 128, "nt"): 5, (2500, 256, 2048, "nt"): 2,
    (85000, 1024, 128, "nt"): 1, (85000, 128, 1024, "nt"): 1,
    (2500, 2048, 32, "nt"): 2, (85000, 512, 52, "nt"): 1,
    (85000, 256, 256, "nt"): 2, (85000, 1024, 896, "nt"): 16,
    (85000, 512, 1024, "nt"): 64, (85000, 512, 512, "nt"): 160,
    (2500, 1024, 2048, "nt"): 64, (85000, 1024, 512, "nt"): 32,
    (85000, 52, 512, "nt"): 1, (85000, 512, 144, "nt"): 1,
    (85000, 1024, 948, "nt"): 16, (85000, 144, 512, "nt"): 1,
    (85000, 512, 144, "nn"): 1, (85000, 512, 512, "nn"): 80,
    (2500, 2048, 1024, "nn"): 32, (85000, 1024, 512, "nn"): 32,
    (85000, 512, 1024, "nn"): 16, (85000, 948, 1024, "nn"): 8,
    (85000, 256, 256, "nn"): 2, (2500, 2048, 2048, "nn"): 5,
    (85000, 512, 52, "nn"): 1, (85000, 896, 1024, "nn"): 8,
    (85000, 128, 128, "nn"): 5, (2500, 2048, 256, "nn"): 2,
    (85000, 1024, 128, "nn"): 1, (85000, 128, 1024, "nn"): 1,
    (144, 512, 85000, "tn"): 1, (512, 512, 85000, "tn"): 80,
    (1024, 2048, 2500, "tn"): 32, (512, 1024, 85000, "tn"): 32,
    (1024, 512, 85000, "tn"): 16, (1024, 948, 85000, "tn"): 8,
    (256, 256, 85000, "tn"): 2, (512, 144, 85000, "tn"): 1,
    (2048, 2048, 2500, "tn"): 5, (2048, 32, 2500, "tn"): 2,
    (2048, 512, 2500, "tn"): 3, (52, 512, 85000, "tn"): 1,
    (1024, 896, 85000, "tn"): 8, (512, 52, 85000, "tn"): 1,
    (128, 128, 85000, "tn"): 5, (256, 2048, 2500, "tn"): 2,
    (128, 1024, 85000, "tn"): 1, (1024, 128, 85000, "tn"): 1}
# ... of which these are timed: a BEAT layer's dense widths (in, out) at
# 85 000 rows, q / k / v / outputs, FFN in and out, the condition
# projection's first layer, in each layout
GEMM_WIDTHS = ((512, 512), (512, 1024), (1024, 512), (896, 1024))
GEMM_TIMED = {s for kin, nout in GEMM_WIDTHS for s in (
    (TRAIN_ROWS, nout, kin, "nt"), (TRAIN_ROWS, kin, nout, "nn"),
    (nout, kin, TRAIN_ROWS, "tn"))}


def gemm_rows(M, N, K, layout):
    """The rows of the dense layer a product belongs to: its forward's and
    dX's M, dW's contraction."""
    return K if layout == "tn" else M


def gemm_widths(M, N, K, layout):
    """(in, out) of the dense layer a product belongs to."""
    return {"nt": (K, N), "nn": (N, K), "tn": (N, M)}[layout]


# TRAIN_GEMM's forward products (N, K) that remat runs twice: the
# branches' transformer layers at 85 000 rows and their style projections
# (2048 -> 1024) at 2500
REMAT_NT = {(512, 512), (512, 1024), (1024, 512), (1024, 896), (1024, 948),
            (1024, 2048)}


def train_gemm(windows: int, steps: int = 1, remat: bool = True) -> dict:
    """gemm_tf32x3's launches in ``steps`` BEAT training steps of
    ``windows`` windows: TRAIN_GEMM's products at 34 rows a window (or one
    a window) where the route takes them at those rows; without remat the
    forward of REMAT_NT once."""
    from diffsheg_tpu_torch.ops.products import takes_tf32x3
    out = collections.Counter()
    for (M, N, K, lay), n in TRAIN_GEMM.items():
        rows = (windows * 34 if gemm_rows(M, N, K, lay) == TRAIN_ROWS
                else windows)
        if not takes_tf32x3("cuda", torch.float32, rows,
                            *gemm_widths(M, N, K, lay)):
            continue
        if lay == "nt" and not remat and (N, K) in REMAT_NT:
            n //= 2
        if lay == "tn":
            K = rows
        else:
            M = rows
        out[(M, N, K, lay)] += n * steps
    return dict(out)


def cache_gemm(model, windows: int, frames: int, styles: int = 1,
               levels: int = 25) -> dict:
    """gemm_tf32x3's launches of one f32 level cache of ``windows`` windows
    of ``frames`` and ``styles`` style rows, forward only, where the route
    takes them: the audio encoder's dense layers and each branch's audio
    projection over levels x windows x frames rows, the encoder's style
    projections over levels x windows, the branch layers' style
    projections (the static cache) over levels x styles."""
    from diffsheg_tpu_torch.ops.products import Dense, takes_tf32x3
    branches = (model.encoder_exp, model.encoder_ges)
    layers = [(m, levels * windows * (1 if name.endswith("emb_proj")
                                      else frames))
              for name, m in model.encoder_aud.named_modules()
              if isinstance(m, Dense)]
    layers += [(b.audio_proj, levels * windows * frames) for b in branches]
    layers += [(block.proj_out.emb_proj, levels * styles)
               for b in branches for layer in b.layers
               for block in (layer.sa_block, layer.ffn)]
    out = collections.Counter()
    for m, rows in layers:
        if takes_tf32x3("cuda", torch.float32, rows, m.in_features,
                        m.out_features):
            out[(rows, -(-m.out_features // 4) * 4,
                 -(-m.in_features // 4) * 4, "nt")] += 1
    return dict(out)


def times(gemm: dict, n: int) -> dict:
    """Launches by shape, ``n`` times over."""
    return {k: v * n for k, v in gemm.items()}


def plus(*gemms: dict) -> dict:
    """Launches by shape of several parts together."""
    out = collections.Counter()
    for g in gemms:
        out.update(g)
    return dict(out)


# one BEAT window of 16 kHz speech (34 frames at 15 fps) and the speech
# encoder's frames of it
BEAT_WINDOW_SAMPLES = 36266
BEAT_WINDOW_FRAMES = (BEAT_WINDOW_SAMPLES - 400) // 320 + 1     # 113


def encoder_gemm(rows: int, calls: int = 1, enc: str = "hubert-large") -> dict:
    """gemm_tf32x3's launches of ``calls`` f32 forwards of a speech encoder
    (``models/hubert.py``, by name) over ``rows`` frames each, where the
    route takes them: the feature projection and each layer's q, k, v,
    out, fc1 and fc2 at ``rows``, WavLM's gate at rows x heads."""
    from diffsheg_tpu_torch.models.hubert import speech_encoder_config
    from diffsheg_tpu_torch.ops.products import takes_tf32x3
    c = speech_encoder_config(enc)
    H, F = c.hidden_size, c.intermediate_size
    layer = [(rows, H, H)] * 4 + [(rows, H, F), (rows, F, H)]
    if c.rel_pos_buckets:
        layer.append((rows * c.num_heads, H // c.num_heads, 8))
    out = collections.Counter()
    for r, kin, nout in [(rows, c.conv_dim[-1], H)] + layer * c.num_layers:
        if takes_tf32x3("cuda", torch.float32, r, kin, nout):
            out[(r, -(-nout // 4) * 4, -(-kin // 4) * 4, "nt")] += calls
    return dict(out)


def frontend_gemm(windows: int, calls: int = 1,
                  enc: str = "hubert-large") -> dict:
    """... of ``calls`` f32 training frontends (``audio/frontend.py``) of
    ``windows`` BEAT windows with the speech encoder ``enc``: the encoder
    in chunks of HUBERT_CHUNK windows, the last chunk the rest."""
    from diffsheg_tpu_torch.audio.frontend import HUBERT_CHUNK
    full, rest = divmod(windows, HUBERT_CHUNK)
    return plus(
        encoder_gemm(HUBERT_CHUNK * BEAT_WINDOW_FRAMES, full * calls, enc)
        if full else {},
        encoder_gemm(rest * BEAT_WINDOW_FRAMES, calls, enc) if rest else {})


def extractor_gemm(samples: int, calls: int = 1) -> dict:
    """... of ``calls`` f32 HuBERT-large extractions
    (``audio/hubert_runner.py``) of ``samples`` of 16 kHz audio: its
    chunks of CLIP_FRAMES frames in one batch (a 60 s clip 3000 rows, a
    10 s clip 1000)."""
    from diffsheg_tpu_torch.audio.hubert_runner import (CLIP_FRAMES,
                                                        CLIP_SAMPLES, KERNEL)
    chunks = samples // CLIP_SAMPLES + (samples % CLIP_SAMPLES >= KERNEL)
    return encoder_gemm(chunks * CLIP_FRAMES, calls)


@functools.lru_cache(maxsize=None)
def beat_structure():
    """A BEAT model at the published widths on the CPU: the shapes of the
    dense layers that a command builds for itself."""
    from diffsheg_tpu_torch.config import beat_config
    from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
    return init_unidiffuser(beat_config().model, seed=0)


def gemm_case(M, N, K, layout, dev, seed, reps):
    """``gemm_tf32x3`` at one (M, N, K, layout) of TRAIN_GEMM or of the
    speech encoder's (``encoder_gemm``) against its plain version (the port's f32 band, 1e-5) and against an f64 product,
    beside cuBLAS f32's and single-pass TF32's errors against the same f64:
    the kernel's at most 8x cuBLAS f32's and 100x under TF32's, two calls
    bit for bit the same.  'nt' adds a bias, as the forward does.  With
    ``reps``, also its device ms beside the operations bound (three TF32
    products) and cuBLAS f32 (``library_ms``, TF32 off)."""
    from diffsheg_tpu_torch.ops.products import (gemm_tf32x3,
                                                 gemm_tf32x3_reference)
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((M, K) if layout[0] == "n" else (K, M), generator=gen,
                    device=dev)
    b = torch.randn((N, K) if layout[1] == "t" else (K, N), generator=gen,
                    device=dev) / K ** 0.5
    bias = (torch.randn(N, generator=gen, device=dev) if layout == "nt"
            else None)
    A = a if layout[0] == "n" else a.t()
    B = b.t() if layout[1] == "t" else b

    def library():
        out = A @ B
        return out if bias is None else out + bias

    got = gemm_tf32x3(a, b, layout, bias)
    same = torch.equal(got, gemm_tf32x3(a, b, layout, bias))
    e_plain = rel_rms(got, gemm_tf32x3_reference(a, b, layout, bias))
    exact = A.double() @ B.double()
    if bias is not None:
        exact += bias.double()
    err, e_lib = rel_rms(got, exact), rel_rms(library(), exact)
    torch.backends.cuda.matmul.allow_tf32 = True
    e_tf32 = rel_rms(library(), exact)
    no_tf32()
    del exact, got
    res = dict(rel_rms=err, library_rel_rms=e_lib, tf32_rel_rms=e_tf32,
               plain_rel_rms=e_plain)
    line = (f"kernel[gemm_tf32x3 {layout} (M, N, K)=({M}, {N}, {K})]: "
            f"rel_rms_f64={err:.3e} cublas_f32_rel_rms_f64={e_lib:.3e} "
            f"tf32_rel_rms_f64={e_tf32:.3e} rel_rms_plain={e_plain:.3e} "
            f"bit_identical={same}")
    if reps:
        flops = 2.0 * M * N * K
        res.update(ms=device_ms(lambda: gemm_tf32x3(a, b, layout, bias),
                                reps),
                   bound_ms=3 * flops / TF32_FLOPS * 1e3,
                   library_ms=device_ms(library, reps))
        line += (f" ms={res['ms']:.4f} tflops={flops / res['ms'] / 1e9:.1f}"
                 f" bound_ms={res['bound_ms']:.4f} (operations) "
                 f"library_ms={res['library_ms']:.4f}")
    log(line)
    if not (same and err <= 8 * e_lib and 100 * err <= e_tf32
            and e_plain <= 1e-5):
        raise AssertionError(
            f"gemm_tf32x3 {layout} {(M, N, K)}: {err:.3e} against f64, "
            f"cuBLAS f32 {e_lib:.3e}, TF32 {e_tf32:.3e}, plain "
            f"{e_plain:.3e}, bit-identical {same}")
    return res


def gemm_cases(dev, reps):
    """gemm_case at every shape of TRAIN_GEMM, the cell's widths timed;
    then, timed, at the speech encoder's forward products in a chunk of
    the training frontend (HUBERT_CHUNK windows, 7232 rows: the feature
    projection, q / k / v / out, fc1, fc2)."""
    from diffsheg_tpu_torch.audio.frontend import HUBERT_CHUNK
    shapes = [(s, reps if s in GEMM_TIMED else 0) for s in sorted(TRAIN_GEMM)]
    shapes += [(s, reps) for s in sorted(
        encoder_gemm(HUBERT_CHUNK * BEAT_WINDOW_FRAMES))]
    return {f"gemm-{lay}-{M}x{N}x{K}": gemm_case(M, N, K, lay, dev, 22 + i,
                                                 timed)
            for i, ((M, N, K, lay), timed) in enumerate(shapes)}


# the crossover's rows, around and above MIN_ROWS (2550: the three-window
# stream's f32 level cache)
CROSSOVER_ROWS = (512, 1024, 2048, 2550, 4096, 8192, 16384)
# the speech encoder's (in, out), forward only (the encoder is frozen), at
# a 20 s extraction chunk's rows and a training frontend chunk's (64
# windows)
ENCODER_WIDTHS = ((512, 1024), (1024, 1024), (1024, 4096), (4096, 1024))
ENCODER_ROWS = (1000, 64 * BEAT_WINDOW_FRAMES)


def phase_crossover(dev, reps):
    """Device ms of a dense layer's products through gemm_tf32x3 and
    through cuBLAS f32 by rows, at every (in, out) of TRAIN_GEMM: the
    forward alone (inference, a level cache) and forward, dX and dW
    together (training); then the speech encoder's forward at
    ENCODER_WIDTHS x ENCODER_ROWS.  ``ops/products.py::takes_tf32x3`` is
    set from these lines; they are not part of a whole run."""
    from diffsheg_tpu_torch.ops.products import gemm_tf32x3
    no_tf32()
    widths = sorted({gemm_widths(*s) for s in TRAIN_GEMM})
    for kin, nout in widths:
        line = []
        for rows in CROSSOVER_ROWS:
            x = torch.randn(rows, kin, device=dev)
            w = torch.randn(nout, kin, device=dev)
            b = torch.randn(nout, device=dev)
            dy = torch.randn(rows, nout, device=dev)
            fwd = (device_ms(lambda: gemm_tf32x3(x, w, "nt", b), reps),
                   device_ms(lambda: torch.addmm(b, x, w.t()), reps))

            def kernel():
                gemm_tf32x3(x, w, "nt", b)
                gemm_tf32x3(dy, w, "nn")
                gemm_tf32x3(dy, x, "tn")

            def library():
                torch.addmm(b, x, w.t())
                dy @ w
                dy.t() @ x

            line.append(f"{rows}:{fwd[0]:.4f}/{fwd[1]:.4f},"
                        f"{device_ms(kernel, reps):.4f}/"
                        f"{device_ms(library, reps):.4f}")
        log(f"gemm_tf32x3 crossover {kin}->{nout} rows:forward kernel_ms/"
            f"library_ms,all three kernel_ms/library_ms {' '.join(line)}")
    for kin, nout in ENCODER_WIDTHS:
        line = []
        for rows in ENCODER_ROWS:
            x = torch.randn(rows, kin, device=dev)
            w = torch.randn(nout, kin, device=dev)
            b = torch.randn(nout, device=dev)
            line.append(
                f"{rows}:"
                f"{device_ms(lambda: gemm_tf32x3(x, w, 'nt', b), reps):.4f}/"
                f"{device_ms(lambda: torch.addmm(b, x, w.t()), reps):.4f}")
        log(f"gemm_tf32x3 crossover encoder {kin}->{nout} rows:forward "
            f"kernel_ms/library_ms {' '.join(line)}")


# the step kernel: BEAT (1, 34, 192), overlap 4; SHOW (1, 88, 232), 10;
# and the gesture-only model's (1, 34, 141), 4
STEP_CASES = (("beat", 1, 34, 192, 4, 12), ("show", 1, 88, 232, 10, 13),
              ("beat-ges", 1, 34, 141, 4, 14))


def step_inputs(B, T, C, ov, dev, seed):
    """Every switch: no GT; GT with no tail, a valid and an invalid saved
    tail, the blend on and off, at a high-noise and a low-noise (blending)
    level.  Returns (each combination's arguments, the timed call's: low
    level, valid tail, blend)."""
    from diffsheg_tpu_torch.diffusion.respace import (make_respaced_schedule,
                                                      space_timesteps)
    from diffsheg_tpu_torch.diffusion.schedule import get_named_beta_schedule
    gen = torch.Generator().manual_seed(seed)
    x, eps, gt, gtn = (torch.randn(B, T, C, generator=gen).to(dev)
                       for _ in range(4))
    tail = torch.randn(B, ov, C, generator=gen).to(dev)
    sched, _ = make_respaced_schedule(get_named_beta_schedule("linear", 1000),
                                      space_timesteps(1000, "ddim25"))
    # DDIM-25 levels 24 (sqrt(1 - ab_prev) ~ 1) and 1 (~ 0.01: blends)
    levels = {lv: (sched.alphas_cumprod_prev[t],
                   sched.sqrt_recip_alphas_cumprod[t],
                   sched.sqrt_recipm1_alphas_cumprod[t])
              for lv, t in (("high", 24), ("low", 1))}
    combos = [(x, eps, (*levels["high"], 0.0), None, None, None, ov, False)]
    for lv in levels:
        for t_, valid in ((None, 0.0), (tail, 1.0), (tail, 0.0)):
            for blend in (False, True):
                combos.append((x, eps, (*levels[lv], valid), gt, gtn, t_, ov,
                               blend))
    return combos, (x, eps, (*levels["low"], 1.0), gt, gtn, tail, ov, True)


def step_case(name, B, T, C, ov, dev, seed, reps):
    """The step kernel against its plain version at every switch, and a
    kernel that does nothing launched with the same shape (the floor)."""
    from diffsheg_tpu_torch.ops.step_math import (
        _step_plan, ddim_repaint_step_reference, empty_launch,
        fused_ddim_repaint_step)
    combos, main = step_inputs(B, T, C, ov, dev, seed)
    worst = 0.0
    for args in combos:
        got = fused_ddim_repaint_step(*args)
        ref = ddim_repaint_step_reference(*args)
        worst = max(worst, float((got - ref).abs().max()))
    torch.cuda.synchronize()

    def kernel():
        fused_ddim_repaint_step(*main)

    def plain():
        ddim_repaint_step_reference(*main)

    plan = _step_plan(B, T, C)
    ms, wall = device_ms(kernel, reps), wall_ms(kernel, reps)
    floor_ms = device_ms(lambda: empty_launch(plan, dev), reps)
    plain_ms = device_ms(plain, reps)
    # the timed call reads x, eps and the valid tail and writes out; it
    # never reads gt or its noise (the tail takes the head's place)
    nbytes = 4 * (3 * B * T * C + B * ov * C)
    flops = 9 * B * T * C
    b_ms, b_by = bound(nbytes, flops, torch.float32)
    log(f"kernel[fused_ddim_repaint_step {name}]: {len(combos)} switch "
        f"combinations max_abs={worst:.3e} (tol 1e-6) ms={ms:.4f} "
        f"wall_ms={wall:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.7f} "
        f"({b_by}) empty_launch_ms={floor_ms:.4f} (grid {plan.grid_x} x "
        f"{plan.grid_y} x {plan.threads}, vec={plan.vec})")
    if not worst <= 1e-6:
        raise AssertionError(f"fused_ddim_repaint_step {name}: {worst:.3e}")
    return dict(max_abs_err=worst, ms=ms, wall_ms=wall, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, floor_ms=floor_ms)


def quant_kernel_cases(dev, reps):
    """The quantized variants: int8 and int4 at the BEAT gesture branch in
    bf16 and f32, and at the SHOW classifier-free shape in bf16."""
    no_tf32()
    results = {}
    for quant in QUANT_BITS:
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            name = f"beat-ges-{tag}-{quant}"
            results[name] = kernel_case(name, dtype, 1, 34, 1024, 947, False,
                                        dev, 2, reps, quant)
        name = f"show-cfg-bf16-{quant}"
        results[name] = kernel_case(name, torch.bfloat16, 2, 88, 1024, 999,
                                    True, dev, 3, reps, quant)
        # the raw-HuBERT gesture branch, f32 in K passes
        name = f"raw-ges-f32-{quant}"
        results[name] = wide_case(name, torch.float32, 1, 34, 1920, 1843,
                                  1024, 8, 2, dev, 19, reps, quant)
    return results


# the speech encoders beside each other (models/hubert.py): a chunk of the
# training frontend (HUBERT_CHUNK 64 BEAT windows of 36 266 samples, f32,
# audio/frontend.py) and one chunk of a stream (320 080 samples, 1000
# frames, bf16 as the stream cells run it, audio/hubert_runner.py)
SPEECH_ENCODER_CASES = (
    ("chunk64-f32", 64, BEAT_WINDOW_SAMPLES, torch.float32),
    ("stream1000-bf16", 1, 320080, torch.bfloat16))
SPEECH_ENCODER_REPS = 3
# the f32 chunk against the same encoder with every product on F.linear
# (cuBLAS f32, TF32 off): rel-RMS
SPEECH_ENCODER_TOL = 1e-5
# one batch of the frontend training cell (beat-wavlm-train-fe-f32)
FRONTEND_STEP_WINDOWS = 2500


def library_products(call):
    """``call()`` with every ``Dense`` on ``F.linear`` (the route refuses
    every product), in this process only."""
    import diffsheg_tpu_torch.ops.products as products
    saved = products.takes_tf32x3
    products.takes_tf32x3 = lambda *shape: False
    try:
        return call()
    finally:
        products.takes_tf32x3 = saved


def frontend_step(model, enc, dev, gen):
    """The f32 training frontend (``audio/frontend.py``) with ``model`` over
    one batch of the frontend training cell, FRONTEND_STEP_WINDOWS windows
    of seeded int16 speech: gemm_tf32x3's launches by shape exactly
    (``frontend_gemm``: 39 chunks of 145 NT products at 7232 rows, none in
    the tail chunk of 4 windows).  Its time is the cell's
    (``speech_encoder_ms.train``)."""
    from diffsheg_tpu_torch.audio.frontend import make_speech_frontend
    from diffsheg_tpu_torch.config import beat_config
    from diffsheg_tpu_torch.ops.products import gemm_tf32x3
    W = FRONTEND_STEP_WINDOWS
    fe = make_speech_frontend(beat_config(), model, device=dev)
    batch = {"wave16": torch.randint(-8192, 8192, (W, BEAT_WINDOW_SAMPLES),
                                     generator=gen, device=dev,
                                     dtype=torch.int16),
             "motion": torch.zeros(W, 34, 1, device=dev)}
    gemm_tf32x3.launches_by_shape.clear()
    out = fe(batch)["hubert"]
    gemm, want = (dict(gemm_tf32x3.launches_by_shape),
                  frontend_gemm(W, enc=enc))
    log(f"kernel[speech-encoder {enc} frontend {W} windows] "
        f"gemm_tf32x3 {sum(gemm.values())} launches: {gemm}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"frontend {enc} {W} windows: not finite")
    if gemm != want:
        raise AssertionError(f"frontend {enc} {W} windows: gemm_tf32x3 by "
                             f"(M, N, K, layout) {gemm}, expected {want}")


def speech_encoder_cases(dev, reps):
    """HuBERT-large and WavLM-Large (gated relative-position attention) on
    seeded weights made on the card, each case's median device ms; the
    attention calls by kind; gemm_tf32x3's launches by shape exactly (the
    f32 chunk's 145 products a call, none in bf16); the f32 chunk against
    the encoder on ``F.linear`` (SPEECH_ENCODER_TOL); WavLM-Large in the
    training frontend over a batch of the frontend cell (frontend_step);
    the seconds the cases add to the smoke."""
    from diffsheg_tpu_torch.models.hubert import (HubertModel,
                                                  attention_calls,
                                                  speech_encoder_config)
    from diffsheg_tpu_torch.ops.products import gemm_tf32x3
    no_tf32()
    t_all = time.perf_counter()
    reps = min(reps, SPEECH_ENCODER_REPS)
    gen = torch.Generator(device=dev).manual_seed(23)
    results = {}
    for enc in ("hubert-large", "wavlm-large"):
        with torch.device("meta"):
            model = HubertModel(speech_encoder_config(enc))
        model = model.to_empty(device=dev).eval()
        with torch.no_grad():
            for n, p in model.named_parameters():
                scale = p[0].numel() ** -0.5 if p.dim() >= 2 else 0.02
                unit = 1.0 if p.dim() == 1 and n.endswith("weight") else 0.0
                p.copy_(unit + scale * torch.randn(
                    p.shape, generator=gen, device=dev))
        for name, B, S, dtype in SPEECH_ENCODER_CASES:
            model = model.to(dtype)
            x = torch.randn((B, S), generator=gen, device=dev)
            before = dict(attention_calls)
            gemm_tf32x3.launches_by_shape.clear()
            with torch.no_grad():
                ms = device_ms(lambda: model(x), reps)
                out = model(x)
            calls = 3 + reps        # device_ms's 2 + reps, then one more
            kinds = {k: v - before.get(k, 0) for k, v in attention_calls.items()
                     if v != before.get(k, 0)}
            gemm = dict(gemm_tf32x3.launches_by_shape)
            want = (encoder_gemm(B * out.shape[1], calls, enc)
                    if dtype == torch.float32 else {})
            if not torch.isfinite(out).all():
                raise AssertionError(f"speech encoder {enc} {name}: not finite")
            if gemm != want:
                raise AssertionError(f"speech encoder {enc} {name}: "
                                     f"gemm_tf32x3 by (M, N, K, layout) "
                                     f"{gemm}, expected {want}")
            err = ""
            if dtype == torch.float32:
                with torch.no_grad():
                    lib = library_products(lambda: model(x))
                e_lib = rel_rms(out, lib)
                err = (f" rel_rms_library={e_lib:.3e} "
                       f"(tol {SPEECH_ENCODER_TOL:g})")
                del lib
                if not e_lib <= SPEECH_ENCODER_TOL:
                    raise AssertionError(f"speech encoder {enc} {name}: "
                                         f"{e_lib:.3e} against F.linear")
            results[f"speech-{enc}-{name}"] = ms
            log(f"kernel[speech-encoder {enc} {name}] B={B} samples={S} "
                f"frames={out.shape[1]} ms={ms:.3f}{err} attention calls "
                f"{kinds} gemm_tf32x3 a call "
                f"{ {k: v // calls for k, v in gemm.items()} } ({calls} "
                f"calls)")
        if enc == "wavlm-large":
            frontend_step(model, enc, dev, gen)
        del model
        torch.cuda.empty_cache()
    for name, *_ in SPEECH_ENCODER_CASES:
        log(f"kernel[speech-encoder {name}] wavlm-large / hubert-large = "
            f"{results[f'speech-wavlm-large-{name}'] / results[f'speech-hubert-large-{name}']:.3f}")
    log(f"speech-encoder cases: {time.perf_counter() - t_all:.1f} s")
    return results


def phase_kernels(dev, reps):
    """Each kernel against its plain PyTorch version on the card, f32
    within 1e-5 and bf16 within 8e-3 rel-RMS (the step kernel 1e-6 abs),
    with its device ms (``device_ms``), host ms a launch, the plain
    version's ms and the bound from bytes or operations at the H100's
    peaks: what PERF.md's kernel table is built from.

    - Linear attention (``ATTENTION_CASES``, ``WIDE_ATTENTION_CASES``):
      the main paths' shapes (branch rows, the level caches' audio
      encoders, training, evaluation, the data and scale phases' rows),
      the decoder's cross-attention, the general kernels (hd 32, an
      unaligned input), heads 144 wide, one head wider than a block's
      threads; the gradient behind the kernel's forward; each line with
      its launch plan.
    - The DDIM + RePaint step (``STEP_CASES``) at every switch, beside an
      empty launch of its shape.
    - The fused-layer kernels: BEAT's branches and SHOW's classifier-free
      shape with null rows in bf16 and f32 (``kernel_case``), the
      per-layer kernel at the live, cli generate and evaluation shapes
      (``LIVE_LAYER_CASES``), widths in K passes (``WIDE_CASES``),
      windows and heads past the one-tile attention (``LONG_CASES``),
      widths off a multiple of 16 on the ragged build (``ODD_CASES``),
      each line with its plan's passes, tc, dg and cg and failing on
      another plan; int8 / int4 codes (``quant_kernel_cases``); the
      examples' shapes (``example_kernel_cases``).  At the BEAT gesture
      branch also where a layer's time goes (``phases[...]``,
      ``subphases[...]``: traced launches), the floor its grid barriers
      set (``barrier[...]``) and its operand copy's rate out of L2
      (``l2copy[...]``).
    - ``gemm_tf32x3`` at every shape of a BEAT training step and of the
      speech encoder's training chunk (``gemm_cases``).
    - HuBERT-large beside WavLM-Large (``speech_encoder_cases``).

    ``--only crossover`` (``phase_crossover``) is in no whole run."""
    no_tf32()
    results = {}
    for name, dt, B, T, D, offset in ATTENTION_CASES:
        results[f"attn-{name}"] = attention_case(name, dt, B, T, D, offset, 8,
                                                 dev, 11, reps)
    # the decoder's cross-attention over the gesture branch's condition
    # (audio latent 256 + HuBERT 128 + expression 51)
    for name, dt, B, T, D, offset in WIDE_ATTENTION_CASES:
        results[f"attn-{name}"] = attention_case(name, dt, B, T, D, offset, 1,
                                                 dev, 11, reps)
    results["attn-cross-beat-f32"] = attention_case(
        "cross-beat-f32", torch.float32, 1, 34, 512, 0, 8, dev, 11, reps,
        qkv=cross_attention_inputs(1, 34, 512, 435, dev, 16))
    for name, B, T, C, ov, seed in STEP_CASES:
        results[f"step-{name}"] = step_case(name, B, T, C, ov, dev, seed,
                                            reps)
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        # BEAT expression branch: c_real = 512 + 256 + 128 = Cp
        results[f"beat-exp-{tag}"] = kernel_case(
            f"beat-exp-{tag}", dtype, 1, 34, 896, 896, False, dev, 1, reps)
        # BEAT gesture branch: + 51 expression channels, padded to 1024
        results[f"beat-ges-{tag}"] = kernel_case(
            f"beat-ges-{tag}", dtype, 1, 34, 1024, 947, False, dev, 2, reps)
        # SHOW classifier-free: doubled batch, first half null rows
        results[f"show-cfg-{tag}"] = kernel_case(
            f"show-cfg-{tag}", dtype, 2, 88, 1024, 999, True, dev, 3, reps)
    for name, B, T, dtype in LIVE_LAYER_CASES:
        results[name] = live_layer_case(name, B, T, dtype, dev, 4, reps)
    for name, *case in WIDE_CASES:
        results[name] = wide_case(name, *case, dev, 19, reps)
    for name, *case in LONG_CASES:
        results[name] = long_case(name, *case, dev, 20, reps)
    for name, *case in ODD_CASES:
        results[name] = odd_case(name, *case, dev, 21, reps)
    results.update(quant_kernel_cases(dev, reps))
    results.update(example_kernel_cases(dev, reps))
    results.update(gemm_cases(dev, reps))
    results.update(speech_encoder_cases(dev, reps))
    return results


def ab_entry(mod, path):
    """The C entry of another build (``path``) of ``mod``'s source; it must
    have the tree's C interface."""
    import ctypes
    from diffsheg_tpu_torch.ops import build
    tree = mod._lib()
    fn = getattr(ctypes.CDLL(str(build.build([path])[path])), tree.__name__)
    fn.argtypes, fn.restype = tree.argtypes, tree.restype
    return fn


def ab_time(mod, other, call, reps):
    """``call`` through the other version and the tree's, in the order
    other, tree, tree, other: ({which: output}, {which: device ms}).  An
    other version that refuses the call is recorded by its message under
    "refused" and timed no further."""
    saved, tree = mod._lib, mod._lib()
    outs, ms = {}, {}
    try:
        for which in ("other", "tree", "tree2", "other2"):
            fn = other if which.startswith("other") else tree
            if fn is other and "refused" in outs:
                continue
            mod._lib = lambda fn=fn, **_: fn
            try:
                outs[which] = call()
            except RuntimeError as e:
                if fn is tree:
                    raise
                outs["refused"] = str(e)
                continue
            ms[which] = device_ms(call, reps) if reps else 0.0
    finally:
        mod._lib = saved
    return outs, ms


def ab_line(what, path, outs, ms, plain, exact):
    if "refused" in outs:
        log(f"ab[{what}] other={path}: refused ({outs['refused']}); tree "
            f"ms {ms['tree']:.4f} {ms['tree2']:.4f}, rel_rms vs plain "
            f"{rel_rms(outs['tree'], plain):.3e}")
        return
    same = torch.equal(outs["other"], outs["tree"])
    log(f"ab[{what}] other={path}: ms other {ms['other']:.4f} tree "
        f"{ms['tree']:.4f} tree {ms['tree2']:.4f} other {ms['other2']:.4f}; "
        f"outputs {'bit-identical' if same else 'differ'}, rel_rms "
        f"{rel_rms(outs['tree'], outs['other']):.3e}; vs plain: other "
        f"{rel_rms(outs['other'], plain):.3e} tree "
        f"{rel_rms(outs['tree'], plain):.3e}")
    if exact and not same:
        raise AssertionError(f"{what}: outputs differ from {path}")


# --ab's fused-layer cases: (name, dtype, B, T, Cp, c_real, F, null rows,
# quant, seed, layers, kernels), phase 3's inputs: the BEAT gesture branch
# and the SHOW classifier-free shape through both kernels, and the
# per-layer kernel alone at the other f32 shapes of the main paths (cli
# generate's 4 speakers, training's evaluation of 7 windows); then the
# raw-HuBERT gesture branch and ff_size 2048 in f32, which a version
# without K passes refuses; then the other pass instantiations (bf16
# ff_size 6144, f32 int4 codes at the raw gesture width) and a 300-frame
# SHOW window in f32 (attention in chunks of T), which a version without
# chunks refuses
BOTH = ("fused_branch", "fused_layer")
AB_LAYER_CASES = (
    ("beat-ges-bf16", torch.bfloat16, 1, 34, 1024, 947, 1024, False, "none",
     2, 8, BOTH),
    ("beat-ges-f32", torch.float32, 1, 34, 1024, 947, 1024, False, "none", 2,
     8, BOTH),
    ("beat-ges-bf16-int8", torch.bfloat16, 1, 34, 1024, 947, 1024, False,
     "int8", 2, 8, BOTH),
    ("beat-ges-bf16-int4", torch.bfloat16, 1, 34, 1024, 947, 1024, False,
     "int4", 2, 8, BOTH),
    ("beat-ges-f32-int8", torch.float32, 1, 34, 1024, 947, 1024, False,
     "int8", 2, 8, BOTH),
    ("beat-ges-f32-int4", torch.float32, 1, 34, 1024, 947, 1024, False,
     "int4", 2, 8, BOTH),
    ("show-cfg-bf16", torch.bfloat16, 2, 88, 1024, 999, 1024, True, "none",
     3, 8, BOTH),
    ("show-cfg-f32", torch.float32, 2, 88, 1024, 999, 1024, True, "none", 3,
     8, BOTH),
    ("layer-beat-4spk-f32", torch.float32, 4, 34, 1024, 947, 1024, False,
     "none", 4, 1, ("fused_layer",)),
    ("layer-eval-beat-f32", torch.float32, 7, 34, 1024, 947, 1024, False,
     "none", 4, 1, ("fused_layer",)),
    ("raw-ges-f32", torch.float32, 1, 34, 1920, 1843, 1024, False, "none",
     19, 8, BOTH),
    ("ff2048-f32", torch.float32, 1, 34, 1024, 947, 2048, False, "none", 19,
     8, BOTH),
    ("ff6144-bf16", torch.bfloat16, 1, 34, 1024, 947, 6144, False, "none",
     19, 8, BOTH),
    ("raw-ges-f32-int4", torch.float32, 1, 34, 1920, 1843, 1024, False,
     "int4", 19, 8, BOTH),
    ("show-t300-f32", torch.float32, 1, 300, 1024, 999, 1024, False, "none",
     20, 8, BOTH))


def ab_fused_layer(dev, reps, path, exact):
    from diffsheg_tpu_torch.ops import fused_layer as ops
    other = ab_entry(ops, path)
    for (name, dtype, B, T, Cp, c_real, F, null, quant, seed, n_layers,
         kernels) in AB_LAYER_CASES:
        x, cond, mods, slp, ne, nm, ssc = case_inputs(
            dtype, B, T, Cp, c_real, null, dev, seed, quant, F=F,
            n_layers=n_layers)
        lp = ops.layer_at(slp, 0)
        sc = None if ssc is None else ops.layer_at(ssc, 0)
        feats = ops.chain_feats(x, cond, None if ne is None else ne[0],
                                nm).to(dtype).contiguous()
        ms_, mf_ = mods[0, 0].contiguous(), mods[0, 1].contiguous()
        calls = {
            "fused_branch": (lambda: ops.fused_branch(
                x, cond, mods, slp, 8, c_real, ne, nm, ssc),
                lambda: ops.fused_branch_reference(
                    x, cond, mods, slp, 8, c_real, ne, nm, ssc)),
            "fused_layer": (lambda: ops.fused_layer(
                x, feats, ms_, mf_, lp, 8, c_real, sc),
                lambda: ops.fused_layer_reference(
                    x, feats, ms_, mf_, lp, 8, c_real, sc))}
        for kname in kernels:
            call, plain = calls[kname]
            outs, ms = ab_time(ops, other, call, reps)
            ab_line(f"{kname} {name}", path, outs, ms, plain(), exact)


def ab_attention(dev, reps, path, exact):
    """Phase 3's linear-attention cases (8 heads, then the wide heads, one
    a block, which a version before the wide kernels refuses)."""
    from diffsheg_tpu_torch.ops import linear_attention as ops
    other = ab_entry(ops, path)
    for H, cases in ((8, ATTENTION_CASES), (1, WIDE_ATTENTION_CASES)):
        for name, dtype, B, T, D, offset in cases:
            q, k, v = attention_inputs(dtype, B, T, D, dev, 11, offset)
            outs, ms = ab_time(
                ops, other, lambda: ops.fused_linear_attention(q, k, v, H),
                reps)
            ab_line(f"fused_linear_attention {name}", path, outs, ms,
                    ops.fused_linear_attention_reference(q, k, v, H), exact)


def ab_step(dev, reps, path, exact):
    """Every step shape, always bit for bit (``exact`` or not): every
    switch combination compared, the main call (low level, valid tail,
    blend) timed."""
    from diffsheg_tpu_torch.ops import step_math as ops
    other = ab_entry(ops, path)
    for name, B, T, C, ov, seed in STEP_CASES:
        combos, main = step_inputs(B, T, C, ov, dev, seed)
        for args in combos:
            outs, _ = ab_time(ops, other,
                              lambda: ops.fused_ddim_repaint_step(*args), 0)
            if not torch.equal(outs["other"], outs["tree"]):
                raise AssertionError(f"step {name}: outputs differ from "
                                     f"{path}")
        outs, ms = ab_time(ops, other,
                           lambda: ops.fused_ddim_repaint_step(*main), reps)
        ab_line(f"fused_ddim_repaint_step {name} ({len(combos)} switch "
                f"combinations compared)", path, outs, ms,
                ops.ddim_repaint_step_reference(*main), True)


def phase_ab(dev, reps, others, exact):
    """The tree's kernels beside other versions of their sources (``--ab``:
    each a ``fused_layer.cu``, ``linear_attention.cu`` or ``step_math.cu``,
    picked by its file name, e.g. the parent commit's): the same inputs
    through both in one process, timed in the order other, tree, tree,
    other, and the outputs compared bit for bit and with the plain
    version.  With ``exact`` a version whose outputs differ fails."""
    by_source = {"fused_layer.cu": ab_fused_layer,
                 "linear_attention.cu": ab_attention,
                 "step_math.cu": ab_step}
    no_tf32()
    try:
        for path in others:
            base = os.path.basename(path)
            if base not in by_source:
                raise ValueError(f"--ab {path}: the file name must be one of "
                                 f"{sorted(by_source)}")
            by_source[base](dev, reps, path, exact)
    finally:
        zero_counts()                    # the timed calls are no main path


# --------------------------------------------------------------------------
# phase 4: stream numerics
# --------------------------------------------------------------------------

# bench.py --check's classifier-free row (bench.py:120-133): the BEAT
# model with guidance on, its own seed
CFG_MODEL = dict(classifier_free=True, cond_scale=1.15)


def beat_cfg(dtype: str, fused_layer: str, model=None, **diffusion):
    from diffsheg_tpu_torch.config import beat_config
    cfg = beat_config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype=dtype,
                                  **(model or {})),
        diffusion=dataclasses.replace(cfg.diffusion, jump_n_sample=2,
                                      fused_layer=fused_layer, **diffusion))


def run_stream(cfg, model, mel, pid, hub, seed, dev):
    from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator
    from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator
    stream = StreamingGenerator(WindowGenerator(cfg, model, device=dev))
    out = stream.generate_fused(mel, pid, GeneratorNoise(seed, dev), hub)
    torch.cuda.synchronize()
    return out


def reference_stream(cfg, model, mel, pid, hub, dev):
    """A stream with every kernel out of it: its attention the plain
    composition (in this process only), its step the streamlined
    composition; asserts that no kernel launched."""
    import diffsheg_tpu_torch.models.attention as attn
    from diffsheg_tpu_torch.ops.linear_attention import (
        linear_attention_reference)
    zero_counts()
    saved = attn.linear_attention
    attn.linear_attention = (lambda q, k, v, h, use_fused=None:
                             linear_attention_reference(q, k, v, h))
    try:
        ref = run_stream(cfg, model, mel, pid, hub, 5, dev)
    finally:
        attn.linear_attention = saved
    expect("kernel-free reference", launch_counts())
    return ref


def plain_swap_stream(cfg, model, mel, pid, hub, dev):
    """The same fast-path stream with its kernel calls swapped for their
    plain versions (in this process only)."""
    import diffsheg_tpu_torch.models.fast_forward as ff
    from diffsheg_tpu_torch.ops import fused_layer as ops
    saved = ff.fused_branch, ff.fused_layer
    ff.fused_branch, ff.fused_layer = (ops.fused_branch_reference,
                                       ops.fused_layer_reference)
    try:
        return run_stream(cfg, model, mel, pid, hub, 5, dev)
    finally:
        ff.fused_branch, ff.fused_layer = saved


def stream_inputs(dev, T=68):
    gen = torch.Generator().manual_seed(7)
    mel = torch.randn(1, T, 128, generator=gen).to(dev)
    hub = torch.randn(1, T, 1024, generator=gen).to(dev)
    pid = torch.nn.functional.one_hot(torch.tensor([1]), 30).float().to(dev)
    return mel, pid, hub


def phase_stream(dev, model):
    """A 68-frame stream (windows at 0, 30 and a left-shifted 34) with the
    same noise through the bf16 and f32 branch-kernel paths and the f32
    module forward on the cache with the step kernel, held against the f32
    fully uncached module forward (fused_layer='off', level_cache=False:
    bench.py --check's reference) with every kernel out of it.  The kernel
    paths are also held against the f32 fast path with its kernel calls
    swapped for their plain versions.  Then bench.py --check's quantized
    rows (``phase_quant_stream``), a raw-HuBERT model in K passes
    (``raw_hubert_stream``), a SHOW model in windows of 352 frames
    (``show_long_stream``), a BEAT model with its widths off 16
    (``odd_width_stream``) and one with a head 1024 wide
    (``wide_head_stream``), each against its own kernel-free reference,
    launches by shape and width."""
    no_tf32()
    mel, pid, hub = stream_inputs(dev)
    ref = reference_stream(beat_cfg("float32", "off", level_cache=False),
                           model, mel, pid, hub, dev)
    # phase 6's path: the module forward on the cache, the step kernel
    f32o = run_stream(beat_cfg("float32", "off", fused_step="on"), model,
                      mel, pid, hub, 5, dev)
    bf16 = run_stream(beat_cfg("bfloat16", "chain"), model, mel, pid, hub, 5, dev)
    zero_counts()
    f32k = run_stream(beat_cfg("float32", "chain"), model, mel, pid, hub, 5, dev)
    # two branches a model call; the f32 level cache of the three windows:
    # its audio encoder's linear attention, its dense layers' products
    expect("stream f32 chain", launch_counts(),
           gemm=cache_gemm(model, 3, 34),
           fused_branch=2 * stream_calls(beat_cfg("float32", "chain"), 68),
           fused_linear_attention=1)
    f32p = plain_swap_stream(beat_cfg("float32", "chain"), model, mel, pid,
                             hub, dev)
    r16, r32 = rel_rms(bf16, ref), rel_rms(f32k, ref)
    r16p, r32p = rel_rms(bf16, f32p), rel_rms(f32k, f32p)
    r32o = rel_rms(f32o, ref)
    log(f"stream[68 frames] vs f32 uncached: bf16-chain rel_rms={r16:.3e} "
        f"(tol 2.5e-2); f32-chain rel_rms={r32:.3e} (tol 5e-3); "
        f"f32-off-cache-step-kernel rel_rms={r32o:.3e} (tol 5e-3); "
        f"vs f32 plain-swap: bf16-chain {r16p:.3e} (tol 2.5e-2), "
        f"f32-chain {r32p:.3e} (tol 5e-3); |x| max {float(ref.abs().max()):.3e}")
    if not (torch.isfinite(ref).all() and torch.isfinite(bf16).all()
            and r16 < 2.5e-2 and r32 < 5e-3 and r32o < 5e-3
            and r16p < 2.5e-2 and r32p < 5e-3):
        raise AssertionError(f"stream bands failed: {r16:.3e}, {r32:.3e}, "
                             f"{r32o:.3e}, {r16p:.3e}, {r32p:.3e}")
    phase_quant_stream(dev, model, ref, mel, pid, hub)
    launches = raw_hubert_stream(dev, mel, pid, hub)
    launches.update(show_long_stream(dev))
    launches.update(odd_width_stream(dev, mel, pid, hub))
    launches.update(wide_head_stream(dev, mel, pid, hub))
    return launches


# a BEAT model fed raw HuBERT features (the reference's --addHubert without
# --encode_hubert): its branches' feats are 1792 and 1843 (padded 1920)
# wide, past one pass of the f32 layer kernels
RAW_HUBERT = dict(encode_hubert=False)
RAW_WIDTHS = ((1792, 1024, 2), (1920, 1024, 2))   # (Cp, F, passes) a branch


def raw_hubert_model():
    from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
    return init_unidiffuser(beat_cfg("float32", "off",
                                     model=RAW_HUBERT).model, seed=3)


def layer_widths():
    """The layer kernels' launches by (Cp, F, passes)."""
    c = counters()
    return (dict(c["fused_layer"].launches_by_width),
            dict(c["fused_branch"].launches_by_width))


def raw_hubert_stream(dev, mel, pid, hub):
    """The 68-frame stream of a seeded raw-HuBERT BEAT model in f32 through
    the per-layer kernel ('auto') and the branch kernel ('chain'), each
    held to 5e-3 against the model's own kernel-free f32 uncached stream
    and against the same path with its kernel calls swapped for their
    plain versions; the launches by width, exactly."""
    model = raw_hubert_model()
    ref = reference_stream(beat_cfg("float32", "off", model=RAW_HUBERT,
                                    level_cache=False),
                           model, mel, pid, hub, dev)
    launches, failed = {}, []
    for mode, kernel in (("auto", "fused_layer"), ("chain", "fused_branch")):
        cfg = beat_cfg("float32", mode, model=RAW_HUBERT)
        calls = stream_calls(cfg, mel.shape[1])
        per = cfg.model.num_layers if mode == "auto" else 1
        zero_counts()
        got = run_stream(cfg, model, mel, pid, hub, 5, dev)
        counts = launch_counts()
        widths = layer_widths()[mode == "chain"]
        swap = plain_swap_stream(cfg, model, mel, pid, hub, dev)
        e_ref, e_swap = rel_rms(got, ref), rel_rms(got, swap)
        log(f"stream[68 frames, raw HuBERT f32 {mode}]: vs f32 uncached "
            f"rel_rms={e_ref:.3e} (tol 5e-3); vs plain-swap rel_rms="
            f"{e_swap:.3e} (tol 5e-3); launches={counts} {kernel} by (Cp, F, "
            f"passes)={widths}")
        # the level cache's audio encoder: one f32 linear-attention launch
        expect(f"raw HuBERT stream {mode}", counts,
               gemm=cache_gemm(model, 3, 34), **{kernel: 2 * per * calls},
               fused_linear_attention=1)
        want = {w: per * calls for w in RAW_WIDTHS}
        if widths != want:
            failed.append(f"{mode}: by width {widths}, expected {want}")
        if not (torch.isfinite(got).all() and e_ref < 5e-3
                and e_swap < 5e-3):
            failed.append(f"{mode}: {e_ref:.3e}, {e_swap:.3e}")
        launches[f"{kernel}_raw_stream"] = counts[kernel]
    if failed:
        raise AssertionError(f"raw HuBERT stream failed: {failed}")
    return launches


# a SHOW model sampling the widest window its server admits (a client's
# window_frames up to 4 x n_poses = 352 frames): 12 s at 30 fps, windows at
# 0 and a left-shifted 8; classifier-free, so a model call runs both rows of
# a window, each a launch of its own past 256 rows
SHOW_LONG_T, SHOW_LONG_SECS = 352, 12


def show_cfg(dtype: str, fused_layer: str, n_poses=SHOW_LONG_T, **diffusion):
    from diffsheg_tpu_torch.config import show_config
    cfg = show_config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype=dtype),
        data=dataclasses.replace(cfg.data, n_poses=n_poses),
        diffusion=dataclasses.replace(cfg.diffusion, jump_n_sample=2,
                                      fused_layer=fused_layer, **diffusion))


@functools.lru_cache(maxsize=None)
def show_model():
    """The seeded SHOW model of phases 4 and 7 (on the CPU; each path
    moves it)."""
    from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
    return init_unidiffuser(show_cfg("float32", "off").model, seed=4)


def show_long_stream(dev):
    """A seeded SHOW model's stream of 352-frame windows in f32 through
    the per-layer kernel ('auto') and in bf16 through the branch kernel
    ('chain'), held to 5e-3 / 2.5e-2 against its own kernel-free f32
    uncached module forward; the launches exactly, by shape and width."""
    from diffsheg_tpu_torch.ops.fused_layer import _batch_groups
    model = show_model()
    m, T = model.cfg, SHOW_LONG_SECS * 30
    gen = torch.Generator().manual_seed(8)
    mel = torch.randn(1, T, m.audio_dim, generator=gen).to(dev)
    hub = torch.randn(1, T, m.hubert_dim, generator=gen).to(dev)
    pid = torch.nn.functional.one_hot(torch.tensor([1]), m.style_dim
                                      ).float().to(dev)
    ref = reference_stream(show_cfg("float32", "off", level_cache=False),
                           model, mel, pid, hub, dev)
    rows = 2 * len(_batch_groups(2, SHOW_LONG_T))   # branches x launches
    launches, failed = {}, []
    for dtype, mode, kernel, tol in (("float32", "auto", "fused_layer", 5e-3),
                                     ("bfloat16", "chain", "fused_branch",
                                      2.5e-2)):
        cfg = show_cfg(dtype, mode)
        calls = stream_calls(cfg, T)
        per = cfg.model.num_layers if mode == "auto" else 1
        zero_counts()
        got = run_stream(cfg, model, mel, pid, hub, 5, dev)
        counts = launch_counts()
        shapes = dict(counters()["fused_layer"].launches_by_shape)
        widths = layer_widths()[mode == "chain"]
        attn = dict(counters()["fused_linear_attention"].launches_by_shape)
        err = rel_rms(got, ref)
        log(f"stream[SHOW {SHOW_LONG_SECS} s, windows of {SHOW_LONG_T}, "
            f"{dtype} {mode}]: vs f32 uncached rel_rms={err:.3e} (tol "
            f"{tol:g}); model_calls={calls} launches={counts} fused_layer "
            f"by shape={shapes} {kernel} by (Cp, F, passes)={widths} "
            f"linear attention by shape={attn}")
        # the level cache's audio encoder: one linear-attention launch in
        # f32 (bf16 takes the composition)
        want = {kernel: rows * per * calls,
                "fused_linear_attention": int(dtype == "float32")}
        gemm = cache_gemm(model, 2, SHOW_LONG_T) if dtype == "float32" else {}
        gap = launch_gap(counts, want, gemm)
        if gap:
            failed.append(f"{mode}: {gap}")
        if mode == "auto" and shapes != {(1, SHOW_LONG_T, m.latent_dim):
                                         rows * per * calls}:
            failed.append(f"{mode}: by shape {shapes}")
        if not (tuple(got.shape) == (1, T, ref.shape[-1])
                and torch.isfinite(got).all() and err < tol):
            failed.append(f"{mode}: {tuple(got.shape)}, {err:.3e}")
        launches[f"{kernel}_show352_stream"] = counts[kernel]
    if failed:
        raise AssertionError(f"SHOW 352-frame stream failed: {failed}")
    return launches


# a BEAT model at the published depth and heads with its widths off a
# multiple of 16 (8 layers a branch, 8 heads of 65, HuBERT-large features):
# both branches' feats pad to 1024, so every launch is (Cp 1024, F 1032, 1
# pass) on the ragged build
ODD_MODEL = dict(latent_dim=520, ff_size=1032)
ODD_WIDTH = (1024, 1032, 1)


def odd_width_stream(dev, mel, pid, hub):
    """The 68-frame stream of a seeded latent-520 / ff_size-1032 BEAT
    model in f32 through the per-layer kernel ('auto') and in bf16 through
    the branch kernel ('chain'), held to 5e-3 / 2.5e-2 against the model's
    own kernel-free f32 uncached stream; the launches exactly, by width."""
    from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
    model = init_unidiffuser(beat_cfg("float32", "off", model=ODD_MODEL).model,
                             seed=5)
    ref = reference_stream(beat_cfg("float32", "off", model=ODD_MODEL,
                                    level_cache=False),
                           model, mel, pid, hub, dev)
    launches, failed = {}, []
    for dtype, mode, kernel, tol in (("float32", "auto", "fused_layer", 5e-3),
                                     ("bfloat16", "chain", "fused_branch",
                                      2.5e-2)):
        cfg = beat_cfg(dtype, mode, model=ODD_MODEL)
        calls = stream_calls(cfg, mel.shape[1])
        per = cfg.model.num_layers if mode == "auto" else 1
        zero_counts()
        t0 = time.perf_counter()
        got = run_stream(cfg, model, mel, pid, hub, 5, dev)
        secs = time.perf_counter() - t0
        counts = launch_counts()
        widths = layer_widths()[mode == "chain"]
        err = rel_rms(got, ref)
        log(f"stream[68 frames, latent 520 ff 1032, {dtype} {mode}]: vs f32 "
            f"uncached rel_rms={err:.3e} (tol {tol:g}); seconds={secs:.3f} "
            f"model_calls={calls} launches={counts} {kernel} by (Cp, F, "
            f"passes)={widths}")
        # the level cache's audio encoder: one linear-attention launch in
        # f32 (bf16 takes the composition)
        want = {kernel: 2 * per * calls,
                "fused_linear_attention": int(dtype == "float32")}
        gemm = cache_gemm(model, 3, 34) if dtype == "float32" else {}
        gap = launch_gap(counts, want, gemm)
        if gap:
            failed.append(f"{mode}: {gap}")
        if widths != {ODD_WIDTH: 2 * per * calls}:
            failed.append(f"{mode}: by width {widths}")
        if not (torch.isfinite(got).all() and err < tol):
            failed.append(f"{mode}: {err:.3e}")
        launches[f"{kernel}_odd_stream"] = counts[kernel]
    if failed:
        raise AssertionError(f"latent-520 stream failed: {failed}")
    return launches


# a BEAT model with one head 1024 wide, 2 layers a branch (cut from 8 to pay
# for its width), through the f32 module forward: every self-attention a
# launch of the wide linear-attention kernels
WIDE_MODEL = dict(latent_dim=1024, num_heads=1, num_layers=2)
WIDE_ATTN = (1, 34, 1024, 1)


def wide_head_stream(dev, mel, pid, hub):
    """The 68-frame stream of a seeded one-head latent-1024 BEAT model
    through the f32 module forward on the level cache (fused_layer='off'),
    held to 5e-3 against its own kernel-free f32 uncached stream; linear
    attention's launches exactly, by shape."""
    from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
    model = init_unidiffuser(beat_cfg("float32", "off", model=WIDE_MODEL
                                      ).model, seed=6)
    ref = reference_stream(beat_cfg("float32", "off", model=WIDE_MODEL,
                                    level_cache=False),
                           model, mel, pid, hub, dev)
    cfg = beat_cfg("float32", "off", model=WIDE_MODEL)
    calls = stream_calls(cfg, mel.shape[1])
    zero_counts()
    t0 = time.perf_counter()
    got = run_stream(cfg, model, mel, pid, hub, 5, dev)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    shapes = dict(counters()["fused_linear_attention"].launches_by_shape)
    err = rel_rms(got, ref)
    log(f"stream[68 frames, latent 1024, one head, f32 off]: vs f32 uncached "
        f"rel_rms={err:.3e} (tol 5e-3); seconds={secs:.3f} "
        f"model_calls={calls} launches={counts} linear attention by "
        f"shape={shapes}")
    # 2 branches x 2 layers a model call, and the level cache's audio
    # encoder once (128 wide, one head)
    self_attn = 2 * WIDE_MODEL["num_layers"] * calls
    expect("one-head latent-1024 stream", counts,
           gemm=cache_gemm(model, 3, 34),
           fused_linear_attention=self_attn + 1)
    if shapes.get(WIDE_ATTN) != self_attn or not (
            torch.isfinite(got).all() and err < 5e-3):
        raise AssertionError(f"one-head latent-1024 stream: {shapes}, "
                             f"{err:.3e}")
    return {"fused_linear_attention_wide_stream": shapes[WIDE_ATTN]}


def phase_quant_stream(dev, model, ref, mel, pid, hub):
    """bench.py --check's quantized rows (bench.py:90-116, :129-155) on the
    same 68-frame stream: bf16 int8 through the per-layer kernel ('on'),
    int8 and int4 through the branch kernel, and int8 through the branch
    kernel on a classifier-free model against its own f32 kernel-free
    reference; each also against the same quantized path with its kernel
    calls swapped for their plain versions, which keeps kernel error apart
    from quantization drift."""
    from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
    cfg_model = init_unidiffuser(beat_cfg("float32", "off",
                                          model=CFG_MODEL).model, seed=1)
    ref_g = reference_stream(beat_cfg("float32", "off", model=CFG_MODEL,
                                      level_cache=False),
                             cfg_model, mel, pid, hub, dev)
    rows = (("int8-on", beat_cfg("bfloat16", "on", quantize="int8"), model,
             ref, 1e-1),
            ("chain-int8", beat_cfg("bfloat16", "chain", quantize="int8"),
             model, ref, 1e-1),
            ("chain-int4", beat_cfg("bfloat16", "chain", quantize="int4"),
             model, ref, 5e-1),
            ("chain-int8-cfg", beat_cfg("bfloat16", "chain", model=CFG_MODEL,
                                        quantize="int8"),
             cfg_model, ref_g, 1e-1))
    failed = []
    for name, cfg, m, r, tol in rows:
        got = run_stream(cfg, m, mel, pid, hub, 5, dev)
        swap = plain_swap_stream(cfg, m, mel, pid, hub, dev)
        e_ref, e_swap = rel_rms(got, r), rel_rms(got, swap)
        log(f"stream[68 frames, bf16 {name}]: vs f32 uncached rel_rms="
            f"{e_ref:.3e} (tol {tol:g}); vs plain-swap rel_rms={e_swap:.3e} "
            f"(tol 2.5e-2)")
        if not (torch.isfinite(got).all() and e_ref < tol and e_swap < 2.5e-2):
            failed.append(f"{name}: {e_ref:.3e}, {e_swap:.3e}")
    if failed:
        raise AssertionError(f"quantized stream bands failed: {failed}")


# --------------------------------------------------------------------------
# phases 5 and 6: the serving pipeline end to end
# --------------------------------------------------------------------------

def synth(secs: int, sr: int) -> np.ndarray:
    """Synthetic speech-band audio (a 220 Hz tone plus seeded noise)."""
    t = np.arange(secs * sr) / sr
    noise = np.random.RandomState(1).randn(secs * sr)
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * noise).astype(
        np.float32)[None]


def make_pipeline(cfg, model, hubert_fe, dev):
    from diffsheg_tpu_torch.audio.mel import MelFrontend
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator
    from diffsheg_tpu_torch.sampling.pipeline import FusedPipeline
    from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator
    frontend = MelFrontend(sr=cfg.data.mel_sr, hop=cfg.data.mel_hop,
                           n_mels=cfg.data.n_mels, device=dev)
    gen = WindowGenerator(cfg, model, device=dev)
    return FusedPipeline(StreamingGenerator(gen), frontend, hubert_fe)


def drive(pipe, secs, dev, seed):
    """One pipeline call on ``secs`` of audio with every launch count set
    to 0 just before and read just after; returns (out, seconds, counts)."""
    from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
    a18 = torch.from_numpy(synth(secs, 18000)).to(dev)
    a16 = torch.from_numpy(synth(secs, 16000)).to(dev)
    pid = torch.nn.functional.one_hot(torch.tensor([1]), 30).float().to(dev)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = pipe(a18, a16, pid, GeneratorNoise(seed, dev))
    torch.cuda.synchronize()
    secs_taken = time.perf_counter() - t0
    counts = launch_counts()
    return out, secs_taken, counts


def expect(what, counts, gemm=None, **want):
    """Exact launch counts (``launch_gap``)."""
    gap = launch_gap(counts, want, gemm)
    if gap:
        raise AssertionError(f"{what}: {gap}")


# a 60 s BEAT stream: windows at 0, 30, ..., 840 and a left-shifted 866,
# the first on the plain program (25 model calls), 29 on the harmonize
# program (27 each); a 10 s stream: windows at 0, 30, 60, 90, 116
CALLS_60S = 25 + 29 * 27            # 808
CALLS_10S = 25 + 4 * 27             # 133
BEAT_ATTN = (1, 34, 512, 8)         # linear attention's (B, T, D, heads)
AUDIO_ENC_ATTN = (750, 34, 128, 8)


def make_hubert(dev):
    from diffsheg_tpu_torch.audio.hubert_runner import HubertFeatureExtractor
    from diffsheg_tpu_torch.models.hubert import HubertConfig
    return HubertFeatureExtractor(HubertConfig(dtype="bfloat16"), seed=3,
                                  device=dev)


def phase_e2e(dev, model, hubert_fe):
    """The BEAT serving pipeline (60 s of audio -> mel -> HuBERT-large ->
    windowed DDIM-25 + RePaint sampler -> motion) at full width with
    seeded random weights, bf16 through the branch kernel: one call, its
    warm-up included, with exact launch counts (the beat-stream-bf16 cell
    takes its FPS and frontend time); then a 10 s stream through the
    per-layer kernel ('auto'); then quantized serving
    (``phase_quant_e2e``)."""
    t_phase = time.perf_counter()
    cfg = beat_cfg("bfloat16", "chain")
    pipe = make_pipeline(cfg, model, hubert_fe, dev)
    log(f"e2e: set-up (model to the card) "
        f"{time.perf_counter() - t_phase:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    out, secs, counts = drive(pipe, 60, dev, 12)
    log(f"e2e[beat 60 s, bf16, fused_layer=chain]: frames={out.shape[1]} "
        f"seconds={secs:.3f} (first call) launches={counts} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if tuple(out.shape) != (1, 900, 192) or not torch.isfinite(out).all():
        raise AssertionError(f"bad output {tuple(out.shape)}")
    expect("chain path", counts, fused_branch=2 * CALLS_60S)

    # the library default 'auto' runs the per-layer kernel
    pipe = make_pipeline(beat_cfg("bfloat16", "auto"), model, hubert_fe, dev)
    drive(pipe, 10, dev, 13)
    out10, secs10, counts10 = drive(pipe, 10, dev, 14)
    log(f"e2e[beat 10 s, bf16, fused_layer=auto]: frames={out10.shape[1]} "
        f"seconds={secs10:.3f} fps={out10.shape[1] / secs10:.1f} "
        f"launches={counts10}")
    if not torch.isfinite(out10).all():
        raise AssertionError("auto path: non-finite output")
    expect("auto path", counts10, fused_layer=16 * CALLS_10S)
    launches = {"fused_branch": counts["fused_branch"],
                "fused_layer": counts10["fused_layer"]}
    launches.update(phase_quant_e2e(dev, model, hubert_fe))
    log(f"e2e: phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_quant_e2e(dev, model, hubert_fe):
    """Quantized serving (diffusion.quantize): the 60 s int8 stream through
    the branch kernel, then 10 s streams of int8 through the per-layer
    kernel ('auto') and of int4 through both.  Returns each quantized
    variant's launches on its main path."""
    launches = {}
    for quant, layer, secs, name, want in (
            ("int8", "chain", 60, "fused_branch", 2 * CALLS_60S),
            ("int8", "auto", 10, "fused_layer", 16 * CALLS_10S),
            ("int4", "chain", 10, "fused_branch", 2 * CALLS_10S),
            ("int4", "auto", 10, "fused_layer", 16 * CALLS_10S)):
        pipe = make_pipeline(beat_cfg("bfloat16", layer, quantize=quant),
                             model, hubert_fe, dev)
        torch.cuda.reset_peak_memory_stats()
        drive(pipe, secs, dev, 15)
        out, taken, counts = drive(pipe, secs, dev, 16)
        log(f"e2e[beat {secs} s, bf16, fused_layer={layer}, quantize="
            f"{quant}]: frames={out.shape[1]} seconds={taken:.3f} "
            f"fps={out.shape[1] / taken:.1f} launches={counts} "
            f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
        if (tuple(out.shape) != (1, 15 * secs, 192)
                or not torch.isfinite(out).all()):
            raise AssertionError(f"{quant} {layer}: bad output "
                                 f"{tuple(out.shape)}")
        expect(f"{quant} {layer} path", counts, **{name: want})
        launches[f"{name}_{quant}"] = counts[name]
    return launches


def phase_uncached(dev, model, hubert_fe):
    """The module forward at f32: every self-attention (16 per model call,
    8 per branch) through the linear-attention kernel, every denoise step
    through the step kernel.  With the level cache the audio encoder runs
    once per stream, over all 25 levels x 30 windows in one launch;
    without it, once per model call.  The 60 s stream on the cache with
    exact launch counts, linear attention's by shape; one model call alone,
    device ms behind a sleep kernel against host ms, and its kernels and
    device busy time under torch.profiler; a 10 s stream without the
    cache."""
    no_tf32()
    t_phase = time.perf_counter()
    cfg = beat_cfg("float32", "off", fused_step="on")
    pipe = make_pipeline(cfg, model, hubert_fe, dev)
    torch.cuda.reset_peak_memory_stats()
    # warmed on 10 s (60 s until PR 17, cut to pay for its phases)
    _, warm_s, _ = drive(pipe, 10, dev, 21)
    out, secs, counts = drive(pipe, 60, dev, 22)
    shapes = dict(counters()["fused_linear_attention"].launches_by_shape)
    log(f"uncached[beat 60 s, f32, fused_layer=off, level cache, "
        f"fused_step=on]: frames={out.shape[1]} warm_10s_s={warm_s:.3f} "
        f"seconds={secs:.3f} fps={out.shape[1] / secs:.1f} "
        f"launches={counts} linear_attention_by_shape={shapes} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if tuple(out.shape) != (1, 900, 192) or not torch.isfinite(out).all():
        raise AssertionError(f"bad output {tuple(out.shape)}")
    expect("module forward on the cache", counts,
           gemm=cache_gemm(model, 30, 34),
           fused_linear_attention=16 * CALLS_60S + 1,
           fused_ddim_repaint_step=CALLS_60S)
    # by (B, T, D, heads): the 16 branch self-attentions of each model
    # call, and the audio encoder once, over 25 levels x 30 windows
    want = {BEAT_ATTN: 16 * CALLS_60S, AUDIO_ENC_ATTN: 1}
    if shapes != want:
        raise AssertionError(f"linear attention by shape: {shapes}, "
                             f"expected {want}")
    # one model call alone (after the counted run): device time behind a
    # sleep kernel against host time, at a mid level of window 0
    gen = pipe.stream.gen
    g = torch.Generator().manual_seed(25)
    mel = torch.randn(1, 34, 128, generator=g).to(dev)
    hub = torch.randn(1, 34, 1024, generator=g).to(dev)
    pid = torch.nn.functional.one_hot(torch.tensor([1]), 30).float().to(dev)
    x = torch.randn(1, 34, 192, generator=g).to(dev)
    fn = gen._denoise_fn(gen.build_cache(mel, pid, hub), None, mel, pid, hub)
    call_dev, call_wall = (f(lambda: fn(x, 12), 20) for f in (device_ms,
                                                               wall_ms))
    # the same call under torch.profiler: how many kernels it launches
    # and how long the device is busy with them
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(x, 12)
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.device_time for e in kern) / 1e3
    log(f"uncached[one model call]: device_ms={call_dev:.3f} "
        f"wall_ms={call_wall:.3f} (stream: {secs / CALLS_60S * 1e3:.3f} ms "
        f"per call); profiler: {len(kern)} kernels, device busy "
        f"{busy_ms:.3f} ms")

    pipe = make_pipeline(beat_cfg("float32", "off", fused_step="on",
                                  level_cache=False), model, hubert_fe, dev)
    drive(pipe, 10, dev, 23)
    out10, secs10, counts10 = drive(pipe, 10, dev, 24)
    log(f"uncached[beat 10 s, f32, fused_layer=off, level_cache=False, "
        f"fused_step=on]: frames={out10.shape[1]} seconds={secs10:.3f} "
        f"fps={out10.shape[1] / secs10:.1f} launches={counts10}")
    if not torch.isfinite(out10).all():
        raise AssertionError("uncached path: non-finite output")
    expect("fully uncached forward", counts10,
           fused_linear_attention=17 * CALLS_10S,
           fused_ddim_repaint_step=CALLS_10S)
    log(f"uncached: phase {time.perf_counter() - t_phase:.1f} s")
    # the kernels line's two attention rows, each the launches of its own
    # shape in the 60 s run
    return {"fused_linear_attention": shapes[BEAT_ATTN],
            "fused_linear_attention_audio_enc": shapes[AUDIO_ENC_ATTN],
            "fused_ddim_repaint_step": counts["fused_ddim_repaint_step"]}


# --------------------------------------------------------------------------
# phase 7: live sessions through the serving daemon
# --------------------------------------------------------------------------

class TimedHubert:
    """The HuBERT extractor with each call timed, synchronised before and
    after (a window needs its features before it samples)."""

    def __init__(self, fe):
        self.fe, self.ms = fe, []

    def __getattr__(self, name):
        return getattr(self.fe, name)

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fe(*args, **kwargs)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def speech_like(secs: int, sr: int, seed: int) -> np.ndarray:
    """Synthetic speech-like audio: a voice gliding around 160 Hz with two
    overtones under a 4 Hz syllable envelope, plus seeded noise."""
    t = np.arange(secs * sr) / sr
    phase = 2 * np.pi * np.cumsum(160 + 60 * np.sin(2 * np.pi * 0.3 * t)) / sr
    voice = sum(np.sin(k * phase) / k for k in (1, 2, 3))
    env = (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t)) ** 2
    noise = np.random.RandomState(seed).randn(t.size)
    return (0.2 * voice * env + 0.02 * noise).astype(np.float32)


def push_stream(push, secs: int, chunk_s: float = 0.1):
    """Both streams of ``secs`` of audio in ``chunk_s`` chunks, unpaced:
    (each push's output, each push's service ms)."""
    a18, a16 = speech_like(secs, 18000, 1), speech_like(secs, 16000, 2)
    n18, n16 = int(18000 * chunk_s), int(16000 * chunk_s)
    outs, ms = [], []
    for i in range(int(round(secs / chunk_s))):
        t0 = time.perf_counter()
        outs.append(push(a18[i * n18:(i + 1) * n18],
                         a16[i * n16:(i + 1) * n16]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, ms


# (tag, window frames, speakers, seconds, the server): the BEAT server
# through the per-layer kernel ('auto') or the branch kernel ('chain'),
# and (e) a SHOW server (bf16, 'auto') asked for its widest window, 4 x 88
# frames: 15 s, so that window 0 completes in a push and window 1 at the
# end (both rows of a classifier-free window, each a launch of its own)
LIVE_SESSIONS = (("a", 34, 1, 20, "auto"), ("b", 12, 1, 20, "auto"),
                 ("c", 34, 4, 20, "auto"), ("d", 34, 1, 10, "chain"),
                 ("e", 352, 1, 15, "show"))
LIVE_SEED = 31


def launch_wall_ms(kind, B, T, dev, reps):
    """Host ms per synchronised launch of the per-layer (``layer``) or the
    branch (``chain``) kernel at a session's shape (gesture branch,
    bf16)."""
    from diffsheg_tpu_torch.ops.fused_layer import (chain_feats, fused_branch,
                                                    fused_layer, layer_at)
    n = 8 if kind == "chain" else 1
    x, cond, mods, slp, _, _, _ = case_inputs(torch.bfloat16, B, T, 1024, 947,
                                              False, dev, 5, n_layers=n)
    if kind == "chain":
        return wall_ms(lambda: fused_branch(x, cond, mods, slp, 8, 947), reps)
    feats = chain_feats(x, cond, None, None).contiguous()
    ms_, mf_ = mods[0, 0].contiguous(), mods[0, 1].contiguous()
    lp = layer_at(slp, 0)
    return wall_ms(lambda: fused_layer(x, feats, ms_, mf_, lp, 8, 947), reps)


def live_session(srv, hub, tag, W, B, secs, mode, dev, reps):
    """One session through a ``MotionClient``, every launch count set to
    0 just before and read just after; asserts the counts and the output,
    prints the latency line; returns (motion, pushes' outputs, counts)."""
    from diffsheg_tpu_torch.ops.fused_layer import _batch_groups
    from diffsheg_tpu_torch.sampling.streamer import window_starts
    from diffsheg_tpu_torch.serving.server import MotionClient
    default = W == srv.cfg.data.n_poses
    hub.ms.clear()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    with MotionClient(*srv.address, timeout=300) as cli:
        info = cli.start(speakers=list(range(1, 4 * B + 1, 4)),
                         seed=LIVE_SEED, window_frames=0 if default else W)
        outs, ms = push_stream(cli.push, secs)
        motion = cli.finish()
    secs_taken = time.perf_counter() - t0
    counts = launch_counts()

    cfg = srv.cfg
    ov = cfg.stream.overlap_len if default else min(cfg.stream.overlap_len,
                                                    W // 2)
    step, T = W - ov, secs * cfg.data.fps
    gen = srv._gens[(W, ov)]
    K = len(window_starts(T, W, step))
    calls = gen.num_model_calls_plain + (K - 1) * gen.num_model_calls_repaint
    # a classifier-free model runs each speaker's conditional and null rows
    groups = len(_batch_groups(B * (1 + cfg.model.classifier_free), W))
    want = ({"fused_branch": 2 * calls * groups} if mode == "chain" else
            {"fused_layer": 2 * cfg.model.num_layers * calls * groups})
    what = f"({tag}) window {W}, {B} speaker(s), {secs} s, {mode}"
    if (info["window"] != W
            or tuple(motion.shape) != (B, T, info["channels"])
            or not np.isfinite(motion).all()):
        raise AssertionError(f"live {what}: window {info['window']}, output "
                             f"{tuple(motion.shape)}")
    expect(f"live {what}", counts, **want)

    done = [m for o, m in zip(outs, ms) if o.shape[1]]
    in_pushes = sum(o.shape[1] for o in outs) // step
    p50, worst = statistics.median(done), max(done)
    lookahead = W / cfg.data.fps
    kind = "chain" if mode == "chain" else "layer"
    lwall = launch_wall_ms(kind, B, W, dev, reps)
    log(f"live[{what}]: windows={K} ({in_pushes} in pushes) "
        f"model_calls={calls} compute_ms p50={p50:.2f} max={worst:.2f} "
        f"first={done[0]:.2f} hubert_ms p50="
        f"{statistics.median(hub.ms):.2f} (n={len(hub.ms)}) "
        f"lookahead_s={lookahead:.3f} worst_latency_s="
        f"{lookahead + worst / 1e3:.3f} headroom="
        f"{step / cfg.data.fps / (p50 / 1e3):.2f}x session_s={secs_taken:.3f} "
        f"{'fused_branch' if mode == 'chain' else 'fused_layer'} "
        f"wall_ms={lwall:.4f} launches={counts}")
    return motion, outs, counts


def window_profile(cfg, model, pid, hubert_fe, gens, dev):
    """Where a window's time goes: one in-process push that runs windows
    0 and 1 (the plain and a harmonize program, 52 model calls) timed on
    the host, and the same push of a second session under torch.profiler
    for the device's busy time and kernel count."""
    from torch.profiler import ProfilerActivity, profile
    from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
    from diffsheg_tpu_torch.sampling.live import LiveSession
    # 4.4 s: 66 frames, past window 1's gates (64 frames, its last frame's
    # analysis span, 68267 samples at 16 kHz), short of window 2's
    a18, a16 = speech_like(5, 18000, 1)[:79200], speech_like(5, 16000, 2)[:70400]

    def session():
        return LiveSession.create(cfg, model, pid, GeneratorNoise(3, dev),
                                  hubert_extractor=hubert_fe, gen_cache=gens,
                                  device=dev)

    sess = session()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sess.push(a18, a16)
    wall = (time.perf_counter() - t0) * 1e3
    sess = session()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sess.push(a18, a16)
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.device_time for e in kern) / 1e3
    if out.shape[1] != 60:
        raise AssertionError(f"window profile: {out.shape[1]} frames, not 60")
    log(f"live[one push running windows 0-1, W 34, auto, 52 model calls]: "
        f"wall_ms={wall:.2f} device busy_ms={busy:.2f} (torch.profiler, "
        f"{len(kern)} kernels) idle share={1 - busy / wall:.3f}")


def phase_live(dev, model, hubert_fe, reps):
    """The serving daemon on the card: BEAT at full width, bf16, HuBERT-
    large, a ``MotionServer`` on 127.0.0.1 (port 0) with client geometry
    and both served geometries prewarmed; sessions (a)-(c) through the
    per-layer kernel ('auto'), (d) through a second server started with
    ``--set diffusion.fused_layer=chain``, (e) through a SHOW server
    (bf16, 'auto') asked for window_frames 352 (``LIVE_SESSIONS``), each
    fed by a ``MotionClient`` in 100 ms chunks, unpaced.  Per session the
    exact launches and a latency line (``live_session``): windows,
    per-window compute p50 / max (the service time of the pushes that
    completed a window), HuBERT ms a window, the lookahead W / fps, worst
    latency, real-time headroom, the kernel's host ms a launch.  Session
    (a) must equal an in-process ``LiveSession`` bit for bit; one push's
    device busy time under torch.profiler (``window_profile``).  Returns
    each session's launches of its kernel."""
    from diffsheg_tpu_torch.cli.main import _apply_overrides
    from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
    from diffsheg_tpu_torch.sampling.live import LiveSession
    from diffsheg_tpu_torch.serving.server import MotionServer
    t_phase = time.perf_counter()
    hub = TimedHubert(hubert_fe)
    base = beat_cfg("bfloat16", "auto")
    show = show_cfg("bfloat16", "auto", n_poses=88)
    models = {"auto": model, "chain": model, "show": show_model()}
    servers = {}
    launches = {}
    try:
        for mode, cfg in (("auto", base), ("chain", _apply_overrides(
                base, ["diffusion.fused_layer=chain"])), ("show", show)):
            srv = MotionServer(cfg, models[mode], hubert_extractor=hub,
                               port=0, client_geometry=True, device=dev,
                               log=log)
            srv.start_background()
            servers[mode] = srv
            if mode == "show":     # its session builds the window's set-up
                continue
            srv.prewarm((1,))
            if mode == "auto":
                srv.prewarm((1,), window_frames=12)
        log(f"live: set-up (three servers, BEAT's prewarmed) "
            f"{time.perf_counter() - t_phase:.1f} s")
        for tag, W, B, secs, mode in LIVE_SESSIONS:
            motion, outs, counts = live_session(servers[mode], hub, tag, W,
                                                B, secs, mode, dev, reps)
            launches[tag] = counts
            if tag != "a":
                continue
            pid = torch.nn.functional.one_hot(torch.tensor([1]), 30).float()
            gens = {}
            sess = LiveSession.create(base, model, pid.to(dev),
                                      GeneratorNoise(LIVE_SEED, dev),
                                      hubert_extractor=hub, gen_cache=gens,
                                      device=dev)
            own, _ = push_stream(sess.push, secs)
            own_motion = sess.finish()
            same = (torch.equal(torch.from_numpy(motion.copy()), own_motion)
                    and all(torch.equal(torch.from_numpy(a.copy()), b)
                            for a, b in zip(outs, own)))
            log(f"live[(a) served vs in-process]: bit-identical={same} "
                f"max_abs={float((torch.from_numpy(motion.copy()) - own_motion).abs().max()):.3e}")
            if not same:
                raise AssertionError("served session (a) differs from the "
                                     "in-process session")
            window_profile(base, model, pid.to(dev), hubert_fe, gens, dev)
    finally:
        for srv in servers.values():
            srv.shutdown(drain_seconds=1.0)
    log(f"live: phase {time.perf_counter() - t_phase:.1f} s")
    return {"fused_layer_live_w34": launches["a"]["fused_layer"],
            "fused_layer_live_w12": launches["b"]["fused_layer"],
            "fused_layer_live_b4": launches["c"]["fused_layer"],
            "fused_branch_live": launches["d"]["fused_branch"],
            "fused_layer_live_show352": launches["e"]["fused_layer"]}


# --------------------------------------------------------------------------
# phase 8: every model variant through the module forward
# --------------------------------------------------------------------------

# (tag, model overrides, diffusion overrides, linear-attention launches a
# model call at the branch rows and at the audio encoder, step launches a
# call): (a) the decoder base, 16 self- and 16 cross-attentions (its memory
# has the window's length) and the audio encoder; (b) a learned-variance
# model sampled ancestrally, no step kernel; (c) one branch, no audio
# encoder, conditioned on text and emotion labels; (d) the learned-variance
# model through DDIM, the step kernel on the mean half of its output
VARIANTS = (
    ("a", dict(model_base="transformer_decoder"), dict(fused_step="on"),
     32, 1, 1),
    ("b", dict(learned_variance=True),
     dict(var_type="learned_range", sampler="ancestral"), 16, 1, 0),
    ("c", dict(branch_mode="gesture_only", add_text_cond=True,
               add_emo_cond=True), dict(fused_step="on"), 8, 0, 1),
    ("d", dict(learned_variance=True),
     dict(var_type="learned_range", fused_step="on"), 16, 1, 1),
)
BEAT_AUDIO_ATTN = (1, 34, 128, 8)   # the audio encoder, once a model call


@torch.no_grad()
def bound_variance_head(model, seed):
    """The variance half of each branch's output head: zero weights and a
    seeded uniform [-1, 1) bias, a per-channel constant where a trained
    head's output lies.  A random head's raw output grows with the
    sample, which a random model's epsilon inflates, until exp(log_var /
    2) overflows float32 within a window."""
    gen = torch.Generator().manual_seed(seed)
    for branch in (model.encoder_exp, model.encoder_ges):
        n = branch.input_feats
        branch.out.weight[n:] = 0.0
        branch.out.bias[n:] = 2.0 * torch.rand(n, generator=gen) - 1.0
    return model


def variant_model(tag, model_over):
    from diffsheg_tpu_torch.models.factory import init_denoiser
    model = init_denoiser(beat_cfg("float32", "auto", model=model_over).model,
                          seed=8)
    return (bound_variance_head(model, 9)
            if model_over.get("learned_variance") else model)


def variant_plain_swap(cfg, model, mel, pid, hub, dev):
    """A 68-frame stream with every kernel of the module forward swapped
    for its plain version (in this process only): the attention
    composition, the streamlined step composition; asserts that no kernel
    launched."""
    import diffsheg_tpu_torch.diffusion.sampler as smp
    import diffsheg_tpu_torch.models.attention as attn
    from diffsheg_tpu_torch.ops.linear_attention import (
        linear_attention_reference)
    zero_counts()
    saved = attn.linear_attention, smp.fused_ddim_repaint_step
    attn.linear_attention = (lambda q, k, v, h, use_fused=None:
                             linear_attention_reference(q, k, v, h))
    smp.fused_ddim_repaint_step = smp.ddim_repaint_step_reference
    try:
        out = run_stream(cfg, model, mel, pid, hub, 5, dev)
    finally:
        attn.linear_attention, smp.fused_ddim_repaint_step = saved
    expect("plain-swap variant stream", launch_counts())
    return out


def phase_variants(dev, hubert_fe):
    """Each variant built by ``init_denoiser`` at BEAT's full width (f32,
    seeded random weights) under the default generator settings
    (level_cache=True, fused_layer='auto'), which run these models
    uncached through the module forward: a 10 s ``FusedPipeline`` stream
    with exact launch counts (every linear attention in the kernel, each
    denoise step of (a), (c) and (d) in the step kernel); then a 68-frame
    stream against the same path with its kernels swapped for their plain
    versions, f32 rel-RMS <= 5e-3.  Each stream line has its FPS, kernels
    and host ms a model call.  Returns each path's launches by shape."""
    no_tf32()
    t_phase = time.perf_counter()
    launches = {}
    mel, pid, hub = stream_inputs(dev)
    for tag, model_over, diff_over, per_call, audio, step in VARIANTS:
        cfg = beat_cfg("float32", "auto", model=model_over, **diff_over)
        model = variant_model(tag, model_over)
        pipe = make_pipeline(cfg, model, hubert_fe, dev)
        gen = pipe.stream.gen
        if gen.use_cache or gen.use_fast:
            raise AssertionError(f"variant ({tag}): took the level cache")
        drive(pipe, 10, dev, 31)
        out, secs, counts = drive(pipe, 10, dev, 32)
        shapes = dict(counters()["fused_linear_attention"].launches_by_shape)
        C = 141 if model_over.get("branch_mode") == "gesture_only" else 192
        log(f"variants[({tag}) {model_over} {diff_over}, beat 10 s, f32]: "
            f"frames={out.shape[1]} seconds={secs:.3f} "
            f"fps={out.shape[1] / secs:.1f} model_calls={CALLS_10S} "
            f"kernels_per_call={sum(counts.values()) / CALLS_10S:.2f} "
            f"host_ms_per_call={secs / CALLS_10S * 1e3:.3f} "
            f"launches={counts} linear_attention_by_shape={shapes}")
        if tuple(out.shape) != (1, 150, C) or not torch.isfinite(out).all():
            raise AssertionError(f"variant ({tag}): bad output "
                                 f"{tuple(out.shape)}")
        expect(f"variant ({tag})", counts,
               fused_linear_attention=(per_call + audio) * CALLS_10S,
               fused_ddim_repaint_step=step * CALLS_10S)
        want = {BEAT_ATTN: per_call * CALLS_10S}
        if audio:
            want[BEAT_AUDIO_ATTN] = audio * CALLS_10S
        if shapes != want:
            raise AssertionError(f"variant ({tag}): linear attention by "
                                 f"shape {shapes}, expected {want}")
        launches[tag] = dict(shapes, step=counts["fused_ddim_repaint_step"])

        got = run_stream(cfg, model, mel, pid, hub, 5, dev)
        ref = variant_plain_swap(cfg, model, mel, pid, hub, dev)
        err = rel_rms(got, ref)
        log(f"variants[({tag}) 68 frames]: vs plain-swap rel_rms={err:.3e} "
            f"(tol 5e-3); |x| max {float(ref.abs().max()):.3e}")
        if not (torch.isfinite(got).all() and torch.isfinite(ref).all()
                and err <= 5e-3):
            raise AssertionError(f"variant ({tag}) stream band: {err:.3e}")
    log(f"variants: phase {time.perf_counter() - t_phase:.1f} s")
    a, b, c, d = (launches[t] for t in "abcd")
    return {"fused_linear_attention_decoder": a[BEAT_ATTN],
            "fused_linear_attention_decoder_audio_enc": a[BEAT_AUDIO_ATTN],
            "fused_ddim_repaint_step_decoder": a["step"],
            "fused_linear_attention_learned_var": b[BEAT_ATTN],
            "fused_linear_attention_learned_var_audio_enc":
                b[BEAT_AUDIO_ATTN],
            "fused_linear_attention_single": c[BEAT_ATTN],
            "fused_ddim_repaint_step_single": c["step"],
            "fused_ddim_repaint_step_learned_var": d["step"]}


# --------------------------------------------------------------------------
# phase 9: custom-audio generation through the command line
# --------------------------------------------------------------------------

def write_wav(path, x, sr):
    """16-bit mono PCM."""
    import wave
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return path


def beat_template(path):
    """A template BVH of the 228-channel BEAT skeleton: every joint in one
    chain, unit offsets, a root with translation, one frame of zeros."""
    from diffsheg_tpu_torch.geometry.joints import BEAT_JOINT_ORDER
    lines = ["HIERARCHY"]
    for d, name in enumerate(BEAT_JOINT_ORDER):
        pad = "  " * d
        ch = ("CHANNELS 6 Xposition Yposition Zposition "
              "Zrotation Xrotation Yrotation" if d == 0 else
              "CHANNELS 3 Zrotation Xrotation Yrotation")
        lines += [f"{pad}{'ROOT' if d == 0 else 'JOINT'} {name}", f"{pad}{{",
                  f"{pad}  OFFSET 0.0 1.0 0.0", f"{pad}  {ch}"]
    nj = len(BEAT_JOINT_ORDER)
    lines += ["  " * nj + "End Site", "  " * nj + "{",
              "  " * nj + "  OFFSET 0 0.1 0", "  " * nj + "}"]
    lines += ["  " * (d - 1) + "}" for d in range(nj, 0, -1)]
    lines += ["MOTION", "Frames: 1", "Frame Time: 0.06666667",
              " ".join(["0.0"] * 228)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def beat_stats(path, seed):
    """Seeded BEAT statistics, std in [0.5, 1.5]."""
    from diffsheg_tpu_torch.data.beat import BeatStats
    rng = np.random.RandomState(seed)
    BeatStats(rng.randn(141), 0.5 + rng.rand(141), 0.3 * rng.randn(141),
              0.5 + rng.rand(141), rng.rand(51),
              0.5 + rng.rand(51)).save(path)
    return BeatStats.load(path)


def show_stats(path, seed):
    """Seeded TalkSHOW statistics (the reference's raw dict layout)."""
    from diffsheg_tpu_torch.data.show import ShowStats
    rng = np.random.RandomState(seed)
    raw = {"pose_mean": 0.3 * rng.randn(165), "pose_std": 0.5 + rng.rand(165),
           "expression_mean": 0.3 * rng.randn(100),
           "expression_std": 0.5 + rng.rand(100)}
    np.save(os.path.join(path, "talkshow_mean_std.npy"), raw,
            allow_pickle=True)
    return ShowStats.from_raw_dict(raw)


class CliRun:
    """``cli.main.main(argv)`` in-process with every launch count set to 0
    after ``--warmup``'s call (``CustomAudioPipeline.warmup``) and read
    when the command returns; records the pipeline, the timed call's
    result, the export's host seconds and what the command printed."""

    def __init__(self):
        from diffsheg_tpu_torch.cli import generate as g
        self.g = g
        self.pipe = self.result = None
        self.export_s = 0.0

    def __call__(self, argv):
        g, run = self.g, self
        warmup, generate = g.CustomAudioPipeline.warmup, g.CustomAudioPipeline.generate
        exports = (g.CustomAudioPipeline.export_beat,
                   g.CustomAudioPipeline.export_show)

        def warm(self, *a, **kw):
            warmup(self, *a, **kw)
            torch.cuda.synchronize()
            zero_counts()

        def gen(self, *a, **kw):
            run.pipe, run.result = self, generate(self, *a, **kw)
            return run.result

        def timed(fn):
            def wrapped(self, *a, **kw):
                t0 = time.perf_counter()
                out = fn(self, *a, **kw)
                run.export_s += time.perf_counter() - t0
                return out
            return wrapped

        g.CustomAudioPipeline.warmup, g.CustomAudioPipeline.generate = warm, gen
        g.CustomAudioPipeline.export_beat, g.CustomAudioPipeline.export_show = (
            timed(f) for f in exports)
        from diffsheg_tpu_torch.cli.main import main
        out = io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                rc = main(argv)
        finally:
            g.CustomAudioPipeline.warmup, g.CustomAudioPipeline.generate = (
                warmup, generate)
            (g.CustomAudioPipeline.export_beat,
             g.CustomAudioPipeline.export_show) = exports
        self.seconds = time.perf_counter() - t0
        self.counts = launch_counts()
        self.shapes = dict(counters()["fused_linear_attention"]
                           .launches_by_shape)
        self.printed = out.getvalue().splitlines()
        if rc != 0:
            raise AssertionError(f"cli generate {argv}: exit {rc}")
        return self


# cli generate at its defaults (jump_n_sample 5: a continuation window runs
# 63 model calls): 60 s of BEAT, 30 windows; 10 s, 5 windows; SHOW 10 s at
# 30 fps, windows of 88 frames at 0, 78, 156 and a left-shifted 212
GEN_CALLS_60S = 25 + 29 * 63        # 1852
GEN_CALLS_10S = 25 + 4 * 63         # 277
GEN_CALLS_SHOW_10S = 25 + 3 * 63    # 214


def generate_line(tag, run, frames):
    head = next(ln for ln in run.printed if ln.startswith("generated"))
    n_files = len(run.printed) - 1
    log(f"generate[{tag}]: {head} | command_s={run.seconds:.3f} "
        f"export_host_s={run.export_s:.3f} "
        f"({run.export_s / max(1, run.result.motion.shape[0]):.3f} a clip) "
        f"frames={frames} launches={run.counts} "
        f"linear_attention_by_shape={run.shapes} files={n_files}")


def check_attention_shapes(what, shapes, want):
    if shapes != want:
        raise AssertionError(f"{what}: linear attention by shape {shapes}, "
                             f"expected {want}")


def check_layer_shapes(what, shapes, want):
    if shapes != want:
        raise AssertionError(f"{what}: per-layer kernel by (B, T, L) "
                             f"{shapes}, expected {want}")


def check_beat_files(run, out_dir, stats, name, speakers, frames):
    """Every clip's npy equals motion * std + mean; its BVH parses back to
    (frames, 228), finite; its face JSON has 51 names and ``frames``
    frames; its player exists."""
    from diffsheg_tpu_torch.geometry.bvh import parse_bvh_file
    motion = run.result.motion
    for b in range(len(speakers)):
        base = os.path.join(out_dir, f"{name}_{b}")
        npy = np.load(base + ".npy")
        if not np.array_equal(npy, motion[b] * stats.motion_std
                              + stats.motion_mean):
            raise AssertionError(f"{base}.npy != motion * std + mean")
        bvh = parse_bvh_file(base + ".bvh").frames
        if bvh.shape != (frames, 228) or not np.isfinite(bvh).all():
            raise AssertionError(f"{base}.bvh: {bvh.shape}, finite "
                                 f"{np.isfinite(bvh).all()}")
        with open(base + "_face.json") as f:
            face = json.load(f)
        if len(face["names"]) != 51 or len(face["frames"]) != frames:
            raise AssertionError(f"{base}_face.json: {len(face['names'])} "
                                 f"names, {len(face['frames'])} frames")
        if not os.path.getsize(base + "_player.html"):
            raise AssertionError(f"{base}_player.html is empty")


def exporter_on_card(stats, dev):
    """The exporter's euler conversion on the card against the same
    function on the CPU over 900 frames x 47 joints, on unit-scale
    normalized motion through the statistics (a random model's samples
    reach ~1e5, where a 1e5 rad axis-angle's angles are f32 argument
    reduction noise on any device).  Each angle comes from asin or atan2
    of matrix entries whose size is |cos(middle angle)|, so the round-off
    of two f32 implementations grows as 1 / |cos| (at +-90 degrees the
    split between the first and third angle is arbitrary): the difference
    in degrees, times |cos| of the joint's middle angle, within 1e-4 for
    every joint; the raw difference is printed by bands of |cos|."""
    from diffsheg_tpu_torch.sampling.export import BeatMotionExporter
    motion = np.random.RandomState(91).randn(900, 192).astype(np.float32)
    pose = (motion * stats.motion_std + stats.motion_mean)[:, :141]
    card, cpu = (BeatMotionExporter(141, 15.0, stats.motion_mean,
                                    stats.motion_std, device=d)
                 for d in (dev, "cpu"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = card.euler_degrees(pose)
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = cpu.euler_degrees(pose)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    got, ref = (a.reshape(900, 47, 3).astype(np.float64) for a in (got, ref))
    cos = np.abs(np.cos(np.deg2rad(ref[..., 1])))
    diff = np.abs(got - ref).max(-1)
    scaled = float((diff * cos).max())
    bands = []
    for lo, hi in ((0.9, 1.01), (0.5, 0.9), (0.3, 0.5), (0.1, 0.3),
                   (0.01, 0.1), (0.0, 0.01)):
        m = (cos >= lo) & (cos < hi)
        bands.append(f"|cos| {lo:g}-{min(hi, 1):g}: n={int(m.sum())} "
                     f"max={float(diff[m].max()) if m.any() else 0.0:.3e}")
    log(f"generate[exporter on the card]: 900 x 47 joints, max |deg| card "
        f"- cpu x |cos(middle)| {scaled:.3e} (tol 1e-4); raw max |deg| by "
        f"band: " + "; ".join(bands) + f"; conversion ms card "
        f"{card_ms:.2f} cpu {cpu_ms:.2f}")
    if not (np.isfinite(got).all() and scaled <= 1e-4):
        raise AssertionError(f"exporter on the card: {scaled:.3e} deg "
                             f"(conditioning-weighed)")


def hubert_base_on_card(dev):
    """A HuBERT-base-geometry extractor (768 x 12, seeded random weights)
    on 10 s of audio on the card against its CPU run, f32."""
    from diffsheg_tpu_torch.audio.hubert_runner import HubertFeatureExtractor
    from diffsheg_tpu_torch.models.factory import random_init_
    from diffsheg_tpu_torch.models.hubert import (HubertModel,
                                                  wav2vec2_base_config)
    import copy
    model = random_init_(HubertModel(wav2vec2_base_config()), 5)
    audio = speech_like(10, 16000, 9)
    cpu = HubertFeatureExtractor(model=copy.deepcopy(model), device="cpu")
    t0 = time.perf_counter()
    ref = cpu(audio, target_frames=150)
    cpu_s = time.perf_counter() - t0
    card = HubertFeatureExtractor(model=model, device=dev)
    card(audio, target_frames=150)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = card(audio, target_frames=150)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    err = rel_rms(got.cpu(), ref)
    log(f"generate[HuBERT-base 768 x 12, 10 s]: rel_rms card vs cpu "
        f"{err:.3e} (tol 1e-5) shape={tuple(got.shape)} card_ms="
        f"{card_ms:.2f} cpu_s={cpu_s:.2f}")
    if tuple(got.shape) != (1, 150, 768) or not err <= 1e-5:
        raise AssertionError(f"HuBERT-base on the card: {err:.3e}")


def phase_generate(dev, model):
    """``python -m diffsheg_tpu_torch.cli generate`` in-process on the
    card, in a temporary directory with a 60 s speech-like wav, seeded
    BEAT statistics, a BEAT template BVH and the model exported once to a
    reference ``.tar``: (a) the defaults (f32, fused_layer 'auto', the
    per-layer kernel) with 4 speaker styles, ``--warmup``,
    ``--template-bvh`` and ``--player``; (b) the bench's configuration
    (bf16, 'chain', jump_n_sample 2), one speaker; (c) the staged path
    (``stream.single_dispatch=false``), 10 s; (d) SHOW, 10 s; (e) a model
    fed raw HuBERT features, 10 s (its f32 layers in K passes).  Launch
    counts exactly (zeroed after the warm-up), FPS and RTF as the command
    prints them, its stages and the export's host seconds a clip; every
    BVH parsed back, every face JSON and npy checked; (a)'s motion against
    a direct ``CustomAudioPipeline.generate`` bit for bit; the exporter's
    euler conversion on the card against the CPU (``exporter_on_card``);
    a HuBERT-base extractor (768 x 12) on the card against the CPU, f32
    rel-RMS <= 1e-5."""
    import tempfile
    from diffsheg_tpu_torch.cli.generate import CustomAudioPipeline
    from diffsheg_tpu_torch.compat.torch_ckpt import save_reference_checkpoint
    from diffsheg_tpu_torch.config import beat_config
    no_tf32()
    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        wav60 = write_wav(os.path.join(tmp, "speech.wav"),
                          speech_like(60, 16000, 41), 16000)
        wav10 = write_wav(os.path.join(tmp, "short.wav"),
                          speech_like(10, 16000, 42), 16000)
        stats_dir = os.path.join(tmp, "stats")
        stats = beat_stats(stats_dir, 43)
        tmpl = beat_template(os.path.join(tmp, "template.bvh"))
        tar = save_reference_checkpoint(model, os.path.join(tmp, "beat.tar"))
        common = ["generate", "--checkpoint", tar, "--stats-dir", stats_dir,
                  "--warmup"]

        # (a) the defaults, four speaker styles in one batch
        out_a = os.path.join(tmp, "a")
        speakers = [1, 3, 5, 7]
        a = CliRun()(common + ["--audio", wav60, "--out-dir", out_a,
                               "--speakers", "1,3,5,7", "--template-bvh",
                               tmpl, "--player"])
        generate_line("(a) beat 60 s, f32, auto, 4 speakers", a, 900)
        if a.result.motion.shape != (4, 900, 192) or not np.isfinite(
                a.result.motion).all():
            raise AssertionError(f"(a): motion {a.result.motion.shape}")
        expect("generate (a)", a.counts,
               gemm=plus(cache_gemm(model, 4 * 30, 34),
                         extractor_gemm(60 * 16000)),
               fused_layer=16 * GEN_CALLS_60S, fused_linear_attention=1)
        check_attention_shapes("generate (a)", a.shapes,
                               {(3000, 34, 128, 8): 1})
        check_beat_files(a, out_a, stats, "speech", speakers, 900)
        log("generate[(a) files]: " + " ".join(
            os.path.basename(p) for p in a.printed[1:]))
        launches["fused_layer_generate"] = a.counts["fused_layer"]
        launches["fused_linear_attention_generate_audio_enc"] = a.counts[
            "fused_linear_attention"]
        # the CLI adds nothing to the motion: the same model (not through
        # the .tar) and HuBERT, a direct pipeline call with the same seed
        cfg = beat_config()
        direct = CustomAudioPipeline(
            cfg, model, hubert_model=a.pipe.hubert_extractor.model,
            motion_mean=stats.motion_mean, motion_std=stats.motion_std,
            device=dev).generate(wav60, speakers, seed=0)
        same = np.array_equal(direct.motion, a.result.motion)
        log(f"generate[(a) against CustomAudioPipeline.generate]: "
            f"bit-equal={same}")
        if not same:
            raise AssertionError("cli generate's motion differs from a "
                                 "direct CustomAudioPipeline.generate")
        del direct, a

        # (b) the bench's configuration
        b = CliRun()(common + ["--audio", wav60, "--out-dir",
                               os.path.join(tmp, "b"), "--speakers", "1",
                               "--set", "model.compute_dtype=bfloat16",
                               "--set", "diffusion.fused_layer=chain",
                               "--set", "diffusion.jump_n_sample=2"])
        generate_line("(b) beat 60 s, bf16, chain, jump_n_sample 2", b, 900)
        # HuBERT stays f32 (its own HubertConfig) under a bf16 model
        expect("generate (b)", b.counts, gemm=extractor_gemm(60 * 16000),
               fused_branch=2 * CALLS_60S)
        launches["fused_branch_generate"] = b.counts["fused_branch"]

        # (c) the staged path: mel, HuBERT and sampler stages
        c = CliRun()(common + ["--audio", wav10, "--out-dir",
                               os.path.join(tmp, "c"), "--speakers", "1",
                               "--set", "stream.single_dispatch=false"])
        generate_line("(c) beat 10 s, f32, auto, staged", c, 150)
        if set(c.result.stages) != {"mel", "hubert", "sampler", "total"}:
            raise AssertionError(f"(c): stages {c.result.stages}")
        expect("generate (c)", c.counts,
               gemm=plus(cache_gemm(model, 5, 34), extractor_gemm(10 * 16000)),
               fused_layer=16 * GEN_CALLS_10S, fused_linear_attention=1)
        check_attention_shapes("generate (c)", c.shapes,
                               {(125, 34, 128, 8): 1})
        launches["fused_layer_generate_staged"] = c.counts["fused_layer"]
        launches["fused_linear_attention_generate_staged_audio_enc"] = (
            c.counts["fused_linear_attention"])

        # (d) SHOW: classifier-free guidance doubles the rows
        show_dir = os.path.join(tmp, "show_stats")
        os.makedirs(show_dir)
        sstats = show_stats(show_dir, 44)
        d = CliRun()(["generate", "--dataset", "show", "--stats-dir",
                      show_dir, "--warmup", "--audio", wav10, "--out-dir",
                      os.path.join(tmp, "d"), "--speakers", "1"])
        generate_line("(d) show 10 s, f32, auto", d, 300)
        expect("generate (d)", d.counts,
               gemm=plus(cache_gemm(show_model(), 4, 88),
                         extractor_gemm(10 * 16000)),
               fused_layer=16 * GEN_CALLS_SHOW_10S, fused_linear_attention=1)
        check_attention_shapes("generate (d)", d.shapes,
                               {(100, 88, 128, 8): 1})
        npy = np.load(os.path.join(tmp, "d", "short_0.npy"))
        want = d.result.motion[0] * sstats.motion_std + sstats.motion_mean
        if npy.shape != (300, 232) or not np.array_equal(npy, want):
            raise AssertionError(f"(d): npy {npy.shape} != inv_standardize")
        launches["fused_layer_generate_show"] = d.counts["fused_layer"]
        launches["fused_linear_attention_generate_show_audio_enc"] = (
            d.counts["fused_linear_attention"])

        # (e) raw HuBERT features: f32 layers in K passes
        raw = raw_hubert_model()
        raw_tar = save_reference_checkpoint(raw, os.path.join(tmp, "raw.tar"))
        e = CliRun()(["generate", "--checkpoint", raw_tar, "--stats-dir",
                      stats_dir, "--warmup", "--audio", wav10, "--out-dir",
                      os.path.join(tmp, "e"), "--speakers", "1", "--set",
                      "model.encode_hubert=false"])
        widths = layer_widths()[0]
        generate_line("(e) beat 10 s, f32, auto, raw HuBERT", e, 150)
        log(f"generate[(e) per-layer launches by (B, T, L)]: "
            f"{dict(counters()['fused_layer'].launches_by_shape)} by (Cp, F, "
            f"passes): {widths}")
        if e.result.motion.shape != (1, 150, 192) or not np.isfinite(
                e.result.motion).all():
            raise AssertionError(f"(e): motion {e.result.motion.shape}")
        expect("generate (e)", e.counts,
               gemm=plus(cache_gemm(raw, 5, 34), extractor_gemm(10 * 16000)),
               fused_layer=16 * GEN_CALLS_10S, fused_linear_attention=1)
        check_attention_shapes("generate (e)", e.shapes,
                               {(125, 34, 128, 8): 1})
        expect_shapes("generate (e) per-layer kernel by (Cp, F, passes)",
                      widths, {w: 8 * GEN_CALLS_10S for w in RAW_WIDTHS})
        launches["fused_layer_generate_raw"] = e.counts["fused_layer"]

        exporter_on_card(stats, dev)
    hubert_base_on_card(dev)
    log(f"generate: phase {time.perf_counter() - t_phase:.1f} s")
    return launches



# --------------------------------------------------------------------------
# phase 10: training
# --------------------------------------------------------------------------

TRAIN_WINDOWS = 5000                # two steps an epoch at the batch
TRAIN_BATCH = 2500                  # beat_config().train.batch_size
TRAIN_ATTN = (TRAIN_BATCH, 34, 512, 8)
TRAIN_AUDIO_ATTN = (TRAIN_BATCH, 34, 128, 8)
EVAL_BATCH = 64
EVAL_AUDIO_ATTN = (25 * EVAL_BATCH, 34, 128, 8)   # the level cache's rows
# the per-layer kernel takes at most 256 rows a launch: 7 windows of 34
# frames, so a layer of the 64-window batch is 10 launches (9 of 7
# windows, 1 of 1)
EVAL_LAYER_LAUNCHES = 25 * 16 * 10


def write_beat_caches(root, n, seed):
    """A synthetic BEAT train cache of ``n`` 34-frame windows with every
    field at its width (the raw 16 kHz audio included), and a HuBERT
    cache of 34 frames x 1024 a window, through the port's CacheWriter;
    returns (cache, hubert cache)."""
    from diffsheg_tpu_torch.data.cache import CacheWriter
    rng = np.random.default_rng(seed)
    T, S = 34, 36266                 # 34 frames at 15 fps of 16 kHz audio

    def normal(*shape, scale=1.0):
        return rng.standard_normal(shape, dtype=np.float32) * scale

    f = {"pose": normal(n, T, 141), "pose_axis_angle": normal(n, T, 141),
         "audio": normal(n, S, scale=0.1), "mel": normal(n, T, 128),
         "facial": normal(n, T, 51),
         "sem": rng.random((n, T), dtype=np.float32),
         "id": rng.integers(0, 30, (n, 1)).astype(np.int32),
         "word": rng.integers(-1, 2048, (n, T)).astype(np.int32),
         "emo": rng.integers(0, 8, (n, T)).astype(np.int32)}
    hub = normal(n, T, 1024, scale=0.5)
    cache, hcache = os.path.join(root, "cache"), os.path.join(root, "hubert")
    w = CacheWriter(cache, meta={"n_poses": T})
    for i in range(n):
        w.add({k: v[i] for k, v in f.items()})
    w.finalize()
    w = CacheWriter(hcache)
    for i in range(n):
        w.add({"hubert": hub[i]})
    w.finalize()
    return cache, hcache


def flat_params(model_or_state_dict) -> torch.Tensor:
    sd = (model_or_state_dict.state_dict()
          if isinstance(model_or_state_dict, torch.nn.Module)
          else model_or_state_dict)
    return torch.cat([v.detach().float().flatten().cpu()
                      for k, v in sd.items() if "running_" not in k])


class TrainRecorder:
    """Times the trainer's steps (device-synchronised) and the loader's
    batches (on its thread), and keeps each step's loss terms, while
    ``cli train`` runs in this process."""

    def __init__(self):
        import diffsheg_tpu_torch.train.trainer as trainer_mod
        from diffsheg_tpu_torch.data.loader import ShardedBatchLoader
        self.mod, self.loader_cls = trainer_mod, ShardedBatchLoader
        self.steps, self.loads = [], []

    def __enter__(self):
        make, make_batch = self.mod.make_train_step, self.loader_cls._make
        self.saved = make, make_batch

        def timed_make(*a, **k):
            fn = make(*a, **k)

            def step(state, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, terms = fn(state, batch)
                torch.cuda.synchronize()
                self.steps.append(((time.perf_counter() - t0) * 1e3,
                                   terms._asdict()))
                return state, terms
            return step

        def timed_batch(loader, rows):
            t0 = time.perf_counter()
            out = make_batch(loader, rows)
            self.loads.append((time.perf_counter() - t0) * 1e3)
            return out

        self.mod.make_train_step = timed_make
        self.loader_cls._make = timed_batch
        return self

    def __exit__(self, *exc):
        self.mod.make_train_step, self.loader_cls._make = self.saved


def train_run(tag, argv, steps, dev):
    """One in-process ``cli train``; its launches asserted exactly, its
    steps' loss terms printed (their time is the beat-train-f32 cell's);
    returns the recorder."""
    from diffsheg_tpu_torch.cli.main import main
    attn = counters()["fused_linear_attention"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with TrainRecorder() as rec:
        main(argv)
    secs = time.perf_counter() - t0
    expect(f"train {tag}", launch_counts(),
           gemm=train_gemm(TRAIN_BATCH, steps),
           fused_linear_attention=33 * steps)
    check_attention_shapes(f"train {tag}", attn.launches_by_shape,
                           {TRAIN_ATTN: 32 * steps,
                            TRAIN_AUDIO_ATTN: steps})
    if len(rec.steps) != steps:
        raise AssertionError(f"train {tag}: {len(rec.steps)} steps, "
                             f"expected {steps}")
    for i, (_, terms) in enumerate(rec.steps):
        log(f"train[{tag}] step {i}: " + " ".join(
            f"{k}={v:.6g}" for k, v in terms.items()))
    log(f"train[{tag}]: {steps} steps in {secs:.1f} s of command; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loader "
        f"{statistics.median(rec.loads):.1f} ms a batch "
        f"({len(rec.loads)} batches); launches {attn.launches} "
        f"({dict(attn.launches_by_shape)})")
    return rec


def train_band(what, a_terms, b_terms, a_params, b_params, tol):
    """Loss terms (relative, each step) and parameters (rel-RMS over all
    of them as one vector) of two runs of the same steps."""
    t_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                for a, b in zip(a_terms, b_terms) for k in b if b[k] != 0)
    p_err = rel_rms(a_params, b_params)
    log(f"train[{what}]: loss terms rel {t_err:.3e}, parameters rel_rms "
        f"{p_err:.3e} (tol {tol:g})")
    if not (t_err <= tol and p_err <= tol):
        raise AssertionError(f"train {what}: {t_err:.3e} / {p_err:.3e} > "
                             f"{tol:g}")


def injected_steps(cfg, batch, ts, noises, dev, plain=False, frontend=None):
    """Injected-randomness steps (one for each of ``ts``) from ``cfg``'s
    model with seeded random weights (the same for every ``cfg`` of one
    architecture), each on ``frontend(batch)`` if a speech ``frontend`` is
    given, as the trainer feeds its step; with ``plain`` the
    linear-attention kernel swapped for its plain version (in this
    process only).  Returns (terms, parameters after)."""
    import diffsheg_tpu_torch.models.attention as attn
    from diffsheg_tpu_torch.diffusion.schedule import (
        get_named_beta_schedule, make_schedule)
    from diffsheg_tpu_torch.models.factory import init_denoiser
    from diffsheg_tpu_torch.ops.linear_attention import (
        linear_attention_reference)
    from diffsheg_tpu_torch.train.step import (create_train_state,
                                               make_train_step)
    sched = make_schedule(get_named_beta_schedule("linear", 1000))
    state = create_train_state(cfg, init_denoiser(cfg.model, seed=3), dev)
    step = make_train_step(cfg, sched, inject_randoms=True)
    saved = attn.linear_attention
    if plain:
        attn.linear_attention = (lambda q, k, v, h, use_fused=None:
                                 linear_attention_reference(q, k, v, h))
    terms = []
    try:
        for t, n in zip(ts, noises):
            state, tm = step(state, batch if frontend is None
                             else frontend(batch), t, n)
            terms.append({k: float(v) for k, v in tm._asdict().items()})
    finally:
        attn.linear_attention = saved
    torch.cuda.synchronize()
    return terms, flat_params(state.model)


def train_step_gemm(dev):
    """gemm_tf32x3's launches by (M, N, K, layout) in one BEAT training
    step of ``make_train_step`` at the published batch with remat, exactly
    ``train_gemm``'s.  The step's time and where it goes are the
    beat-train-f32 cell's (``device_idle_pct.train``,
    ``products_ms_per_step.train``, the ledger's breakdown)."""
    from diffsheg_tpu_torch.config import beat_config
    from diffsheg_tpu_torch.diffusion.schedule import (
        get_named_beta_schedule, make_schedule)
    from diffsheg_tpu_torch.models.factory import init_denoiser
    from diffsheg_tpu_torch.ops.products import gemm_tf32x3
    from diffsheg_tpu_torch.train.step import (create_train_state,
                                               make_train_step)
    cfg = beat_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, remat=True))
    state = create_train_state(cfg, init_denoiser(cfg.model, seed=5), dev)
    step = make_train_step(cfg, make_schedule(get_named_beta_schedule(
        "linear", 1000)))
    gen = torch.Generator(device=dev).manual_seed(6)
    B = TRAIN_BATCH
    batch = {"motion": torch.randn(B, 34, 192, generator=gen, device=dev),
             "mel": torch.randn(B, 34, 128, generator=gen, device=dev),
             "pid": torch.nn.functional.one_hot(
                 torch.arange(B, device=dev) % 30, 30).float(),
             "hubert": torch.randn(B, 34, 1024, generator=gen, device=dev),
             "sem": torch.rand(B, 34, generator=gen, device=dev)}
    gemm_tf32x3.launches_by_shape.clear()
    step(state, batch)
    torch.cuda.synchronize()
    shapes = dict(gemm_tf32x3.launches_by_shape)
    by_layout = {lay: sum(n for k, n in shapes.items() if k[3] == lay)
                 for lay in ("nt", "nn", "tn")}
    tflop = sum(2.0 * m * n * k * c
                for (m, n, k, _), c in shapes.items()) / 1e12
    log(f"train[one step, gemm_tf32x3]: {sum(shapes.values())} launches "
        f"{by_layout}, {tflop:.2f} TFLOP; by (M, N, K, layout): {shapes}")
    if shapes != train_gemm(B):
        raise AssertionError(f"train step: gemm_tf32x3 launches {shapes}, "
                             f"expected {train_gemm(B)}")
    del state, batch


def phase_train(dev):
    """(a) ``cli train`` in-process on synthetic caches of 5000 windows (and
    a HuBERT-large cache), BEAT at full width, f32, ``model.remat=true``,
    batch 2500: 2 epochs, ``--resume`` for a third, against 3
    uninterrupted (1e-6); peak memory, loader ms, linear attention's
    launches by shape; one step of ``make_train_step`` with
    ``gemm_tf32x3``'s launches by shape (``train_step_gemm``).  The step's
    time is the beat-train-f32 cell's.  (b) At batch 256 the kernel
    against the plain composition inside 3 steps (1e-5) and remat against
    none (1e-6).  (c) ``Trainer.evaluate`` of 64 windows through the
    per-layer kernel before and after a step."""
    import shutil
    import tempfile
    from diffsheg_tpu_torch.config import beat_config
    no_tf32()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cache, hcache = write_beat_caches(tmp, TRAIN_WINDOWS, 40)
        log(f"train: caches of {TRAIN_WINDOWS} windows written in "
            f"{time.perf_counter() - t0:.1f} s")
        common = ["train", "--device", "cuda", "--train-cache", cache,
                  "--hubert-cache", hcache, "--set", "model.remat=true",
                  "--set", "train.log_every=1"]
        # (a) 2 epochs, then --resume for a third; against 3 uninterrupted
        w1, w3 = os.path.join(tmp, "run"), os.path.join(tmp, "run3")
        r1 = train_run("2 epochs", common + ["--workdir", w1, "--epochs",
                                             "2"], 4, dev)
        r2 = train_run("resumed 3rd", common + ["--workdir", w1, "--epochs",
                                                "3", "--resume"], 2, dev)
        r3 = train_run("3 epochs", common + ["--workdir", w3, "--epochs",
                                             "3"], 6, dev)
        launches["fused_linear_attention_train"] = 32 * 4
        launches["fused_linear_attention_train_audio_enc"] = 4
        with open(os.path.join(w1, "metrics.jsonl")) as f:
            logged = [json.loads(x) for x in f if '"total"' in x]
        if len(logged) != 6:
            raise AssertionError(f"metrics.jsonl: {len(logged)} step records")
        end = [torch.load(os.path.join(w, "ckpt", "latest", "3", "state.pt"),
                          map_location="cpu", weights_only=True)["model"]
               for w in (w1, w3)]
        train_band("resumed vs uninterrupted",
                   [t for _, t in r2.steps], [t for _, t in r3.steps[4:]],
                   flat_params(end[0]), flat_params(end[1]), 1e-6)
        shutil.rmtree(w1)
        shutil.rmtree(w3)
        train_step_gemm(dev)

        # (b) batch 256: kernel against plain, remat against no remat
        cfg = beat_config()
        remat = cfg.replace(model=dataclasses.replace(cfg.model, remat=True))
        gen = torch.Generator().manual_seed(41)
        B = 256
        batch = {"motion": torch.randn(B, 34, 192, generator=gen),
                 "mel": torch.randn(B, 34, 128, generator=gen),
                 "pid": torch.nn.functional.one_hot(
                     torch.arange(B) % 30, 30).float(),
                 "hubert": 0.5 * torch.randn(B, 34, 1024, generator=gen),
                 "sem": torch.rand(B, 34, generator=gen)}
        batch = {k: v.to(dev) for k, v in batch.items()}
        ts = [torch.randint(0, 1000, (B,), generator=gen).to(dev)
              for _ in range(3)]
        noises = [torch.randn(B, 34, 192, generator=gen).to(dev)
                  for _ in range(3)]
        zero_counts()
        k_terms, k_params = injected_steps(remat, batch, ts, noises, dev)
        expect("train (b) kernel", launch_counts(),
               gemm=train_gemm(B, 3), fused_linear_attention=3 * 33)
        zero_counts()
        p_terms, p_params = injected_steps(remat, batch, ts, noises, dev,
                                           plain=True)
        expect("train (b) plain", launch_counts(), gemm=train_gemm(B, 3))
        n_terms, n_params = injected_steps(cfg, batch, ts, noises, dev)
        train_band("(b) kernel vs plain, batch 256", k_terms, p_terms,
                   k_params, p_params, 1e-5)
        train_band("(b) remat vs none, batch 256", k_terms, n_terms,
                   k_params, n_params, 1e-6)
        del batch, k_params, p_params, n_params

        # (c) evaluation on 64 windows, one step, again
        from diffsheg_tpu_torch.data.beat import BeatDataset
        from diffsheg_tpu_torch.data.loader import ShardedBatchLoader
        from diffsheg_tpu_torch.train.trainer import Trainer
        vcache, vhub = write_beat_caches(os.path.join(tmp, "val"),
                                         EVAL_BATCH, 42)
        ds = BeatDataset(vcache, hubert_cache_dir=vhub)
        loader = ShardedBatchLoader(ds, global_batch_size=EVAL_BATCH,
                                    prefetch=0)
        tr = Trainer(cfg, os.path.join(tmp, "eval"), device=dev)
        res = []
        for i in range(2):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = tr.evaluate(loader, seed=5)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            expect(f"evaluate {i}", launch_counts(),
                   gemm=cache_gemm(beat_structure(), EVAL_BATCH, 34,
                                   EVAL_BATCH),
                   fused_layer=EVAL_LAYER_LAUNCHES,
                   fused_linear_attention=1)
            check_attention_shapes(
                f"evaluate {i}",
                counters()["fused_linear_attention"].launches_by_shape,
                {EVAL_AUDIO_ATTN: 1})
            log(f"train[evaluate {i}]: {secs:.2f} s " + " ".join(
                f"{k}={v:.6g}" for k, v in r.as_dict().items()))
            vals = [r.mse, r.pck, r.pck2, r.diversity]
            if not all(np.isfinite(v) for v in vals):
                raise AssertionError(f"evaluate {i}: {r}")
            res.append(vals)
            if i == 0:
                b = tr._on_device(tr._to_model_batch(
                    ds.batch(np.arange(EVAL_BATCH))))
                tr.state, _ = tr._step_full(tr.state, b)
        if res[0] == res[1]:
            raise AssertionError("the evaluation after a training step "
                                 "equals the one before it")
        launches["fused_layer_eval"] = EVAL_LAYER_LAUNCHES
        launches["fused_linear_attention_eval_audio_enc"] = 1
    log(f"train: phase {time.perf_counter() - t_phase:.1f} s")
    return launches

# --------------------------------------------------------------------------
# phase 11: data — caches from raw splits, then train, eval, test-stream
# --------------------------------------------------------------------------

DATA_SECS = 60
# the test split's clips are half as long, so that test-stream's loop over
# two clips costs what one 60 s clip did
DATA_TEST_SECS = 30
DATA_CLIPS = {"train": 8, "val": 1, "test": 2}
DATA_WINDOWS = (DATA_SECS * 15 - 34) // 10 + 1      # 87 windows a clip
DATA_TRAIN_WINDOWS = DATA_CLIPS["train"] * DATA_WINDOWS      # 696: one step
DATA_TRAIN_ATTN = (DATA_TRAIN_WINDOWS, 34, 512, 8)
DATA_TRAIN_AUDIO_ATTN = (DATA_TRAIN_WINDOWS, 34, 128, 8)
# cli eval: batches of min(32, windows), the last partial one dropped: 2 of
# the val split's 87; the per-layer kernel splits 32 windows into launches
# of 7, 7, 7, 7 and 4; the level cache's audio encoder takes 25 x 32 rows
DATA_EVAL_BATCHES = 2
DATA_EVAL_LAYER = DATA_EVAL_BATCHES * 25 * 16 * 5
DATA_EVAL_LAYER_7, DATA_EVAL_LAYER_4 = (7, 34, 512), (4, 34, 512)
DATA_EVAL_AUDIO_ATTN = (25 * 32, 34, 128, 8)
# cli test-stream: the host window loop over each 450-frame clip, 15
# windows (jump_n_sample 5: 25 model calls, then 63 a continuation window),
# each window's level cache at batch 1
DATA_STREAM_WINDOWS = 15
DATA_STREAM_CALLS = 25 + (DATA_STREAM_WINDOWS - 1) * 63     # 907
STREAM_AUDIO_ATTN = (25, 34, 128, 8)
STREAM_LAYER = (1, 34, 512)
DATA_SHOW_SEQS, DATA_SHOW_FRAMES = 4, 900
DATA_SHOW_WINDOWS = (DATA_SHOW_FRAMES - 88) // 10 + 1  # 82 a sequence


def write_raw_splits(root, seed, clips=None, show=True):
    """Synthetic raw splits in the layout ``build-cache`` reads: BEAT
    splits of ``clips`` (default ``DATA_CLIPS``: train / val / test) 60 s
    clips, 30 s in the test split (``bvh_rot`` euler-degree rows,
    ``wave16k`` speech-like audio, ``facial52`` JSON, ``sem`` TSV), and
    with ``show`` SHOW train ``.npz`` sequences of 30 s."""
    from diffsheg_tpu_torch.geometry.face import write_face_json
    rng = np.random.RandomState(seed)
    for split, n in (clips or DATA_CLIPS).items():
        secs = DATA_TEST_SECS if split == "test" else DATA_SECS
        T = secs * 15
        d = os.path.join(root, "beat", split)
        for sub in ("bvh_rot", "wave16k", "facial52", "sem"):
            os.makedirs(os.path.join(d, sub))
        for i in range(n):
            cid = f"{i + 1}_speaker{i}_0_{i + 1}_{i + 1}"
            np.savetxt(os.path.join(d, "bvh_rot", cid + ".bvh"),
                       rng.randn(T, 141) * 25, fmt="%.6f")
            np.save(os.path.join(d, "wave16k", cid + ".npy"),
                    speech_like(secs, 16000, seed + i))
            write_face_json(rng.rand(T, 51),
                            os.path.join(d, "facial52", cid + ".json"))
            with open(os.path.join(d, "sem", cid + ".txt"), "w") as f:
                for s in range(0, secs, 4):
                    f.write(f"w\t{s + 0.5}\t{s + 2.0}\t1.5\t"
                            f"{rng.rand():.3f}\tword\n")
    if not show:
        return
    d = os.path.join(root, "show", "train")
    os.makedirs(d)
    for i in range(DATA_SHOW_SEQS):
        np.savez(os.path.join(d, f"seq{i}.npz"),
                 pose=rng.randn(DATA_SHOW_FRAMES, 165).astype(np.float32),
                 expression=rng.randn(DATA_SHOW_FRAMES, 100).astype(
                     np.float32),
                 audio=speech_like(DATA_SHOW_FRAMES // 30, 16000, seed + 9),
                 speaker=np.asarray(20 + i))


def cli_call(argv):
    """``cli.main.main(argv)`` in-process with every launch count set to 0
    first: (printed lines, seconds, launches, launches by shape of linear
    attention and of the per-layer kernel, by kernel name)."""
    from diffsheg_tpu_torch.cli.main import main
    out = io.StringIO()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit {rc}")
    return (out.getvalue().splitlines(), secs,
            launch_counts(),
            {name: dict(counters()[name].launches_by_shape)
             for name in ("fused_linear_attention", "fused_layer")})


def printed_json(lines):
    """The JSON object a command printed last (``json.dumps(..., indent=2)``
    from a line that starts with "{")."""
    start = max(i for i, ln in enumerate(lines) if ln.startswith("{"))
    return json.loads("\n".join(lines[start:]))


def build_split(tag, argv, cache):
    """One in-process ``cli build-cache``: no kernel launches; its windows,
    seconds and windows a second printed."""
    from diffsheg_tpu_torch.data.cache import ArrayCache
    _, secs, counts, _ = cli_call(["build-cache"] + argv + ["--out", cache])
    expect(f"build-cache {tag}", counts)
    n = len(ArrayCache(cache))
    log(f"data[build-cache {tag}]: {n} windows in {secs:.2f} s, "
        f"{n / secs:.1f} windows/s")
    return n


def assert_caches_equal(what, a_dir, b_dir, a_stats=None, b_stats=None):
    """Field for field: mel and mfcc within 2e-5 of scale, axis-angle
    (de-normalized by each cache's statistics) within 1e-4 through the
    rebuilt rotation matrices, everything else bit for bit."""
    from diffsheg_tpu_torch.data.cache import ArrayCache
    from diffsheg_tpu_torch.geometry.rotations import axis_angle_to_matrix
    A, B = ArrayCache(a_dir), ArrayCache(b_dir)
    if A.fields != B.fields or len(A) != len(B) or A.meta != B.meta:
        raise AssertionError(f"{what}: {A.fields} / {len(A)} against "
                             f"{B.fields} / {len(B)}")
    worst = {}
    for k in A.fields:
        a, b = A.gather(k, np.arange(len(A))), B.gather(k, np.arange(len(B)))
        if k in ("mel", "mfcc"):
            err = float(np.abs(a - b).max() / np.abs(b).max())
            ok = err <= 2e-5
        elif k == "pose_axis_angle":
            ma, mb = (axis_angle_to_matrix(torch.from_numpy(
                (x * s.std_axis_angle + s.mean_axis_angle).astype(
                    np.float32).reshape(-1, 3)))
                for x, s in ((a, a_stats), (b, b_stats)))
            err = float((ma - mb).abs().max())
            ok = err <= 1e-4
        else:
            err = float(not np.array_equal(a, b))
            ok = err == 0
        worst[k] = err
        if not ok:
            raise AssertionError(f"{what}: field {k} differs by {err:.3e}")
    log(f"data[{what}]: {len(A)} windows equal field for field (mel / "
        f"mfcc max |diff| / max, axis-angle max |matrix diff|, others "
        f"bit for bit): " + " ".join(f"{k}={v:.3e}" for k, v in
                                     worst.items()))


def fgd_reference_file(path, seed):
    """A seeded FGD feature net at BEAT's shape (34 frames x 192, latent
    300; BatchNorm statistics moved off identity) saved with
    ``torch.save`` under the reference autoencoder's names, as
    ``ae_300.bin`` holds them (``compat/fgd_ckpt.py`` reads them back)."""
    import argparse
    from diffsheg_tpu_torch.eval.fgd_net import FgdNetConfig, init_fgd_net
    net = init_fgd_net(FgdNetConfig(), seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    enc, sd = net.pose_encoder, {}
    names = {"conv0": "net.0.0", "bn0": "net.0.1", "conv1": "net.1.0",
             "bn1": "net.1.1", "conv2": "net.2.0", "bn2": "net.2.1",
             "conv3": "net.3", "fc1": "out_net.0", "fcbn1": "out_net.1",
             "fc2": "out_net.3", "fcbn2": "out_net.4", "fc3": "out_net.6",
             "fc_mu": "fc_mu"}
    for ours, ref in names.items():
        mod = getattr(enc, ours)
        mod = getattr(mod, "BatchNorm_0", mod)
        for k, v in mod.state_dict().items():
            if k == "running_mean":
                v = 0.1 * torch.randn(v.shape, generator=gen)
            elif k == "running_var":
                v = 1.0 + 0.2 * torch.rand(v.shape, generator=gen)
            sd[f"pose_encoder.{ref}.{k}"] = v.clone()
    torch.save({"args": argparse.Namespace(vae_length=300), "epoch": 300,
                "model_state": sd}, path)
    return path


def fgd_on_card(path, dev, reps):
    """The FGD net of ``path`` on the card against the same net on the
    CPU (f32 rel-RMS <= 1e-5) on a batch of 32 windows, and its device ms
    a batch."""
    from diffsheg_tpu_torch.compat.fgd_ckpt import load_torch_fgd_checkpoint
    from diffsheg_tpu_torch.eval.fgd_net import FgdNetConfig
    cfg = FgdNetConfig()
    x = torch.randn(32, 34, 192, generator=torch.Generator().manual_seed(5))
    card = load_torch_fgd_checkpoint(path, cfg, device=dev)
    cpu = load_torch_fgd_checkpoint(path, cfg, device="cpu")
    xd = x.to(dev)
    with torch.no_grad():
        err = rel_rms(card(xd).cpu(), cpu(x))
        ms = device_ms(lambda: card(xd), reps)
    log(f"data[fgd net]: card against CPU rel_rms={err:.3e} (tol 1e-5); "
        f"{ms:.4f} ms a batch of 32 windows")
    if not err <= 1e-5:
        raise AssertionError(f"FGD net on the card: {err:.3e}")


def check_stream_files(out_dir, clips, frames):
    """Every clip's npy is (frames, 192) finite, its BVH parses back to
    (frames, 228) finite, its face JSON has 51 names and ``frames``
    frames, its player exists."""
    from diffsheg_tpu_torch.geometry.bvh import parse_bvh_file
    for i in range(clips):
        base = os.path.join(out_dir, f"clip_{i:05d}")
        npy = np.load(base + ".npy")
        bvh = parse_bvh_file(base + ".bvh").frames
        with open(base + "_face.json") as f:
            face = json.load(f)
        if (npy.shape != (frames, 192) or not np.isfinite(npy).all()
                or bvh.shape != (frames, 228) or not np.isfinite(bvh).all()
                or len(face["names"]) != 51 or len(face["frames"]) != frames
                or not os.path.getsize(base + "_player.html")):
            raise AssertionError(f"{base}: npy {npy.shape}, bvh {bvh.shape}, "
                                 f"face {len(face['frames'])} frames")


def phase_data(dev, reps):
    """The loop a user of the paper runs, on synthetic raw splits at BEAT's
    published width (BEAT: 60 s clips, train 8, val 1; test 2 clips of 30
    s; SHOW: 4 sequences of 30 s): (1) ``cli build-cache`` on the card for
    every split (BEAT train / val / test, SHOW train; windows a second),
    the BEAT train split and the SHOW split again on the CPU, held equal
    field for field (``assert_caches_equal``; the euler and facial
    statistics bit for bit); (2) ``cli train`` one epoch on the built
    cache with a HuBERT-large cache (one step of 696 windows); (3) ``cli
    eval`` of the trained checkpoint with a reference-layout FGD
    checkpoint (the FGD net on the card against the CPU, ``fgd_on_card``);
    (4) ``cli test-stream`` over the test split with the exporter, a
    template BVH, players and FGD (every file checked), clip 0 again
    (``--max-clips 1``) bit for bit, and ``--output-gt``.  Exact launch
    counts for every command."""
    import shutil
    import tempfile
    from diffsheg_tpu_torch.data.beat import BeatStats
    from diffsheg_tpu_torch.data.cache import CacheWriter
    no_tf32()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_raw_splits(tmp, 50)
        log(f"data: raw splits written in {time.perf_counter() - t0:.1f} s")
        beat, show = os.path.join(tmp, "beat"), os.path.join(tmp, "show")
        stats, cpu_stats = (os.path.join(tmp, s) for s in ("stats",
                                                            "stats_cpu"))
        caches = {s: os.path.join(tmp, f"cache_{s}") for s in
                  ("train", "val", "test", "train_cpu", "show", "show_cpu")}

        # (1) caches on the card, and again on the CPU
        n = {}
        for split in ("train", "val", "test"):
            n[split] = build_split(split, [
                "--device", "cuda", "--data-root", beat, "--split", split,
                "--stats-dir", stats], caches[split])
        n["show"] = build_split("show train", [
            "--device", "cuda", "--dataset", "show", "--data-root", show,
            "--stats-dir", os.path.join(tmp, "show_stats")], caches["show"])
        want = {"train": DATA_TRAIN_WINDOWS,
                "val": DATA_CLIPS["val"] * DATA_WINDOWS,
                "test": DATA_CLIPS["test"],
                "show": DATA_SHOW_SEQS * DATA_SHOW_WINDOWS}
        if n != want:
            raise AssertionError(f"cache sizes {n}, expected {want}")
        build_split("train, cpu", ["--device", "cpu", "--data-root", beat,
                                   "--split", "train", "--stats-dir",
                                   cpu_stats], caches["train_cpu"])
        build_split("show train, cpu", [
            "--device", "cpu", "--dataset", "show", "--data-root", show],
            caches["show_cpu"])
        st, st_cpu = BeatStats.load(stats), BeatStats.load(cpu_stats)
        for f in ("mean_pose", "std_pose", "mean_facial", "std_facial"):
            if not np.array_equal(getattr(st, f), getattr(st_cpu, f)):
                raise AssertionError(f"statistics {f} differ")
        aa_err = max(float(np.abs(getattr(st, f) - getattr(st_cpu, f)).max())
                     for f in ("mean_axis_angle", "std_axis_angle"))
        log(f"data[statistics]: card against CPU: euler pose and facial "
            f"bit for bit, axis-angle max |diff| {aa_err:.3e} (tol 1e-6)")
        if not aa_err <= 1e-6:
            raise AssertionError(f"axis-angle statistics: {aa_err:.3e}")
        assert_caches_equal("beat train, card against CPU", caches["train"],
                            caches["train_cpu"], st, st_cpu)
        assert_caches_equal("show train, card against CPU", caches["show"],
                            caches["show_cpu"])
        for k in ("train_cpu", "show", "show_cpu"):
            shutil.rmtree(caches[k])

        # (2) one epoch of cli train on the built cache, HuBERT-large cache
        hcache = os.path.join(tmp, "hubert")
        w = CacheWriter(hcache)
        hub = np.random.default_rng(51).standard_normal(
            (DATA_TRAIN_WINDOWS, 34, 1024), dtype=np.float32) * 0.5
        for i in range(DATA_TRAIN_WINDOWS):
            w.add({"hubert": hub[i]})
        w.finalize()
        work = os.path.join(tmp, "run")
        with TrainRecorder() as rec:
            _, secs, counts, shapes = cli_call([
                "train", "--device", "cuda", "--workdir", work,
                "--train-cache", caches["train"], "--hubert-cache", hcache,
                "--stats-dir", stats, "--epochs", "1",
                "--set", "train.log_every=1"])
        # without remat (the default): 16 self-attentions forward, the
        # audio encoder once
        expect("data train", counts, fused_linear_attention=17,
               gemm=train_gemm(DATA_TRAIN_WINDOWS, remat=False))
        attn = shapes["fused_linear_attention"]
        check_attention_shapes("data train", attn, {
            DATA_TRAIN_ATTN: 16, DATA_TRAIN_AUDIO_ATTN: 1})
        (ms, terms), = rec.steps
        log(f"data[train]: 1 step of {DATA_TRAIN_WINDOWS} windows, {ms:.1f} "
            f"ms, command {secs:.1f} s; " + " ".join(
                f"{k}={v:.6g}" for k, v in terms.items()))
        if not all(np.isfinite(float(v)) for v in terms.values()):
            raise AssertionError(f"data train: loss {terms}")
        launches["fused_linear_attention_data_train"] = attn[DATA_TRAIN_ATTN]
        launches["fused_linear_attention_data_train_audio_enc"] = attn[
            DATA_TRAIN_AUDIO_ATTN]

        # (3) cli eval with the reference-layout FGD checkpoint
        fgd = fgd_reference_file(os.path.join(tmp, "ae_300.bin"), 52)
        fgd_on_card(fgd, dev, reps)
        ckpt = os.path.join(work, "ckpt")
        lines, secs, counts, shapes = cli_call([
            "eval", "--device", "cuda", "--val-cache", caches["val"],
            "--checkpoint", ckpt, "--fgd-checkpoint", fgd,
            "--stats-dir", stats])
        expect("data eval", counts, fused_layer=DATA_EVAL_LAYER,
               fused_linear_attention=DATA_EVAL_BATCHES,
               gemm=times(cache_gemm(beat_structure(), 32, 34, 32),
                          DATA_EVAL_BATCHES))
        check_attention_shapes("data eval", shapes["fused_linear_attention"],
                               {DATA_EVAL_AUDIO_ATTN: DATA_EVAL_BATCHES})
        check_layer_shapes("data eval", shapes["fused_layer"],
                           {DATA_EVAL_LAYER_7: DATA_EVAL_LAYER * 4 // 5,
                            DATA_EVAL_LAYER_4: DATA_EVAL_LAYER // 5})
        res = printed_json(lines)
        log(f"data[eval]: {DATA_EVAL_BATCHES} batches of 32 windows in "
            f"{secs:.2f} s: " + json.dumps(res))
        if not all(np.isfinite(v) for v in res.values()):
            raise AssertionError(f"data eval: {res}")
        launches["fused_layer_data_eval"] = shapes["fused_layer"][
            DATA_EVAL_LAYER_7]
        launches["fused_layer_data_eval_b4"] = shapes["fused_layer"][
            DATA_EVAL_LAYER_4]
        launches["fused_linear_attention_data_eval_audio_enc"] = shapes[
            "fused_linear_attention"][DATA_EVAL_AUDIO_ATTN]

        # (4) cli test-stream over the whole test clips
        tmpl = beat_template(os.path.join(tmp, "template.bvh"))
        clips, frames = DATA_CLIPS["test"], DATA_TEST_SECS * 15
        common = ["test-stream", "--device", "cuda", "--test-cache",
                  caches["test"], "--checkpoint", ckpt, "--stats-dir", stats,
                  "--template-bvh", tmpl, "--player", "--fgd-checkpoint", fgd]
        out = os.path.join(tmp, "stream")
        lines, secs, counts, shapes = cli_call(common + ["--out-dir", out])
        calls, wins = clips * DATA_STREAM_CALLS, clips * DATA_STREAM_WINDOWS
        expect("data test-stream", counts, fused_layer=16 * calls,
               fused_linear_attention=wins)
        check_attention_shapes("data test-stream",
                               shapes["fused_linear_attention"],
                               {STREAM_AUDIO_ATTN: wins})
        check_layer_shapes("data test-stream", shapes["fused_layer"],
                           {STREAM_LAYER: 16 * calls})
        res = printed_json(lines)
        log(f"data[test-stream]: {clips} clips of {frames} frames in "
            f"{secs:.2f} s ({calls} model calls, launches {counts}): "
            + json.dumps(res))
        if not (res["clips"] == clips and all(
                np.isfinite(res[k]) for k in ("mse", "pck", "beat_align",
                                              "srgr", "fgd", "fps"))):
            raise AssertionError(f"data test-stream: {res}")
        check_stream_files(out, clips, frames)
        launches["fused_layer_test_stream"] = shapes["fused_layer"][
            STREAM_LAYER]
        launches["fused_linear_attention_test_stream_audio_enc"] = shapes[
            "fused_linear_attention"][STREAM_AUDIO_ATTN]
        again = os.path.join(tmp, "again")
        _, secs, counts, _ = cli_call(common + ["--out-dir", again,
                                                "--max-clips", "1"])
        expect("data test-stream clip 0", counts,
               fused_layer=16 * DATA_STREAM_CALLS,
               fused_linear_attention=DATA_STREAM_WINDOWS)
        if os.path.exists(os.path.join(again, "clip_00001.npy")):
            raise AssertionError("test-stream --max-clips 1 wrote clip 1")
        same = np.array_equal(np.load(os.path.join(again, "clip_00000.npy")),
                              np.load(os.path.join(out, "clip_00000.npy")))
        log(f"data[test-stream clip 0 alone]: {secs:.2f} s, bit for bit "
            f"equal to clip 0 of {clips} {same}")
        if not same:
            raise AssertionError("test-stream clip 0 alone differs from "
                                 "clip 0 of the run over several clips")
        gt = os.path.join(tmp, "gt")
        lines, secs, counts, _ = cli_call(common + ["--out-dir", gt,
                                                    "--output-gt"])
        expect("data test-stream --output-gt", counts)
        res = printed_json(lines)
        log(f"data[test-stream --output-gt]: {secs:.2f} s: "
            + json.dumps(res))
        if res["mse"] != 0.0 or res["pck"] != 1.0:
            raise AssertionError(f"--output-gt: {res}")
        check_stream_files(gt + "_GT", clips, frames)
    log(f"data: phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# --------------------------------------------------------------------------
# phase 12: scale — the speech frontend in the step, several processes
# --------------------------------------------------------------------------

SCALE_BATCH = 256
# the frontend's encoder on the card against the CPU: 2260 rows, enough
# for every product of the encoder to take gemm_tf32x3 (the feature
# projection's 512 -> 1024 from 2048 rows)
FRONTEND_CPU_WINDOWS = 20
SCALE_CLIPS = {"train": 3, "val": 1}        # 261 and 87 windows
SCALE_ATTN = (SCALE_BATCH, 34, 512, 8)
SCALE_AUDIO_ATTN = (SCALE_BATCH, 34, 128, 8)
DP_ATTN = (SCALE_BATCH // 2, 34, 512, 8)    # each of 2 processes' rows
DP_AUDIO_ATTN = (SCALE_BATCH // 2, 34, 128, 8)
SCALE_TESTSET_CLIPS = 2


def hf_hubert_dir(path, seed):
    """A local HF checkpoint (``pytorch_model.bin``) of HuBERT-large with
    seeded random weights; returns (its directory, the model on the
    CPU)."""
    from diffsheg_tpu_torch.compat.hubert_ckpt import hf_state_dict
    from diffsheg_tpu_torch.models.factory import random_init_
    from diffsheg_tpu_torch.models.hubert import HubertConfig, HubertModel
    model = random_init_(HubertModel(HubertConfig()), seed)
    os.makedirs(path)
    torch.save(hf_state_dict(model), os.path.join(path, "pytorch_model.bin"))
    return path, model


class FrontendRecorder:
    """Times the speech frontend a trainer builds (device-synchronised)
    while ``cli train`` runs in this process."""

    def __init__(self):
        import diffsheg_tpu_torch.audio.frontend as frontend_mod
        self.mod, self.ms = frontend_mod, []

    def __enter__(self):
        make = self.saved = self.mod.make_speech_frontend

        def timed_make(*a, **k):
            fe = make(*a, **k)

            def frontend(batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fe(batch)
                torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return frontend
        self.mod.make_speech_frontend = timed_make
        return self

    def __exit__(self, *exc):
        self.mod.make_speech_frontend = self.saved


def lockstep_band(what, got, want, exact=False):
    """Loss of each step, the parameters' L1 norm and the BatchNorm
    statistics' sums of a run against another: equal, or within rtol 2e-5
    / atol 1e-6; returns the largest relative difference."""
    worst = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
                for k in want)
    ok = all(got[k] == want[k] if exact else
             abs(got[k] - want[k]) <= 1e-6 + 2e-5 * abs(want[k])
             for k in want)
    log(f"scale[{what}]: largest relative difference {worst:.3e} "
        f"({'bit for bit' if worst == 0 else 'not bit for bit'}; "
        f"{'required equal' if exact else 'band rtol 2e-5 / atol 1e-6'})")
    if not ok:
        raise AssertionError(f"scale {what}: {got} against {want}")
    return worst


def frontend_train(tmp, caches, stats, hub_dir):
    """(a) ``cli train`` with the speech frontend in the step: 2 epochs of
    one 256-window step; returns the linear-attention launches by
    shape."""
    work = os.path.join(tmp, "run")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with TrainRecorder() as rec, FrontendRecorder() as fe:
        _, secs, counts, shapes = cli_call([
            "train", "--device", "cuda", "--workdir", work, "--train-cache",
            caches["train"], "--stats-dir", stats, "--hubert-checkpoint",
            hub_dir, "--epochs", "2", "--set",
            "train.on_device_frontend=true", "--set",
            f"train.batch_size={SCALE_BATCH}", "--set", "train.log_every=1"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # without remat (cli train's default) a step's forward makes the 16
    # self-attentions of the branches and the audio encoder's one
    expect("scale train", counts, fused_linear_attention=34,
           gemm=plus(train_gemm(SCALE_BATCH, 2, remat=False),
                     frontend_gemm(SCALE_BATCH, 2)))
    check_attention_shapes("scale train", shapes["fused_linear_attention"],
                           {SCALE_ATTN: 32, SCALE_AUDIO_ATTN: 2})
    if len(rec.steps) != 2 or len(fe.ms) != 2:
        raise AssertionError(f"scale train: {len(rec.steps)} steps, "
                             f"{len(fe.ms)} frontend calls")
    for i, ((m, terms), f) in enumerate(zip(rec.steps, fe.ms)):
        log(f"scale[train step {i}]: frontend {f:.1f} ms + step {m:.1f} ms "
            + " ".join(f"{k}={v:.6g}" for k, v in terms.items()))
        if not all(np.isfinite(float(v)) for v in terms.values()):
            raise AssertionError(f"scale train step {i}: {terms}")
    log(f"scale[train]: 2 steps of {SCALE_BATCH} windows in {secs:.1f} s "
        f"of command; second step: frontend {fe.ms[1]:.1f} ms + step "
        f"{rec.steps[1][0]:.1f} ms = {fe.ms[1] + rec.steps[1][0]:.1f} ms "
        f"({SCALE_BATCH / (fe.ms[1] + rec.steps[1][0]) * 1e3:.1f} "
        f"windows/s); loader {statistics.median(rec.loads):.1f} ms a batch; "
        f"peak memory {peak:.2f} GiB; launches {shapes}")
    return shapes["fused_linear_attention"]


def frontend_checks(caches, hub_model, dev):
    """The frontend on the card: its mel against the cache's (built from
    the same audio), its HuBERT against the same encoder on the CPU
    (FRONTEND_CPU_WINDOWS windows, the card's products through
    gemm_tf32x3), the mel / HuBERT split of its time, and the
    linear-attention kernel against its plain version inside a step with
    it."""
    import copy
    from diffsheg_tpu_torch.audio.frontend import make_speech_frontend
    from diffsheg_tpu_torch.config import beat_config
    from diffsheg_tpu_torch.data.cache import ArrayCache
    cfg = beat_config()
    mel_cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    add_hubert=False))
    cache, rows = ArrayCache(caches["train"]), np.arange(SCALE_BATCH)
    audio = torch.from_numpy(cache.gather("audio", rows)).to(dev)
    cached_mel = torch.from_numpy(cache.gather("mel", rows))
    motion = torch.zeros(SCALE_BATCH, 34, 1, device=dev)
    mel_fe = make_speech_frontend(mel_cfg, device=dev)
    full_fe = make_speech_frontend(cfg, copy.deepcopy(hub_model), device=dev)
    mel = mel_fe({"wave16": audio, "motion": motion})["mel"].cpu()
    mel_err = float((mel - cached_mel).abs().max() / cached_mel.abs().max())

    # the int16 transport of the trainer's batches
    wave16 = torch.clamp(audio * 32768.0, -32768, 32767).to(torch.int16)
    n = FRONTEND_CPU_WINDOWS
    cpu_fe = make_speech_frontend(cfg, hub_model, device="cpu")
    t0 = time.perf_counter()
    want = cpu_fe({"wave16": wave16[:n].cpu(),
                   "motion": motion[:n].cpu()})["hubert"]
    cpu_s = time.perf_counter() - t0
    zero_counts()
    got = full_fe({"wave16": wave16[:n], "motion": motion[:n]})["hubert"]
    expect("scale frontend against the CPU", launch_counts(),
           gemm=frontend_gemm(n))
    hub_err = rel_rms(got.cpu(), want)
    mel_ms = wall_ms(lambda: mel_fe({"wave16": wave16, "motion": motion}), 3)
    full_ms = wall_ms(lambda: full_fe({"wave16": wave16, "motion": motion}),
                      3)
    log(f"scale[frontend]: mel against the cache's max |diff| / max "
        f"{mel_err:.3e} (tol 2e-5); HuBERT-large on the card against the "
        f"CPU, {n} windows: rel_rms {hub_err:.3e} (tol 1e-5; the CPU took "
        f"{cpu_s:.1f} s); {SCALE_BATCH} windows: mel {mel_ms:.1f} ms, "
        f"HuBERT {full_ms - mel_ms:.1f} ms (frontend {full_ms:.1f} ms)")
    if not (mel_err <= 2e-5 and hub_err <= 1e-5):
        raise AssertionError(f"frontend: mel {mel_err:.3e}, HuBERT "
                             f"{hub_err:.3e}")

    gen = torch.Generator().manual_seed(62)
    batch = {"motion": torch.randn(SCALE_BATCH, 34, 192, generator=gen),
             "pid": torch.nn.functional.one_hot(
                 torch.arange(SCALE_BATCH) % 30, 30).float(),
             "sem": torch.rand(SCALE_BATCH, 34, generator=gen)}
    batch = {k: v.to(dev) for k, v in batch.items()}
    batch["wave16"] = wave16
    ts = [torch.randint(0, 1000, (SCALE_BATCH,), generator=gen).to(dev)]
    noises = [torch.randn(SCALE_BATCH, 34, 192, generator=gen).to(dev)]
    zero_counts()
    k_terms, k_params = injected_steps(cfg, batch, ts, noises, dev,
                                       frontend=full_fe)
    with_frontend = plus(train_gemm(SCALE_BATCH, remat=False),
                         frontend_gemm(SCALE_BATCH))
    expect("scale step with the frontend, kernel",
           launch_counts(), gemm=with_frontend, fused_linear_attention=17)
    zero_counts()
    p_terms, p_params = injected_steps(cfg, batch, ts, noises, dev,
                                       plain=True, frontend=full_fe)
    expect("scale step with the frontend, plain",
           launch_counts(), gemm=with_frontend)
    train_band("scale: kernel vs plain in a step with the frontend",
               k_terms, p_terms, k_params, p_params, 1e-5)


def frontend_eval(caches, stats, hub_model, dev):
    """(b) ``Trainer.evaluate`` of 64 windows with the speech frontend
    before the generator."""
    import tempfile
    from diffsheg_tpu_torch.config import beat_config
    from diffsheg_tpu_torch.data.beat import BeatDataset, BeatStats
    from diffsheg_tpu_torch.data.loader import ShardedBatchLoader
    from diffsheg_tpu_torch.train.trainer import Trainer
    cfg = beat_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                on_device_frontend=True))
    ds = BeatDataset(caches["val"], BeatStats.load(stats), include_audio=True)
    loader = ShardedBatchLoader(ds, global_batch_size=EVAL_BATCH, prefetch=0)
    with tempfile.TemporaryDirectory() as work:
        tr = Trainer(cfg, work, device=dev, hubert_model=hub_model)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = tr.evaluate(loader, seed=5)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    expect("scale evaluate", launch_counts(),
           gemm=plus(cache_gemm(beat_structure(), EVAL_BATCH, 34, EVAL_BATCH),
                     frontend_gemm(EVAL_BATCH)),
           fused_layer=EVAL_LAYER_LAUNCHES, fused_linear_attention=1)
    check_attention_shapes(
        "scale evaluate",
        counters()["fused_linear_attention"].launches_by_shape,
        {EVAL_AUDIO_ATTN: 1})
    log(f"scale[evaluate, frontend]: {EVAL_BATCH} windows in {secs:.2f} s "
        + " ".join(f"{k}={v:.6g}" for k, v in r.as_dict().items()))
    if not all(np.isfinite(v) for v in (r.mse, r.pck, r.pck2, r.diversity)):
        raise AssertionError(f"scale evaluate: {r}")


def parallel_runs(tmp, dev):
    """(c) the data-parallel step: one process alone, then in an NCCL
    group of one through the data-parallel and the FSDP path, then 2
    processes sharing the card over gloo; (d) the test-set stream over
    the 2 processes against one.  Returns the launches."""
    import socket
    from diffsheg_tpu_torch.parallel import mp_lockstep as mp
    cfg, batch, frames = mp.beat_payload()
    lock = dict(cfg=cfg, device="cuda", global_batch=batch, frames=frames)
    launches = {"fused_linear_attention_scale_world1": 0,
                "fused_linear_attention_scale_world1_audio_enc": 0}

    def run(tag, **kw):
        zero_counts()
        t0 = time.perf_counter()
        out = mp.compute_lockstep(**lock, **kw)
        torch.cuda.synchronize()
        expect(f"scale {tag}", launch_counts(),
               gemm=train_gemm(batch, 3, remat=False),
               fused_linear_attention=51)
        by_shape = counters()["fused_linear_attention"].launches_by_shape
        check_attention_shapes(f"scale {tag}", by_shape,
                               {SCALE_ATTN: 48, SCALE_AUDIO_ATTN: 3})
        launches["fused_linear_attention_scale_world1"] += by_shape[
            SCALE_ATTN]
        launches["fused_linear_attention_scale_world1_audio_enc"] += by_shape[
            SCALE_AUDIO_ATTN]
        log(f"scale[{tag}]: 3 steps of {batch} windows in "
            f"{time.perf_counter() - t0:.1f} s: " + json.dumps(out))
        return out

    alone = run("one process")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        lockstep_band("world 1 under NCCL, data-parallel path, against one "
                      "process", run("NCCL world 1, data-parallel"), alone,
                      exact=True)
        lockstep_band("world 1 under NCCL, FSDP on a 1-D mesh of one, "
                      "against one process",
                      run("NCCL world 1, FSDP", fsdp=True), alone)
    finally:
        torch.distributed.destroy_process_group()

    t0 = time.perf_counter()
    workers = mp.spawn_workers(2, 300.0, [
        "--device", "cuda", "--beat", "--testset-dir",
        os.path.join(tmp, "testset_2"), "--testset-clips",
        str(SCALE_TESTSET_CLIPS)])
    secs = time.perf_counter() - t0
    mp.check_workers(workers, 2)
    for w in workers:
        got = w["launches"]
        if (got["gemm_tf32x3_by_shape"] != {
                "x".join(map(str, k)): v for k, v in
                train_gemm(batch // 2, 3, remat=False).items()}
                or got["fused_linear_attention"] != 51 or got[
                "fused_linear_attention_by_shape"] != {
                    "x".join(map(str, DP_ATTN)): 48,
                    "x".join(map(str, DP_AUDIO_ATTN)): 3}
                or any(got[n] for n in ("fused_layer", "fused_branch",
                                        "fused_ddim_repaint_step"))):
            raise AssertionError(f"scale 2 processes: launches {got}")
    lockstep_band("2 processes over gloo on one card, ranks",
                  workers[1], {k: workers[0][k] for k in alone}, exact=True)
    lockstep_band("2 processes over gloo on one card against one process",
                  workers[0], alone)
    log(f"scale[2 processes]: {secs:.1f} s for both (start, collectives, "
        f"3 steps, test-set stream); launches each "
        f"{workers[0]['launches']}")
    for name, shape in (("fused_linear_attention_scale_dp", DP_ATTN),
                        ("fused_linear_attention_scale_dp_audio_enc",
                         DP_AUDIO_ATTN)):
        launches[name] = sum(
            w["launches"]["fused_linear_attention_by_shape"][
                "x".join(map(str, shape))] for w in workers)

    zero_counts()
    single = mp.verify_testset(workers, 2, os.path.join(tmp, "testset_1"),
                               clips=SCALE_TESTSET_CLIPS, device="cuda",
                               full_width=True)
    one = launch_counts()
    shapes = {n: {"x".join(map(str, k)): v for k, v in
                  counters()[n].launches_by_shape.items()}
              for n in ("fused_layer", "fused_linear_attention")}
    both = {n: sum(w["testset_launches"][n] for w in workers) for n in one}
    if both != one or not one["fused_layer"]:
        raise AssertionError(f"test-set stream: 2 processes launched "
                             f"{both}, one process {one}")
    for n in shapes:
        two = {}
        for w in workers:
            for k, v in w["testset_launches"][f"{n}_by_shape"].items():
                two[k] = two.get(k, 0) + v
        if two != shapes[n]:
            raise AssertionError(f"test-set stream {n}: {two} against "
                                 f"{shapes[n]}")
    log(f"scale[test-set stream, 2 processes against 1]: "
        f"{SCALE_TESTSET_CLIPS} clips, files and clip sums equal, metrics "
        f"{json.dumps(single['testset_metrics'])}; launches {one} "
        f"{shapes}")
    layer, attn = (shapes["fused_layer"], shapes["fused_linear_attention"])
    if set(layer) != {"x".join(map(str, STREAM_LAYER))} or set(attn) != {
            "x".join(map(str, STREAM_AUDIO_ATTN))}:
        raise AssertionError(f"test-set stream shapes: {shapes}")
    launches["fused_layer_scale_testset"] = one["fused_layer"]
    launches["fused_linear_attention_scale_testset_audio_enc"] = one[
        "fused_linear_attention"]
    return launches


def phase_scale(dev):
    """Training with the speech frontend in the step and across processes,
    BEAT at full width, f32, on caches built from raw clips (3 train, 1
    val) and a HuBERT-large HF checkpoint of seeded weights: (a) ``cli
    train --set train.on_device_frontend=true --hubert-checkpoint``, 2
    steps of 256 windows (``frontend_train``), then the frontend's mel and
    HuBERT against the cache and the CPU and the kernel against its plain
    version in a step with it (``frontend_checks``); (b)
    ``Trainer.evaluate`` of 64 windows with it (``frontend_eval``); (c)
    the data-parallel step alone, in an NCCL group of one (bit for bit)
    and FSDP on a mesh of one, and over 2 ``mp_lockstep`` processes
    sharing the card through gloo (ranks bit for bit, rtol 2e-5 / atol
    1e-6 against one process); (d) ``generate_testset`` of 2 clips over
    those 2 processes against one (``parallel_runs``)."""
    import tempfile
    no_tf32()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_raw_splits(tmp, 60, clips=SCALE_CLIPS, show=False)
        beat, stats = os.path.join(tmp, "beat"), os.path.join(tmp, "stats")
        caches = {}
        for split in SCALE_CLIPS:
            caches[split] = os.path.join(tmp, f"cache_{split}")
            build_split(f"scale {split}", [
                "--device", "cuda", "--data-root", beat, "--split", split,
                "--stats-dir", stats], caches[split])
        hub_dir, hub_model = hf_hubert_dir(os.path.join(tmp, "hubert"), 61)
        log(f"scale: raw splits, caches and a seeded HuBERT-large "
            f"checkpoint in {time.perf_counter() - t0:.1f} s")
        shapes = frontend_train(tmp, caches, stats, hub_dir)
        launches["fused_linear_attention_scale_train"] = shapes[SCALE_ATTN]
        launches["fused_linear_attention_scale_train_audio_enc"] = shapes[
            SCALE_AUDIO_ATTN]
        frontend_checks(caches, hub_model, dev)
        frontend_eval(caches, stats, hub_model, dev)
        launches["fused_layer_scale_eval"] = EVAL_LAYER_LAUNCHES
        launches["fused_linear_attention_scale_eval_audio_enc"] = 1
        del hub_model
        launches.update(parallel_runs(tmp, dev))
    log(f"scale: phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# --------------------------------------------------------------------------
# phase 13: the tools (cli doctor, calibration, the bench guards, the data
# plane, the config reference)
# --------------------------------------------------------------------------

# the doctor's environment lines warn by design (informational); every
# other line must be ok
DOCTOR_ENV_LINES = ("CUDA_VISIBLE_DEVICES", "CUDA_HOME")
GUARD_REPS = 3


def captured(fn, *args, **kw):
    """(fn's result or its SystemExit, stdout lines, stderr lines)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            res = fn(*args, **kw)
        except SystemExit as e:
            res = e
    return res, out.getvalue().splitlines(), err.getvalue().splitlines()


def doctor_check():
    """``run_doctor(calibrate=True)`` in-process: rc 0, every line ok, and
    its kernel probe launched each of the four kernels exactly once."""
    from diffsheg_tpu_torch.cli.doctor import KERNELS, run_doctor
    zero_counts()
    t0 = time.perf_counter()
    rc, lines, _ = captured(run_doctor, calibrate=True)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    for ln in lines:
        log(f"doctor: {ln}")
    log(f"doctor: {secs:.1f} s, launches={counts}")
    bad = [ln for ln in lines if not ln.startswith("[ok  ]")
           and ln[7:].split()[0] not in DOCTOR_ENV_LINES]
    if rc != 0 or bad:
        raise AssertionError(f"doctor rc {rc}, lines not ok: {bad}")
    expect("doctor", counts, **dict.fromkeys(KERNELS, 1))
    return {f"{k}_doctor": counts[k] for k in KERNELS}


def guard_controls(calib):
    """The negative controls, which must fire: a CPU calibration without
    ``allow_cpu`` is not ok, and ``build_guarded`` around a program whose
    tensors are on the CPU retries once, then exits 1 with the invalid
    JSON; the profiler and the counters see no kernel of that program."""
    from diffsheg_tpu_torch.utils.benchguard import build_guarded
    from diffsheg_tpu_torch.utils.calibration import (calibrate,
                                                      device_activity)
    res = calibrate(device="cpu", allow_cpu=False)
    if res.ok:
        raise AssertionError("calibrate(device='cpu') without allow_cpu "
                             "passed")
    x = torch.randn(512, 512, generator=torch.Generator().manual_seed(0))
    retries = []
    zero_counts()
    got, out, err = captured(build_guarded, lambda: x, lambda a: a @ a,
                             lambda: retries.append(1), "cpu-control", calib)
    counts = launch_counts()
    for ln in err:
        log(f"guard[cpu program]: {ln}")
    if not isinstance(got, SystemExit) or got.code != 1:
        raise AssertionError(f"build_guarded passed a CPU program ({got!r})")
    invalid = json.loads(out[-1])
    act = device_activity(lambda: x @ x)
    log(f"guard[cpu program]: exit {got.code}, retries {len(retries)}, "
        f"artifact {out[-1]}; profiled {act.line()}")
    if len(retries) != 1 or invalid["valid"] is not False:
        raise AssertionError(f"guard: retries {retries}, artifact {invalid}")
    if act.kernels or act.outputs_on_card:
        raise AssertionError(f"the guard is wrong: the CPU program shows "
                             f"{act.kernels} kernels on the card")
    expect("cpu program", counts)
    log(f"calibration[cpu, allow_cpu=False]: ok={res.ok} ({res.reason})")


def guarded_stream(dev, model, hubert_fe, calib):
    """The 10 s bf16 'auto' pipeline through ``build_guarded`` +
    ``timed_reps``: FPS, host CPU fraction, the profiled device-busy share
    and the launches, exactly."""
    from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
    from diffsheg_tpu_torch.utils.benchguard import build_guarded, timed_reps
    from diffsheg_tpu_torch.utils.calibration import device_activity
    cfg = beat_cfg("bfloat16", "auto")
    a18 = torch.from_numpy(synth(10, 18000)).to(dev)
    a16 = torch.from_numpy(synth(10, 16000)).to(dev)
    pid = torch.nn.functional.one_hot(torch.tensor([1]), 30).float().to(dev)

    def build_and_warm():
        pipe = make_pipeline(cfg, model, hubert_fe, dev)
        drive(pipe, 10, dev, 13)
        return pipe

    def call(pipe):
        return pipe(a18, a16, pid, GeneratorNoise(14, dev))

    pipe, _, err = captured(build_guarded, build_and_warm, call,
                            lambda: None, "tools-auto-10s", calib)
    for ln in err:
        log(f"guard[10 s auto]: {ln}")
    if isinstance(pipe, SystemExit):
        raise AssertionError("build_guarded refused the pipeline on the card")
    act = device_activity(lambda: call(pipe))
    zero_counts()
    totals, frac = timed_reps(lambda i: call(pipe), GUARD_REPS)
    counts = launch_counts()
    expect("guarded stream", counts, fused_layer=GUARD_REPS * 16 * CALLS_10S)
    fps = [10 * cfg.data.fps / t for t in totals]
    log(f"guard[10 s auto]: fps={statistics.median(fps):.1f} "
        f"(reps {', '.join(f'{f:.1f}' for f in fps)}) host_cpu_frac="
        f"{frac:.3f} profiled {act.line()} fused_layer launches "
        f"{counts['fused_layer'] // GUARD_REPS} a stream")
    return counts["fused_layer"] // GUARD_REPS


def dataplane_check(tmp):
    """The native library built on this host; a synthetic 60 s BEAT
    ``bvh_rot`` file parsed natively and by the numpy path, bit for bit;
    2500 random rows of a memory-mapped cache field of phase 10's row
    shape gathered natively (4 threads) and by ``np.take``, bit for bit."""
    from diffsheg_tpu_torch import runtime
    from diffsheg_tpu_torch.data.cache import ArrayCache, CacheWriter
    if not runtime.native_available():
        raise AssertionError("the native data plane did not build")
    rng = np.random.RandomState(0)
    path = os.path.join(tmp, "clip.bvh")
    np.savetxt(path, rng.randn(DATA_SECS * 15, 141) * 25, fmt="%.6f")
    with open(path, "rb") as f:
        text = f.read()
    mb = len(text) / 1e6

    def best(fn, reps=5):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = fn()
            times.append(time.perf_counter() - t0)
        return res, min(times)

    (nat, nat_rows), nat_s = best(lambda: runtime.parse_float_text(text))
    (ref, ref_rows), ref_s = best(lambda: runtime._parse_numpy(text), 2)
    loadtxt, lt_s = best(lambda: np.loadtxt(path), 2)
    if nat_rows != ref_rows or nat.tobytes() != ref.tobytes():
        raise AssertionError("native parse differs from the numpy path")
    if loadtxt.reshape(-1).tobytes() != nat.tobytes():
        raise AssertionError("native parse differs from np.loadtxt")
    log(f"dataplane[parse 60 s bvh_rot, {mb:.2f} MB, {nat_rows} rows]: "
        f"native {mb / nat_s:.1f} MB/s, numpy float() {mb / ref_s:.1f} "
        f"MB/s, np.loadtxt {mb / lt_s:.1f} MB/s (native {ref_s / nat_s:.1f}x "
        f"numpy, {lt_s / nat_s:.1f}x loadtxt); bit for bit")
    w = CacheWriter(os.path.join(tmp, "cache"))
    pose = rng.standard_normal((TRAIN_WINDOWS, 34, 141)).astype(np.float32)
    for row in pose:
        w.add({"pose": row})
    w.finalize()
    cache = ArrayCache(os.path.join(tmp, "cache"))
    arr = cache._arrays["pose"]
    idx = rng.randint(0, TRAIN_WINDOWS, TRAIN_BATCH)
    nat, nat_s = best(lambda: runtime.gather_rows(arr, idx, n_threads=4))
    take, take_s = best(lambda: np.take(arr, idx, axis=0))
    if nat.tobytes() != take.tobytes() or \
            cache.gather("pose", idx).tobytes() != take.tobytes():
        raise AssertionError("native gather differs from np.take")
    log(f"dataplane[gather {TRAIN_BATCH} of {TRAIN_WINDOWS} rows (34, 141) "
        f"f32, memory-mapped, {nat.nbytes / 1e6:.1f} MB]: native 4 threads "
        f"{nat_s * 1e3:.2f} ms, np.take {take_s * 1e3:.2f} ms "
        f"({take_s / nat_s:.2f}x); bit for bit")


def phase_tools(dev, model, hubert_fe):
    """``cli doctor --calibrate`` in-process (``doctor_check``); the
    negative controls of the calibration and the bench guard
    (``guard_controls``); the 10 s bf16 'auto' pipeline through the guard
    (``guarded_stream``); the C++ data plane against numpy
    (``dataplane_check``); ``docs/torch_config.md`` equal to
    ``configdocs.generate()``."""
    import tempfile
    from diffsheg_tpu_torch.utils.benchguard import calibrate_or_exit
    from diffsheg_tpu_torch.utils.configdocs import generate
    t0 = time.perf_counter()
    launches = doctor_check()
    calib, _, err = captured(calibrate_or_exit, "tools-auto-10s")
    for ln in err:
        log(f"tools: {ln}")
    if isinstance(calib, SystemExit):
        raise AssertionError("calibrate_or_exit refused the card")
    guard_controls(calib)
    guarded_stream(dev, model, hubert_fe, calib)
    with tempfile.TemporaryDirectory() as tmp:
        dataplane_check(tmp)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "docs", "torch_config.md")) as f:
        if f.read() != generate():
            raise AssertionError("docs/torch_config.md is stale")
    log("tools: config reference current")
    log(f"tools: phase {time.perf_counter() - t0:.1f} s")
    return launches


# --------------------------------------------------------------------------
# phase 14: the examples (diffsheg_tpu_torch/examples/)
# --------------------------------------------------------------------------

class Tee(io.TextIOBase):
    """Writes to the real stream and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.buf = stream, io.StringIO()

    def write(self, s):
        self.stream.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.stream.flush()


def by_shape():
    """The per-layer kernel's and linear attention's launches by shape."""
    c = counters()
    return (dict(c["fused_layer"].launches_by_shape),
            dict(c["fused_linear_attention"].launches_by_shape))


def run_example(tag, fn, *args, env=None, **kw):
    """One example through its entry point, every launch count set to 0
    just before and read just after; its standard output and error are
    shown and kept.  Returns (stdout, stderr, counts, layer shapes,
    attention shapes, seconds, return value)."""
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    out, err = Tee(sys.stdout), Tee(sys.stderr)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            ret = fn(*args, **kw)
        torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    secs = time.perf_counter() - t0
    counts = launch_counts()
    layers, attns = by_shape()
    return (out.buf.getvalue(), err.buf.getvalue(), counts, layers, attns,
            secs, ret)


def example_line(tag, result, counts, layers, attns, secs, **extra):
    log(f"examples[{tag}]: {json.dumps(result)} seconds={secs:.1f} "
        f"launches={counts} fused_layer_by_shape={layers} "
        f"fused_linear_attention_by_shape={attns}"
        + "".join(f" {k}={v}" for k, v in extra.items()))


def expect_shapes(what, got, want):
    if got != want:
        raise AssertionError(f"{what}: launches by shape {got}, expected "
                             f"{want}")


def stream_calls(cfg, T, W=None):
    """Model calls of a stream of T frames in windows of W (the config's
    by default): the first window on the plain program, the rest on the
    harmonize program, as the window generator builds them."""
    from diffsheg_tpu_torch.diffusion.jump import (jump_schedule_ddim,
                                                   make_step_program)
    from diffsheg_tpu_torch.sampling.streamer import window_starts
    d = cfg.diffusion
    W = W or cfg.data.n_poses
    ov = (cfg.stream.overlap_len if W == cfg.data.n_poses
          else min(cfg.stream.overlap_len, W // 2))
    n = int(d.respacing.replace("ddim", ""))
    jl, jns = (1, 1) if d.no_resample else (d.jump_length, d.jump_n_sample)
    repaint = (n if cfg.stream.no_repaint else make_step_program(
        jump_schedule_ddim(n, jl, jns)).num_model_calls)
    return n + (len(window_starts(T, W, W - ov)) - 1) * repaint


EXAMPLE_ATTENTION_CASES = (
    # (name, dtype, B, T, D, heads): convergence's training rows and its
    # audio encoder, the evaluation's level cache; overfit's training rows
    # (the audio encoder has the same shape) and a window's level cache;
    # perf_probe's bf16 variant with the kernel forced (10 s level cache)
    ("conv-train-f32", torch.float32, 32, 12, 32, 4),
    ("conv-audio-enc-f32", torch.float32, 32, 12, 16, 4),
    ("conv-eval-audio-enc-f32", torch.float32, 640, 12, 16, 4),
    ("overfit-train-f32", torch.float32, 32, 34, 128, 4),
    ("overfit-audio-enc-f32", torch.float32, 25, 34, 128, 4),
    ("audio-enc-10s-bf16", torch.bfloat16, 125, 34, 128, 8))

# (name, B, T, dtype, L, heads, F, Cp, c_real): convergence's evaluation
# (64 windows of 12 frames in launches of 21 windows, and the last one;
# its gesture branch), overfit's sampling (gesture branch), batch_probe's
# 8 styles (7 + 1 windows of 34 frames a launch)
EXAMPLE_LAYER_CASES = (
    ("layer-conv-f32", 21, 12, torch.float32, 32, 4, 64, 128, 52),
    ("layer-conv-b1-f32", 1, 12, torch.float32, 32, 4, 64, 128, 52),
    ("layer-overfit-f32", 1, 34, torch.float32, 128, 4, 256, 512, 435),
    ("layer-b7-bf16", 7, 34, torch.bfloat16, 512, 8, 1024, 1024, 947))


def example_layer_case(name, B, T, dtype, L, H, F, Cp, c_real, dev, seed,
                       reps):
    """``fused_layer`` alone at an example's shape and widths."""
    x, cond, mods, slp, _, _, _ = case_inputs(
        dtype, B, T, Cp, c_real, False, dev, seed, L=L, H=H, F=F,
        n_layers=1)
    w_bytes = sum(t.numel() * t.element_size() for t in slp)
    out = {"fused_layer": layer_result(x, cond, mods, slp, H, c_real, None,
                                       None, None, reps, w_bytes,
                                       layer_ops(B, T, Cp, L, H, F))}
    check_lines(name, out, 1e-5 if dtype == torch.float32 else 8e-3)
    return out


def example_kernel_cases(dev, reps):
    results = {}
    for name, dt, B, T, D, H in EXAMPLE_ATTENTION_CASES:
        results[f"attn-{name}"] = attention_case(name, dt, B, T, D, 0, H,
                                                 dev, 17, reps)
    for name, B, T, dt, L, H, F, Cp, c_real in EXAMPLE_LAYER_CASES:
        results[name] = example_layer_case(name, B, T, dt, L, H, F, Cp,
                                           c_real, dev, 18, reps)
    return results


def example_convergence(tmp, full):
    """Item 1: Trainer.fit with the mid-run resume; the linear-attention
    kernel in every step, the per-layer kernel in every evaluation."""
    from diffsheg_tpu_torch.examples import convergence_demo as ex
    from diffsheg_tpu_torch.ops.fused_layer import _batch_groups
    epochs = 240 if full else 40
    curve_out = os.path.join(tmp, "convergence.json")
    out, _, counts, layers, attns, secs, _ = run_example(
        "convergence", ex.main, [str(epochs), "--workdir",
                                 os.path.join(tmp, "conv"), "--curve-out",
                                 curve_out])
    curve = json.load(open(curve_out))["curve"]
    cfg = ex.make_config()
    m, B, T = cfg.model, cfg.train.batch_size, cfg.data.n_poses
    steps, evals = epochs * (256 // B), epochs // cfg.train.eval_every_epochs
    n_val, levels = 64, int(cfg.diffusion.respacing.replace("ddim", ""))
    # the joint audio encoder is one layer of audio_dim's width
    want_attn = {(B, T, m.latent_dim, m.num_heads): 2 * m.num_layers * steps,
                 (B, T, m.audio_dim, m.num_heads): steps,
                 (levels * n_val, T, m.audio_dim, m.num_heads): evals}
    want_layer = {}
    for g in _batch_groups(n_val, T):
        shape = (g.stop - g.start, T, m.latent_dim)
        want_layer[shape] = want_layer.get(shape, 0) + (
            evals * levels * 2 * m.num_layers)
    expect_shapes("convergence attention", attns, want_attn)
    expect_shapes("convergence per-layer", layers, want_layer)
    expect("convergence", counts,
           fused_linear_attention=sum(want_attn.values()),
           fused_layer=sum(want_layer.values()))
    mse = [r["val_mse"] for r in curve]
    summary = json_lines_of(out)[-1]
    if not (len(curve) == evals and mse[-1] < mse[0]
            and all(np.isfinite(mse))):
        raise AssertionError(f"convergence: val_mse {mse}")
    example_line("convergence", summary, counts, layers, attns, secs,
                 val_mse=f"{mse[0]:.4g}->{mse[-1]:.4g}",
                 val_pck2=f"{curve[0]['val_pck2']:.4f}->"
                 f"{curve[-1]['val_pck2']:.4f}")
    if full:
        import shutil
        shutil.copy(curve_out, ex.CURVE)
    return {"fused_linear_attention_examples_convergence":
            want_attn[(B, T, m.latent_dim, m.num_heads)],
            "fused_layer_examples_convergence": sum(want_layer.values())}


def json_lines_of(text):
    return [json.loads(s) for s in text.splitlines() if s.startswith("{")]


def example_overfit(full):
    """Item 2: the train step on one window, then DDIM-25 of 3 seeds."""
    from diffsheg_tpu_torch.examples import overfit_demo as ex
    steps = 24000 if full else 300
    out, _, counts, layers, attns, secs, rc = run_example(
        "overfit", ex.main, ["--steps", str(steps)])
    cfg = ex.make_config()
    m, T = cfg.model, cfg.data.n_poses
    levels = int(cfg.diffusion.respacing.replace("ddim", ""))
    # a step: both branches' layers and the audio encoder's at the rows;
    # a window: its level cache, then every model call's layers
    want_attn = {(32, T, m.latent_dim, m.num_heads): (
        2 * m.num_layers + 1) * steps,
        (levels, T, m.audio_dim, m.num_heads): 3}
    want_layer = {(1, T, m.latent_dim): 3 * levels * 2 * m.num_layers}
    expect_shapes("overfit attention", attns, want_attn)
    expect_shapes("overfit per-layer", layers, want_layer)
    expect("overfit", counts, fused_linear_attention=sum(want_attn.values()),
           fused_layer=sum(want_layer.values()))
    last = out.strip().splitlines()[-1]
    ratio = float(last.split()[2])
    if not np.isfinite(ratio):
        raise AssertionError(f"overfit: {last}")
    example_line("overfit", {"normalized_error": ratio, "steps": steps,
                             "learned": rc == 0}, counts, layers, attns, secs)
    return {"fused_linear_attention_examples_overfit":
            want_attn[(32, T, m.latent_dim, m.num_heads)],
            "fused_layer_examples_overfit": sum(want_layer.values())}


def example_capacity(dev, full):
    """Item 3: the serving daemon with N paced clients (rows 1, 4 for 8 s;
    full: the JAX defaults for 16 s, and 2 and 3 sessions between); full
    also profiles one more row at the largest N that kept real time."""
    from diffsheg_tpu_torch.examples import serve_capacity as ex
    secs, sizes = (16, "1,2,3,4,8,16") if full else (8, "1,4")
    out, _, counts, layers, attns, t, _ = run_example(
        "capacity", ex.main, ["--secs", str(secs), "--sessions", sizes])
    cfg = ex.make_config()
    sessions = 1 + sum(int(s) for s in sizes.split(","))
    calls = stream_calls(cfg, secs * cfg.data.fps)
    want = {(1, cfg.data.n_poses, cfg.model.latent_dim):
            sessions * calls * 2 * cfg.model.num_layers}
    expect_shapes("capacity per-layer", layers, want)
    expect("capacity", counts, fused_layer=sum(want.values()))
    rows = json_lines_of(out)
    if len(rows) != 1 + len(sizes.split(",")):
        raise AssertionError(f"capacity rows: {rows}")
    ok = [r for r in rows[1:] if r["rt_ok"]]
    extra = {}
    if ok and full:
        extra = capacity_idle(dev, cfg, max(r["sessions"] for r in ok), secs)
    example_line("capacity", rows[1:], counts, layers, attns, t, **extra)
    return {"fused_layer_examples_capacity": sum(want.values())}


def capacity_idle(dev, cfg, n, secs):
    """One more row of ``n`` sessions on a fresh server under
    torch.profiler: the card's busy share of the row's wall (the union of
    its kernels' intervals, after uncounted spin kernels; calibration.py
    says why)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffsheg_tpu_torch.examples import serve_capacity as ex
    from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
    from diffsheg_tpu_torch.serving.server import MotionServer
    from diffsheg_tpu_torch.utils.calibration import (PROFILE_PAD_KERNELS,
                                                      _busy_seconds)
    srv = MotionServer(cfg, init_unidiffuser(cfg.model, seed=0),
                       max_sessions=n + 1, log=lambda *a, **k: None,
                       device=dev)
    srv.start_background()
    try:
        ex.run_row(1, 2, 0.1, srv.address[1], cfg.data.mel_sr,
                   cfg.model.style_dim)          # the weights to the card
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD_KERNELS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            row = ex.run_row(n, secs, 0.1, srv.address[1], cfg.data.mel_sr,
                             cfg.model.style_dim)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        srv.shutdown()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))
               and "spin_kernel" not in e.name]
    busy = _busy_seconds((e.time_range.start, e.time_range.end)
                         for e in kernels)
    return {"profiled_sessions": n, "profiled_rt_factor": row["rt_factor"],
            "device_idle_pct": round(100 * (1 - busy / wall), 1),
            "profiled_kernels": len(kernels)}


SHOW_BENCH_SECS = 15


def example_show(full):
    """Item 4: the SHOW bench through its guards, with the step kernel
    (its configuration with ``fused_step='on'``); full: also the JAX
    configuration ('auto')."""
    from diffsheg_tpu_torch.examples import show_bench as ex
    default, default_secs = ex.make_config, ex.SECS
    # its stream: the script's 60 s with --full, else 15
    stream_secs = default_secs if full else SHOW_BENCH_SECS
    res = {}
    for step in (("on", "auto") if full else ("on",)):
        ex.make_config = lambda jn=2, step=step: default(jn).replace(
            diffusion=dataclasses.replace(default(jn).diffusion,
                                          fused_step=step))
        ex.SECS = stream_secs
        try:
            out, err, counts, layers, attns, secs, _ = run_example(
                f"show-{step}", ex.main, [])
            cfg = ex.make_config()
        finally:
            ex.make_config, ex.SECS = default, default_secs
        calls = stream_calls(cfg, stream_secs * cfg.data.fps)
        # warm-up, the guard's probe (two calls), 6 timed, 1 to read
        n_calls = 10
        want = dict(fused_branch=n_calls * 2 * calls)
        if step == "on":
            want["fused_ddim_repaint_step"] = n_calls * calls
        expect(f"show_bench fused_step={step}", counts, **want)
        record = json_lines_of(out)[-1]
        if not record.get("valid") or record["value"] <= 0:
            raise AssertionError(f"show_bench: {record}")
        example_line(f"show-{step}", record, counts, layers, attns, secs,
                     stderr=err.strip().splitlines()[-1])
        res[step] = counts
    return {"fused_branch_examples_show": res["on"]["fused_branch"],
            "fused_ddim_repaint_step_examples_show":
            res["on"]["fused_ddim_repaint_step"]}


def example_train_bench(full):
    """Item 5: one row of the ladder (batch 256, f32); full: also 2500 in
    bf16, the pipelined and the speech-frontend points."""
    from diffsheg_tpu_torch.examples import train_bench as ex
    runs = [([], {})]
    if full:
        runs += [(["2500", "bf16"], {}), ([], {"TRAIN_BENCH_PIPELINE": "1"}),
                 ([], {"TRAIN_BENCH_FRONTEND": "256"})]
    launches = None
    for argv, env in runs:
        out, err, counts, layers, attns, secs, _ = run_example(
            "train_bench", ex.main, argv, env=env)
        rows = json_lines_of(out)
        if not rows or rows[-1].get("valid") is False:
            raise AssertionError(f"train_bench {argv} {env}: {rows}")
        if not argv and not env:
            # steps: the first, the counted one, device_activity's two, 8
            # timed; 16 branch-layer forwards and 1 audio encoder a step
            want = {(256, 34, 512, 8): 12 * 16, (256, 34, 128, 8): 12}
            expect_shapes("train_bench attention", attns, want)
            expect("train_bench", counts,
                   gemm=train_gemm(256, 12, remat=False),
                   fused_linear_attention=sum(want.values()))
            launches = want[(256, 34, 512, 8)]
        # the bf16 rows run the composition (bf16 attention inputs): a
        # measurement of the ladder, no kernel path
        example_line("train_bench", rows, counts, layers, attns, secs,
                     stderr=err.strip().splitlines()[-1])
    return {"fused_linear_attention_examples_train_bench": launches}


def example_batch(full):
    """Item 6: B styles of one audio through FusedPipeline ('auto', bf16;
    B 8 on a 10 s stream; full: B 8 and 64 on 60 s)."""
    from diffsheg_tpu_torch.examples import batch_probe as ex
    from diffsheg_tpu_torch.ops.fused_layer import _batch_groups
    default = ex.SECS
    secs = default if full else 10
    ex.SECS = secs
    total = 0
    try:
        for B in ((8, 64) if full else (8,)):
            out, _, counts, layers, attns, t, _ = run_example(
                f"batch-{B}", ex.main, [str(B)])
            cfg = ex.make_config()
            calls = stream_calls(cfg, secs * cfg.data.fps)
            want = {}
            for g in _batch_groups(B, cfg.data.n_poses):
                shape = (g.stop - g.start, cfg.data.n_poses,
                         cfg.model.latent_dim)
                want[shape] = want.get(shape, 0) + (
                    5 * calls * 2 * cfg.model.num_layers)
            expect_shapes(f"batch_probe B={B}", layers, want)
            expect(f"batch_probe B={B}", counts,
                   fused_layer=sum(want.values()))
            example_line(f"batch-{B}", {"line": out.strip(), "secs": secs},
                         counts, layers, attns, t)
            total = total or sum(want.values())
    finally:
        ex.SECS = default
    return {"fused_layer_examples_batch": total}


def example_live(full):
    """Items 7-8: the latency frontier (W 34 and 12 for 10 s; full: the
    JAX defaults) and the live demo (10 s; full: 12 s)."""
    from diffsheg_tpu_torch.examples import live_demo, live_latency
    secs, sizes = (40, "34,24,16,12") if full else (10, "34,12")
    out, _, counts, layers, attns, t, _ = run_example(
        "live_latency", live_latency.main, ["--secs", str(secs), "--sizes",
                                            sizes])
    cfg = live_latency.make_config()
    T, L = secs * cfg.data.fps, cfg.model.latent_dim
    per = 2 * cfg.model.num_layers
    want = {(1, 34, L): 2 * per * stream_calls(cfg, T)}   # offline + W 34
    for W in (int(s) for s in sizes.split(",")):
        if W != 34:
            want[(1, W, L)] = per * stream_calls(cfg, T, W)
    expect_shapes("live_latency", layers, want)
    expect("live_latency", counts, fused_layer=sum(want.values()))
    example_line("live_latency", json_lines_of(out), counts, layers, attns,
                 t)
    demo_secs = 12.0 if full else 10.0
    _, err, counts, layers, attns, t, final = run_example(
        "live_demo", live_demo.main, demo_secs)
    want_demo = per * stream_calls(cfg, final.shape[1])
    expect("live_demo", counts, fused_layer=want_demo)
    example_line("live_demo", {"session": err.strip().splitlines()[-1]},
                 counts, layers, attns, t)
    return {"fused_layer_examples_live": want[(1, 34, L)]}


def example_probe(full):
    """Item 9: the sampler probe (4 variants x 6 calls; 10 s, full 60 s)."""
    from diffsheg_tpu_torch.examples import perf_probe as ex
    secs = 60 if full else 10
    out, _, counts, layers, attns, t, _ = run_example(
        "perf_probe", ex.main, ["--secs", str(secs)])
    cfg = ex.make_config()
    calls = stream_calls(cfg, secs * cfg.data.fps)
    # the level cache's audio encoder: 25 levels x the stream's windows
    from diffsheg_tpu_torch.sampling.streamer import window_starts
    K = len(window_starts(secs * cfg.data.fps, 34, 30))
    want_attn = {(25 * K, 34, cfg.model.audio_dim, 8): 2 * 6}
    want_layer = 4 * 6 * calls * 2 * cfg.model.num_layers
    expect_shapes("perf_probe attention", attns, want_attn)
    expect("perf_probe", counts, fused_layer=want_layer,
           fused_linear_attention=12,
           gemm=times(cache_gemm(beat_structure(), K, 34), 2 * 6))
    example_line("perf_probe", {"lines": out.strip().splitlines()}, counts,
                 layers, attns, t)
    return {"fused_layer_examples_probe": want_layer,
            "fused_linear_attention_examples_probe": 12}


def example_hubert_drift():
    """Item 10 (full depth only): HuBERT's live drift, f32: the offline
    extraction of its 24 s and each window alone (a chunk of 1000 frames)
    take gemm_tf32x3; the windows with 4 s of left context (313 frames)
    do not."""
    from diffsheg_tpu_torch.examples import live_hubert_drift as ex
    from diffsheg_tpu_torch.sampling.streamer import window_starts
    out, _, counts, layers, attns, t, _ = run_example(
        "live_hubert_drift", ex.main, [])
    windows = len(window_starts(24 * 15, 34, 30))
    expect("live_hubert_drift", counts,
           gemm=plus(extractor_gemm(24 * 16000),
                     extractor_gemm(BEAT_WINDOW_SAMPLES, windows)))
    example_line("live_hubert_drift", json_lines_of(out)[-1], counts, layers,
                 attns, t)


EXAMPLE_ITEMS = ("convergence", "overfit", "capacity", "show",
                 "train_bench", "batch", "live", "probe", "hubert_drift")


def phase_examples(dev, full, items=EXAMPLE_ITEMS):
    """The examples of ``items`` (all by default) through their entry
    points at a cut depth, each printing one line with its JSON and its
    exact launch counts (by shape too): convergence_demo 40 epochs with
    the resume at 20, overfit_demo 300 steps, serve_capacity sessions 1
    and 4 for 8 s, show_bench (15 s, ``fused_step='on'``), one
    train_bench row (batch 256, f32), batch_probe B 8 on a 10 s stream,
    live_latency W 34 and 12 and live_demo for 10 s, perf_probe on a 10 s
    stream.  ``--full`` runs them at the JAX scripts' default depths, adds
    live_hubert_drift, show_bench's JAX configuration, train_bench's bf16
    / pipelined / frontend points and a profiled serve_capacity row (the
    card's idle share), and writes the 240-epoch convergence curve."""
    import tempfile
    no_tf32()
    t0 = time.perf_counter()
    launches = {}
    if "convergence" in items:
        with tempfile.TemporaryDirectory() as tmp:
            launches.update(example_convergence(tmp, full))
    for name, fn in (("overfit", example_overfit),
                     ("capacity", lambda f: example_capacity(dev, f)),
                     ("show", example_show),
                     ("train_bench", example_train_bench),
                     ("batch", example_batch), ("live", example_live),
                     ("probe", example_probe)):
        if name in items:
            launches.update(fn(full))
    if full and "hubert_drift" in items:
        example_hubert_drift()
    log(f"examples: phase {time.perf_counter() - t0:.1f} s")
    return launches


# --------------------------------------------------------------------------
# the closing kernels line
# --------------------------------------------------------------------------

# The closing ``kernels`` line, a row each: (the launch name a phase
# returns, phase 3's case whose numbers the row carries).  The kernel is
# the name's prefix, the layer kernels' sub-result of their case; the
# source and the JAX call site replaced come from KERNEL_SOURCES.
KERNEL_ROWS = (
    # the main paths: phases 5 and 6
    ("fused_branch", "beat-ges-bf16"),
    ("fused_layer", "beat-ges-bf16"),
    ("fused_linear_attention", "attn-beat-f32"),
    ("fused_linear_attention_audio_enc", "attn-audio-enc-f32"),
    ("fused_ddim_repaint_step", "step-beat"),
    # quantized, the BEAT gesture branch in bf16
    ("fused_branch_int8", "beat-ges-bf16-int8"),
    ("fused_layer_int8", "beat-ges-bf16-int8"),
    ("fused_branch_int4", "beat-ges-bf16-int4"),
    ("fused_layer_int4", "beat-ges-bf16-int4"),
    # phase 7's sessions (a)-(d)
    ("fused_layer_live_w34", "beat-ges-bf16"),
    ("fused_layer_live_w12", "live-t12-bf16"),
    ("fused_layer_live_b4", "live-b4-bf16"),
    ("fused_branch_live", "beat-ges-bf16"),
    # phase 8's variants (a)-(d); the decoder's timed at its cross-attention
    ("fused_linear_attention_decoder", "attn-cross-beat-f32"),
    ("fused_linear_attention_decoder_audio_enc", "attn-audio-enc-b1-f32"),
    ("fused_ddim_repaint_step_decoder", "step-beat"),
    ("fused_linear_attention_learned_var", "attn-beat-f32"),
    ("fused_linear_attention_learned_var_audio_enc", "attn-audio-enc-b1-f32"),
    ("fused_linear_attention_single", "attn-beat-f32"),
    ("fused_ddim_repaint_step_single", "step-beat-ges"),
    ("fused_ddim_repaint_step_learned_var", "step-beat"),
    # phase 9, cli generate (a)-(d)
    ("fused_layer_generate", "layer-beat-4spk-f32"),
    ("fused_branch_generate", "beat-ges-bf16"),
    ("fused_layer_generate_staged", "beat-ges-f32"),
    ("fused_layer_generate_show", "show-cfg-f32"),
    ("fused_linear_attention_generate_audio_enc", "attn-audio-enc-4spk-f32"),
    ("fused_linear_attention_generate_staged_audio_enc",
     "attn-audio-enc-10s-f32"),
    ("fused_linear_attention_generate_show_audio_enc",
     "attn-show-audio-enc-f32"),
    # the raw-HuBERT model in K passes: phase 4's streams, phase 9's (e)
    ("fused_layer_raw_stream", "raw-ges-f32"),
    ("fused_branch_raw_stream", "raw-ges-f32"),
    ("fused_layer_generate_raw", "raw-ges-f32"),
    # windows of 352 frames: phase 4's SHOW stream, phase 7's session (e)
    ("fused_layer_show352_stream", "show-cfg-t352-f32"),
    ("fused_branch_show352_stream", "show-cfg-t352-bf16"),
    ("fused_layer_live_show352", "show-cfg-t352-bf16"),
    # widths off 16 and a head past a block's threads: phase 4's streams
    ("fused_layer_odd_stream", "odd-L520-f32"),
    ("fused_branch_odd_stream", "odd-L520-bf16"),
    ("fused_linear_attention_wide_stream", "attn-hd1024-f32"),
    # phase 10: cli train at batch 2500, the evaluation at (7, 34)
    ("fused_linear_attention_train", "attn-train-beat-f32"),
    ("fused_linear_attention_train_audio_enc", "attn-train-audio-enc-f32"),
    ("fused_layer_eval", "layer-eval-beat-f32"),
    ("fused_linear_attention_eval_audio_enc", "attn-eval-audio-enc-f32"),
    # phase 11: cli train, eval and test-stream
    ("fused_linear_attention_data_train", "attn-data-train-beat-f32"),
    ("fused_linear_attention_data_train_audio_enc",
     "attn-data-train-audio-enc-f32"),
    ("fused_layer_data_eval", "layer-eval-beat-f32"),
    ("fused_layer_data_eval_b4", "layer-beat-4spk-f32"),
    ("fused_linear_attention_data_eval_audio_enc",
     "attn-data-eval-audio-enc-f32"),
    ("fused_layer_test_stream", "beat-ges-f32"),
    ("fused_linear_attention_test_stream_audio_enc",
     "attn-stream-audio-enc-f32"),
    # phase 12: the frontend in the step, an NCCL group of one, 2 processes
    ("fused_linear_attention_scale_train", "attn-scale-train-beat-f32"),
    ("fused_linear_attention_scale_train_audio_enc",
     "attn-scale-train-audio-enc-f32"),
    ("fused_layer_scale_eval", "layer-eval-beat-f32"),
    ("fused_linear_attention_scale_eval_audio_enc", "attn-eval-audio-enc-f32"),
    ("fused_linear_attention_scale_world1", "attn-scale-train-beat-f32"),
    ("fused_linear_attention_scale_world1_audio_enc",
     "attn-scale-train-audio-enc-f32"),
    ("fused_linear_attention_scale_dp", "attn-scale-dp-beat-f32"),
    ("fused_linear_attention_scale_dp_audio_enc",
     "attn-scale-dp-audio-enc-f32"),
    ("fused_layer_scale_testset", "beat-ges-f32"),
    ("fused_linear_attention_scale_testset_audio_enc",
     "attn-stream-audio-enc-f32"),
    # phase 13: cli doctor's kernel probe
    ("fused_branch_doctor", "beat-ges-bf16"),
    ("fused_layer_doctor", "beat-ges-f32"),
    ("fused_linear_attention_doctor", "attn-beat-f32"),
    ("fused_ddim_repaint_step_doctor", "step-beat"),
    # phase 14: the examples
    ("fused_linear_attention_examples_convergence", "attn-conv-train-f32"),
    ("fused_layer_examples_convergence", "layer-conv-f32"),
    ("fused_linear_attention_examples_overfit", "attn-overfit-train-f32"),
    ("fused_layer_examples_overfit", "layer-overfit-f32"),
    ("fused_layer_examples_capacity", "beat-ges-bf16"),
    ("fused_branch_examples_show", "show-cfg-bf16"),
    ("fused_ddim_repaint_step_examples_show", "step-show"),
    ("fused_linear_attention_examples_train_bench",
     "attn-scale-train-beat-f32"),
    ("fused_layer_examples_batch", "layer-b7-bf16"),
    ("fused_layer_examples_live", "beat-ges-bf16"),
    ("fused_layer_examples_probe", "beat-ges-f32"),
    ("fused_linear_attention_examples_probe", "attn-audio-enc-10s-f32"))
# (kernel, quantized) -> (its CUDA source, the JAX call site it replaces)
KERNEL_SOURCES = {
    ("fused_branch", False): ("fused_layer.cu", "ops/fused_layer.py:475"),
    ("fused_branch", True): ("fused_layer.cu", "ops/fused_layer.py:374"),
    ("fused_layer", False): ("fused_layer.cu", "ops/fused_layer.py:556"),
    ("fused_layer", True): ("fused_layer.cu", "ops/fused_layer.py:492"),
    ("fused_linear_attention", False): ("linear_attention.cu",
                                        "ops/linear_attention.py:99"),
    ("fused_ddim_repaint_step", False): ("step_math.cu",
                                         "ops/step_math.py:153")}


def kernels_line(kres, launches):
    """The ``kernels`` line's entries: each KERNEL_ROWS row whose case is
    in ``kres`` (phase 3's results), with the launches its path made
    (``launches``, by name; None where no phase ran it)."""
    entries = []
    for name, key in KERNEL_ROWS:
        if key not in kres:
            continue
        kernel = next(k for k, _ in KERNEL_SOURCES if name.startswith(k))
        source, line = KERNEL_SOURCES[kernel,
                                      key.endswith(tuple(QUANT_BITS))]
        case = kres[key][kernel] if kernel in BOTH else kres[key]
        entries.append(dict(
            name=name, route="cuda",
            source=f"diffsheg_tpu_torch/csrc/{source}",
            replaces=f"diffsheg_tpu/{line}",
            launches=launches.get(name), max_abs_err=case["max_abs_err"],
            ms=case["ms"], plain_ms=case["plain_ms"],
            bound_ms=case["bound_ms"], bound_by=case["bound_by"],
            library_ms=None))
    return entries


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("kernels", "qkernels", "speech",
                                       "crossover",
                                       "stream", "e2e", "uncached", "live",
                                       "variants", "generate", "train",
                                       "data", "scale", "tools", "examples"),
                    default=None, help="run the build and one phase "
                    "(qkernels: the quantized kernel cases alone; "
                    "speech: phase 3's speech-encoder cases alone; "
                    "crossover: gemm_tf32x3 against cuBLAS by rows, in no "
                    "whole run)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--full", action="store_true",
                    help="run the examples phase at the JAX scripts' "
                    "default depths (and write the convergence curve)")
    ap.add_argument("--examples", default=",".join(EXAMPLE_ITEMS),
                    help="the examples phase's items, comma-separated "
                    f"(default all: {','.join(EXAMPLE_ITEMS)})")
    ap.add_argument("--ab", nargs="+", metavar="CU", default=[],
                    help="other versions (paths) of fused_layer.cu, "
                    "linear_attention.cu or step_math.cu, by file name, to "
                    "build and time beside the tree's, before any phase")
    ap.add_argument("--ab-exact", action="store_true",
                    help="fail unless each --ab version's outputs equal "
                    "the tree's bit for bit")
    args = ap.parse_args()
    unknown = set(args.examples.split(",")) - set(EXAMPLE_ITEMS)
    if unknown:
        ap.error(f"--examples: unknown {sorted(unknown)}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import diffsheg_tpu_torch  # noqa: F401  (fails outside a checkout)
    from diffsheg_tpu_torch.ops import build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build(build.BUILDS + tuple(args.ab), verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s")

    def run(phase):
        return args.only in (None, phase)

    if args.ab:
        phase_ab(dev, args.reps, args.ab, args.ab_exact)
    launches = {}
    t0 = time.perf_counter()
    if args.only == "crossover":
        phase_crossover(dev, args.reps)
        return 0
    kres = (phase_kernels(dev, args.reps) if run("kernels") else
            quant_kernel_cases(dev, args.reps) if args.only == "qkernels"
            else speech_encoder_cases(dev, args.reps)
            if args.only == "speech" else None)
    if kres is not None:
        log(f"kernels: phase {time.perf_counter() - t0:.1f} s")
    if any(run(p) for p in ("stream", "e2e", "uncached", "live",
                            "variants", "generate", "tools")):
        from diffsheg_tpu_torch.config import beat_config
        from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
        model = init_unidiffuser(beat_config().model, seed=0)
        if run("stream"):
            t0 = time.perf_counter()
            launches.update(phase_stream(dev, model))
            log(f"stream: phase {time.perf_counter() - t0:.1f} s")
        if any(run(p) for p in ("e2e", "uncached", "live", "variants",
                                "tools")):
            t0 = time.perf_counter()
            hubert_fe = make_hubert(dev)
            log(f"set-up: random HuBERT-large on the card "
                f"{time.perf_counter() - t0:.1f} s")
            if run("e2e"):
                launches.update(phase_e2e(dev, model, hubert_fe))
            if run("uncached"):
                launches.update(phase_uncached(dev, model, hubert_fe))
            if run("live"):
                launches.update(phase_live(dev, model, hubert_fe, args.reps))
            if run("variants"):
                launches.update(phase_variants(dev, hubert_fe))
            if run("tools"):
                launches.update(phase_tools(dev, model, hubert_fe))
            del hubert_fe
        if run("generate"):
            launches.update(phase_generate(dev, model))
    if run("train"):
        launches.update(phase_train(dev))
    if run("data"):
        launches.update(phase_data(dev, args.reps))
    if run("scale"):
        launches.update(phase_scale(dev))
    if run("examples"):
        launches.update(phase_examples(dev, args.full,
                                       args.examples.split(",")))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    if kres is None:
        return 0
    print(json.dumps({"kernels": kernels_line(kres, launches)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
