"""Environment diagnostics (``python -m diffsheg_tpu_torch.cli doctor``).

Counterpart of ``diffsheg_tpu/cli/doctor.py`` for the card.  One line a
check, ``[ok  ]`` / ``[FAIL]`` / ``[warn]``; exit code 1 on any FAIL:

  - versions: torch (with its CUDA), numpy, scipy;
  - env: ``CUDA_VISIBLE_DEVICES`` and ``CUDA_HOME`` when set (warn);
  - devices: count, name, compute capability and memory, probed in a
    thread with a bounded wait; a capability other than 9.0 fails, since
    the kernels are built for ``sm_90a`` only;
  - dispatch: a trivial op on the card and its readback, round trip;
  - kernels: ``nvcc`` and its version, the three sources built
    (``ops/build.py``) and bound, and each of the four kernels launched
    once at the main path's shape on seeded inputs and held against its
    plain version (f32 rel-RMS <= 1e-5, bf16 <= 8e-3, the step <= 1e-6
    absolute); a build, a launch or a band missed fails;
  - dataplane: the C++ data plane (``runtime/``) built and loaded;
  - build-cache: the kernels' build directory, how many libraries it
    holds, and whether each build is current for its source (JAX's
    ``compile-cache`` line: the port compiles no XLA);
  - ``--calibrate``: the calibration probes (``utils/calibration.py``).

``device="cpu"`` (``--device cpu``) runs nothing on a card: the CUDA
checks print ``warn`` ("cpu requested").  Without a card and without it,
the devices line fails and the doctor does not carry on on the CPU.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import threading
import time
from typing import List, Optional, Tuple

Check = Tuple[Optional[bool], str, str]

# the main path's shapes (PERF.md kernel table rows 1, 2f, 3 and 4): the
# BEAT gesture branch (latent 512, 8 heads, ff 1024, 8 layers, a 1024-wide
# padded concat of 947 channels) over a 34-frame window, 192 motion
# channels with a 4-frame overlap
L, F, H, N_LAYERS, T, CP, C_REAL, C_MOTION, OVERLAP = (
    512, 1024, 8, 8, 34, 1024, 947, 192, 4)
F32_TOL, BF16_TOL, STEP_TOL = 1e-5, 8e-3, 1e-6
KERNELS = ("fused_branch", "fused_layer", "fused_linear_attention",
           "fused_ddim_repaint_step")


def _line(ok: Optional[bool], name: str, detail: str) -> str:
    mark = {True: "ok  ", False: "FAIL", None: "warn"}[ok]
    return f"[{mark}] {name:<22} {detail}"


def _error(e: BaseException) -> str:
    lines = str(e).strip().splitlines()
    return " | ".join([f"{type(e).__name__}: {lines[0] if lines else ''}"]
                      + lines[1:8])


def _versions() -> List[Check]:
    out = []
    for mod in ("torch", "numpy", "scipy"):
        try:
            m = importlib.import_module(mod)
            v = getattr(m, "__version__", "?")
            if mod == "torch":
                v += f" (CUDA {m.version.cuda})"
            out.append((True, mod, v))
        except Exception as e:  # noqa: BLE001 — report, don't crash doctor
            out.append((False, mod, f"import failed: {e}"))
    return out


def _probe_devices(timeout: float) -> Tuple[bool, str]:
    """The card's properties in a side thread with a bounded wait: a wedged
    CUDA runtime blocks the first CUDA call, the condition worth
    diagnosing."""
    result: dict = {}

    def probe():
        try:
            import torch
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available: no card, or "
                                   "no CUDA runtime for it; pass --device "
                                   "cpu to check the rest on the CPU")
            result["props"] = [torch.cuda.get_device_properties(i)
                               for i in range(torch.cuda.device_count())]
        except Exception as e:  # noqa: BLE001
            result["error"] = e

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        return False, f"TIMED OUT after {timeout:.0f}s — the CUDA runtime hung"
    if "error" in result:
        return False, _error(result["error"])
    props = result["props"]
    caps = sorted({(p.major, p.minor) for p in props})
    names = "/".join(sorted({p.name for p in props}))
    gib = props[0].total_memory / 2 ** 30
    detail = (f"{len(props)} x {names} (compute capability "
              f"{'/'.join(f'{a}.{b}' for a, b in caps)}, {gib:.1f} GiB)")
    if caps != [(9, 0)]:
        return False, detail + " — the kernels are built for sm_90a only"
    return True, detail


def _dispatch_latency() -> Check:
    import torch
    x = torch.zeros(8, device="cuda")
    (x + 1.0).cpu()                       # first use: context, allocator
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        (x + 1.0).cpu()
        times.append(time.perf_counter() - t0)
    times.sort()
    return True, "dispatch", (f"{times[0] * 1e3:.3f} ms round trip (min of "
                              f"10, median {times[5] * 1e3:.3f}): a trivial "
                              "op on the card and its readback")


# -- the kernel probes --------------------------------------------------------

def _rel_rms(a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean().sqrt() / (b ** 2).mean().sqrt())


def _layer_inputs(dtype, n_layers, gen, dev):
    """(x, cond, mods, stacked layers) of the gesture branch, batch 1."""
    import torch
    from diffsheg_tpu_torch.ops.fused_layer import random_layer_params
    slp = random_layer_params(n_layers, L, F, CP, C_REAL, dtype, gen, dev)
    x = torch.randn(1, T, L, generator=gen).to(dev, dtype)
    cond = torch.randn(1, T, CP - L, generator=gen)
    cond[..., C_REAL - L:] = 0.0
    mods = 0.3 * torch.randn(n_layers, 2, 1, 2 * L, generator=gen)
    return x, cond.to(dev, dtype), mods.to(dev, dtype), slp


def _timed(launch):
    """(output, device ms) of one launch between CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = launch()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _probe_branch(gen, dev):
    import torch
    from diffsheg_tpu_torch.ops.fused_layer import (fused_branch,
                                                    fused_branch_reference)
    x, cond, mods, slp = _layer_inputs(torch.bfloat16, N_LAYERS, gen, dev)
    got, ms = _timed(lambda: fused_branch(x, cond, mods, slp, H, C_REAL))
    ref = fused_branch_reference(x, cond, mods, slp, H, C_REAL)
    return (f"bf16 (1, {T}, {CP}) x {N_LAYERS} layers", "rel-RMS",
            _rel_rms(got, ref), BF16_TOL, ms)


def _probe_layer(gen, dev):
    import torch
    from diffsheg_tpu_torch.ops.fused_layer import (
        chain_feats, fused_layer, fused_layer_reference, layer_at)
    x, cond, mods, slp = _layer_inputs(torch.float32, 1, gen, dev)
    lp = layer_at(slp, 0)
    feats = chain_feats(x, cond, None, None).contiguous()
    ms_, mf_ = mods[0, 0].contiguous(), mods[0, 1].contiguous()
    got, ms = _timed(lambda: fused_layer(x, feats, ms_, mf_, lp, H, C_REAL))
    ref = fused_layer_reference(x, feats, ms_, mf_, lp, H, C_REAL)
    return f"f32 (1, {T}) one layer", "rel-RMS", _rel_rms(got, ref), \
        F32_TOL, ms


def _probe_attention(gen, dev):
    import torch
    from diffsheg_tpu_torch.ops.linear_attention import (
        fused_linear_attention, fused_linear_attention_reference)
    q, k, v = (torch.randn(1, T, L, generator=gen) for _ in range(3))
    k[:, T - T // 8:] = -1e6          # padded frames' keys, masked
    v[:, T - T // 8:] = 0.0
    q, k, v = (a.to(dev) for a in (q, k, v))
    got, ms = _timed(lambda: fused_linear_attention(q, k, v, H))
    ref = fused_linear_attention_reference(q, k, v, H)
    return f"f32 (1, {T}, {L}), {H} heads", "rel-RMS", _rel_rms(got, ref), \
        F32_TOL, ms


def _probe_step(gen, dev):
    import torch
    from diffsheg_tpu_torch.diffusion.respace import (make_respaced_schedule,
                                                      space_timesteps)
    from diffsheg_tpu_torch.diffusion.schedule import get_named_beta_schedule
    from diffsheg_tpu_torch.ops.step_math import (ddim_repaint_step_reference,
                                                  fused_ddim_repaint_step)
    x, eps, gt, gtn = (torch.randn(1, T, C_MOTION, generator=gen).to(dev)
                       for _ in range(4))
    tail = torch.randn(1, OVERLAP, C_MOTION, generator=gen).to(dev)
    sched, _ = make_respaced_schedule(get_named_beta_schedule("linear", 1000),
                                      space_timesteps(1000, "ddim25"))
    # DDIM-25 level 1: a valid saved tail, blended toward the mean
    scal = (sched.alphas_cumprod_prev[1], sched.sqrt_recip_alphas_cumprod[1],
            sched.sqrt_recipm1_alphas_cumprod[1], 1.0)
    args = (x, eps, scal, gt, gtn, tail, OVERLAP, True)
    got, ms = _timed(lambda: fused_ddim_repaint_step(*args))
    ref = ddim_repaint_step_reference(*args)
    return (f"f32 (1, {T}, {C_MOTION}), overlap {OVERLAP}", "max abs",
            float((got - ref).abs().max()), STEP_TOL, ms)


PROBES = {"fused_branch": _probe_branch, "fused_layer": _probe_layer,
          "fused_linear_attention": _probe_attention,
          "fused_ddim_repaint_step": _probe_step}


def _nvcc() -> str:
    from diffsheg_tpu_torch.ops.build import nvcc_path
    path = nvcc_path()
    out = subprocess.run([path, "--version"], capture_output=True,
                         text=True, timeout=60).stdout
    release = [ln for ln in out.splitlines() if "release" in ln]
    return f"{path}, {release[-1].strip() if release else out.strip()}"


def _kernel_checks() -> List[Check]:
    """Build and bind the three sources, then launch each kernel once
    against its plain version.  Nothing falls back: any error is a FAIL."""
    import torch
    from diffsheg_tpu_torch.ops import (build, fused_layer, linear_attention,
                                       step_math)
    try:
        nvcc = _nvcc()
        t0 = time.perf_counter()
        build.build(build.SOURCES)
        secs = time.perf_counter() - t0
        for mod in (fused_layer, linear_attention, step_math):
            mod._lib()                    # the library and its ctypes types
    except Exception as e:  # noqa: BLE001
        return [(False, "kernels", _error(e))]
    checks: List[Check] = [(True, "kernels", (
        f"nvcc {nvcc}; {', '.join(build.SOURCES)} built for sm_90a "
        f"({secs:.1f} s) and bound"))]
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for name in KERNELS:
        try:
            what, measure, err, tol, ms = PROBES[name](gen, dev)
        except Exception as e:  # noqa: BLE001
            checks.append((False, name, _error(e)))
            continue
        checks.append((err <= tol, name, (
            f"{what}: {measure} {err:.3e} (band {tol:g}) against the plain "
            f"version, one launch {ms:.4f} ms")))
    return checks


def _dataplane_status() -> Check:
    from diffsheg_tpu_torch import runtime
    if runtime.native_available():
        return True, "dataplane", (
            f"C++ library built and loaded ({runtime._library_path().name}:"
            " threaded gather, parse)")
    return False, "dataplane", (
        "native library unavailable (g++ build failed?): the numpy paths "
        "run, and the parser refuses text it would read differently")


def _build_cache_status() -> Check:
    from diffsheg_tpu_torch.ops import build
    d = build.BUILD_DIR
    n = len(list(d.glob("*.so"))) if d.is_dir() else 0
    stale = [s for s in build.BUILDS if not build.is_built(s)]
    if not stale:
        return True, "build-cache", (f"{d} ({n} libraries); every kernel "
                                     "build current for its source")
    return None, "build-cache", (
        f"{d} ({n} libraries); not built for the current sources: "
        f"{', '.join(stale)} (each builds at first use)")


def _calibration_checks() -> List[Check]:
    """The calibration probes (``doctor --calibrate``): the card executes
    at a rate its kind can reach, with a forced, bounded readback; and a
    program of products runs its kernels on the card."""
    import torch
    from diffsheg_tpu_torch.utils.calibration import (calibrate,
                                                      device_activity,
                                                      envelope_for)
    res = calibrate(bandwidth=True)
    lo, hi = envelope_for(res.device_kind)
    out: List[Check] = [
        (res.ok, "calib-compute",
         f"{res.calib_tflops:.1f} TFLOP/s sustained bf16 (envelope "
         f"[{lo:.0f}, {hi:.0f}] for {res.device_kind!r})"
         + ("" if res.ok else f" — {res.reason}")),
        (res.dispatch_ms > 0, "calib-dispatch",
         f"{res.dispatch_ms:.3f} ms round trip (min of 5)")]
    if res.h2d_mbps or res.d2h_mbps:
        out.append((True, "calib-bandwidth",
                    f"8 MiB pageable: h2d {res.h2d_mbps:.0f} MB/s, "
                    f"d2h {res.d2h_mbps:.0f} MB/s"))
    a = torch.ones(4096, 4096, dtype=torch.bfloat16, device="cuda")
    b = torch.full_like(a, 1.0 / 4096)

    def products():                   # 50 chained products, ~8 ms
        c = a
        for _ in range(50):
            c = c @ b
        return c

    products()                        # cuBLAS set-up outside the probe
    act = device_activity(products)
    out.append((act.on_card, "calib-locality", act.line()))
    return out


def run_doctor(device_timeout: float = 20.0, device: str = "cuda",
               calibrate: bool = False) -> int:
    """Print one line a check and a summary; 0 when none failed."""
    checks: List[Check] = list(_versions())
    for k in ("CUDA_VISIBLE_DEVICES", "CUDA_HOME"):
        if os.environ.get(k) is not None:
            checks.append((None, k, f"set: {os.environ[k]!r}"))
    cuda = ["devices", "dispatch", "kernels"] + (
        ["calibration"] if calibrate else [])
    if device == "cpu":
        checks += [(None, name, "cpu requested: nothing runs on a card")
                   for name in cuda]
    else:
        ok, detail = _probe_devices(device_timeout)
        checks.append((ok, "devices", detail))
        probes = {"dispatch": lambda: [_dispatch_latency()],
                  "kernels": _kernel_checks,
                  "calibration": _calibration_checks}
        for name in cuda[1:]:
            if not ok:
                checks.append((False, name, "skipped — device probe failed"))
                continue
            try:
                checks += probes[name]()
            except Exception as e:  # noqa: BLE001
                checks.append((False, name, _error(e)))
    for name, status in (("dataplane", _dataplane_status),
                         ("build-cache", _build_cache_status)):
        try:
            checks.append(status())
        except Exception as e:  # noqa: BLE001
            checks.append((False, name, _error(e)))

    failed = False
    for ok, name, detail in checks:
        print(_line(ok, name, detail))
        failed |= ok is False
    print(_line(not failed, "doctor", "all checks passed" if not failed
                else "some checks FAILED"))
    return 1 if failed else 0
