"""Training-step performance ladder (BEAT configuration, one card).

Counterpart of ``examples/train_bench.py``.  The reference trains with
global batch 2500 over 5 GPUs but publishes no training throughput, so
this builds the port's own ladder: windows/second through the whole
train step — forward (both branches), all losses, backward, global-norm
clip, Adam — at the published architecture (155 M parameters), plus:

  - an MFU estimate: the step's operations counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (every product, forward
    and backward), plus the linear-attention kernel's forward by the
    formula of PERF.md's kernel table (4·B·T·D·D/H a launch; the counter
    does not see a kernel launched through ctypes), over the card's peak
    for the dtype the products run in (``PEAK_FLOPS``);
  - the input-pipeline cost (``ShardedBatchLoader`` feeding the step
    against a batch resident on the card);
  - a bf16-compute mode (f32 master weights, products in bfloat16).

There is no count of the bytes a step moves (no counterpart of XLA's
``bytes accessed``), so ``hbm_gb_per_step``, ``arith_intensity`` and
``roofline_mfu_pct`` are null.  ``compile_s`` is the first step's seconds
(the kernels' build and load, cuBLAS set-up): the port compiles no
program.  TF32 stays off, as in every f32 phase of ``chip_smoke.py``.

Run:
  python -m diffsheg_tpu_torch.examples.train_bench            # batch 256, f32
  python -m diffsheg_tpu_torch.examples.train_bench 2500 bf16  # reference batch
  TRAIN_BENCH_MATRIX=1 python -m diffsheg_tpu_torch.examples.train_bench
  TRAIN_BENCH_PIPELINE=1 ...   # the loader feeding the step
  TRAIN_BENCH_FRONTEND=1 ...   # the speech frontend in the step
(``--device cpu`` for a logic run on the CPU.)  The JAX script's
``TRAIN_BENCH_SCAN`` switch has no counterpart: it stacks the layers into
one ``lax.scan`` for XLA's compiler, and the port holds every layer as its
own module.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from diffsheg_tpu_torch.config import beat_config
from diffsheg_tpu_torch.diffusion.schedule import (get_named_beta_schedule,
                                                   make_schedule)
from diffsheg_tpu_torch.examples import (add_device_arg, script_device,
                                         synchronize)
from diffsheg_tpu_torch.models.factory import random_init_
from diffsheg_tpu_torch.models.unidiffuser import UniDiffuser
from diffsheg_tpu_torch.train.step import create_train_state, make_train_step

# NVIDIA H100 SXM data sheet: bf16 dense tensor-core peak; f32 on the FMA
# units (TF32 held off).  Used only for the MFU estimate column.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def make_config(dtype: str = "float32", remat: bool = False):
    import dataclasses
    cfg = beat_config()
    if dtype != "float32" or remat:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model,
            compute_dtype=dtype if dtype != "float32"
            else cfg.model.compute_dtype,
            remat=remat))
    return cfg


def build(batch: int, dtype: str, remat: bool = False,
          frontend: bool = False, device=None):
    device = script_device(device)
    cfg = make_config(dtype, remat)
    # the Flax initialisation's distributions (zero output projections)
    model = random_init_(UniDiffuser(cfg.model), 0, perturb=0.0)
    sched = make_schedule(get_named_beta_schedule(
        cfg.diffusion.beta_schedule, cfg.diffusion.num_steps))
    state = create_train_state(cfg, model, device)

    fe = None
    if frontend:
        # on-device speech frontend: the batch carries raw int16 16 kHz
        # audio, and the frontend derives mel + HuBERT on the card before
        # the unchanged step (the trainer's split design)
        from diffsheg_tpu_torch.audio.frontend import make_speech_frontend
        fe = make_speech_frontend(cfg, device=device)
    step = make_train_step(cfg, sched)

    B, T = batch, cfg.data.n_poses
    S = int(round(T / cfg.data.fps * cfg.data.audio_sr))

    def make_host_batch(seed=0):
        r = np.random.RandomState(seed)
        out = {
            "motion": r.randn(B, T, cfg.model.motion_dim).astype(np.float32),
            "pid": np.eye(cfg.model.style_dim, dtype=np.float32)[
                np.arange(B) % cfg.model.style_dim],
            "sem": np.full((B, T), 0.5, dtype=np.float32),
        }
        if frontend:
            out["wave16"] = (r.randn(B, S) * 3000).astype(np.int16)
        else:
            out["mel"] = r.randn(B, T, cfg.model.audio_dim).astype(np.float32)
            out["hubert"] = r.randn(B, T,
                                    cfg.model.hubert_dim).astype(np.float32)
        return out

    def to_device(hb):
        return {k: torch.as_tensor(v).to(device) for k, v in hb.items()}

    device_batch = to_device(make_host_batch())
    return cfg, state, step, device_batch, make_host_batch, fe


def kernel_flops(launches_by_shape) -> float:
    """The linear-attention kernel's forward operations: both
    contractions, 4·B·T·D·(D/H) a launch, by (B, T, D, H)."""
    return float(sum(n * 4 * B * T * D * (D // H)
                     for (B, T, D, H), n in launches_by_shape.items()))


def counted_flops(call) -> float:
    """Operations of one ``call()``: FlopCounterMode's count plus the
    linear-attention kernel's launches in it."""
    from torch.utils.flop_counter import FlopCounterMode

    from diffsheg_tpu_torch.ops.linear_attention import fused_linear_attention
    before = fused_linear_attention.launches_by_shape.copy()
    with FlopCounterMode(display=False) as counter:
        call()
    launched = fused_linear_attention.launches_by_shape - before
    return float(counter.get_total_flops()) + kernel_flops(launched)


def measure(batch: int, dtype: str, reps: int = 8, pipeline: bool = False,
            remat: bool = False, frontend: bool = False, device=None):
    device = script_device(device)
    cfg, state, step, device_batch, make_host_batch, fe = build(
        batch, dtype, remat=remat, frontend=frontend, device=device)
    B, T = batch, cfg.data.n_poses
    bytes_per_batch = sum(v.nbytes for v in make_host_batch().values())

    raw_batch = device_batch
    fe_compile_s = 0.0
    if fe is not None:
        # the frontend's first call, then the step on its output; every
        # timed call pays frontend + step (two calls), as the trainer does
        t_fe = time.perf_counter()
        device_batch = fe(dict(raw_batch))
        synchronize(device)
        fe_compile_s = time.perf_counter() - t_fe

    # the first step builds and loads the kernels: "compile_s"
    t0 = time.perf_counter()
    state, terms = step(state, device_batch)
    synchronize(device)
    compile_s = time.perf_counter() - t0 + fe_compile_s
    flops = counted_flops(lambda: step(state, device_batch))
    if fe is not None:
        flops += counted_flops(lambda: fe(dict(raw_batch)))
        base_step = step

        def step(state, db):  # frontend + step, two calls
            return base_step(state, fe(dict(db)))

        device_batch = raw_batch
    if device.type == "cuda":
        # the step's kernels ran on the card (utils/calibration.py)
        from diffsheg_tpu_torch.utils.calibration import device_activity
        act = device_activity(lambda: step(state, device_batch)[1].total)
        if not act.on_card:
            print(json.dumps({"batch": B, "dtype": dtype, "valid": False,
                              "invalid_reason": "the step did not run on "
                              f"the card: {act.line()}"}), flush=True)
            sys.exit(1)

    times = []
    cpu_t0, wall_t0 = time.process_time(), time.perf_counter()
    if pipeline:
        # feed through the loader (host gather + transfer in the loop) to
        # expose input-pipeline overhead; the source arrays are made ONCE
        host = make_host_batch(1)

        class _Ds:
            def __len__(self):
                return B * 4

            def batch(self, idx):
                return {k: v[np.asarray(idx) % B] for k, v in host.items()}

        from diffsheg_tpu_torch.data.loader import ShardedBatchLoader
        loader = ShardedBatchLoader(_Ds(), global_batch_size=B, prefetch=2)
        for i in range(reps):
            it = iter(loader)
            t0 = time.perf_counter()
            for hb in it:
                db = {k: torch.as_tensor(v).to(device, non_blocking=True)
                      for k, v in hb.items()}
                state, terms = step(state, db)
            synchronize(device)
            times.append((time.perf_counter() - t0) / 4)
    else:
        for i in range(reps):
            t0 = time.perf_counter()
            state, terms = step(state, device_batch)
            synchronize(device)
            times.append(time.perf_counter() - t0)
    # the host's share of the timed wall; the port's host drives every
    # launch, so this is reported, not held to a limit
    host_cpu_frac = ((time.process_time() - cpu_t0)
                     / max(time.perf_counter() - wall_t0, 1e-9))

    dt = min(times)
    compute = "bfloat16" if dtype == "bfloat16" else "float32"
    mfu = (flops / dt) / PEAK_FLOPS[compute] if flops else None
    return {
        "batch": B,
        "dtype": dtype,
        "remat": remat,
        "frontend": frontend,
        "step_ms": round(dt * 1e3, 1),
        "windows_per_s": round(B / dt, 1),
        "frames_per_s": round(B * T / dt, 0),
        "mfu_pct": round(100 * mfu, 1) if mfu is not None else None,
        "tflops_per_step": round(flops / 1e12, 2) if flops else None,
        "hbm_gb_per_step": None,
        "arith_intensity": None,
        "roofline_mfu_pct": None,
        "compile_s": round(compile_s, 1),
        "loss": round(float(terms.total), 2),
        "pipelined": pipeline,
        "host_mb_per_batch": round(bytes_per_batch / 1e6, 1),
        "host_cpu_frac": round(host_cpu_frac, 3),
    }


def _check_row(r, device=None):
    """Refuse to publish a row whose step time is implausible for the card
    (any healthy step at batch <= 2500 takes well under 10 s; the CPU takes
    minutes).  Where the step ran is checked in :func:`measure`."""
    if device is not None and torch.device(device).type == "cpu":
        return r  # a logic run on the CPU: host execution is the point
    if r.get("step_ms", 0) > 10_000:
        print(json.dumps({**r, "valid": False,
                          "invalid_reason": "step time implausible for the "
                          "card (>10 s)"}), flush=True)
        sys.exit(1)
    return r


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", type=int, nargs="?", default=256)
    ap.add_argument("dtype", nargs="?", default="f32")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = script_device(args.device)

    # the card's calibration: refuse to measure on a degraded device
    from diffsheg_tpu_torch.utils.calibration import calibrate
    calib = calibrate(allow_cpu=device.type == "cpu", device=device)
    print(f"calibration[{calib.backend}/{calib.device_kind}]: "
          f"{calib.calib_tflops:.1f} TFLOP/s, dispatch "
          f"{calib.dispatch_ms:.1f} ms"
          + ("" if calib.ok else f"  INVALID: {calib.reason}"),
          file=sys.stderr)
    if not calib.ok:
        print(json.dumps({"metric": "beat_train_windows_per_s", "value": 0.0,
                          **calib.json_fields()}))
        sys.exit(1)

    def row(*a, **kw):
        return _check_row(measure(*a, device=device, **kw), device)

    if os.environ.get("TRAIN_BENCH_PIPELINE"):
        # just the input-pipeline point (re-runnable in isolation)
        print(json.dumps(row(1024, "bfloat16", reps=4, pipeline=True)),
              flush=True)
        return
    if os.environ.get("TRAIN_BENCH_FRONTEND"):
        # the on-device-frontend pairs: the resident raw-audio step and
        # the same step fed by the loader, then the same two points for
        # the precomputed features at the same batch.
        # TRAIN_BENCH_FRONTEND=<batch> sets the batch (any non-numeric
        # value: 1024)
        try:
            fb = int(os.environ["TRAIN_BENCH_FRONTEND"])
        except ValueError:
            fb = 1024
        for fe_mode in (True, False):
            for pipe in (False, True):
                print(json.dumps(row(fb, "bfloat16", reps=4, pipeline=pipe,
                                     frontend=fe_mode)), flush=True)
        return
    if os.environ.get("TRAIN_BENCH_MATRIX"):
        rows = []
        for batch, dtype, remat in [
                (128, "float32", False), (512, "float32", False),
                (512, "bfloat16", False), (1024, "bfloat16", False),
                (2500, "float32", False), (2500, "bfloat16", False),
                (2500, "bfloat16", True), (2500, "float32", True)]:
            try:
                r = row(batch, dtype, remat=remat)
            except Exception as e:  # e.g. out of memory at the largest point
                print(json.dumps({"batch": batch, "dtype": dtype,
                                  "remat": remat,
                                  "error": str(e)[:200]}), flush=True)
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                continue
            print(json.dumps(r), flush=True)
            rows.append(r)
        # input-pipeline overlap at a production point
        try:
            print(json.dumps(row(1024, "bfloat16", reps=4, pipeline=True)),
                  flush=True)
        except Exception as e:
            print(json.dumps({"pipelined": True, "error": str(e)[:200]}),
                  flush=True)
        best = max(rows, key=lambda r: r["windows_per_s"])
        print(json.dumps({
            "metric": "beat_train_windows_per_s",
            "value": best["windows_per_s"],
            "unit": "windows/s",
            "batch": best["batch"], "dtype": best["dtype"],
        }))
        return

    dtype = {"bf16": "bfloat16", "f32": "float32"}.get(args.dtype, "float32")
    r = row(args.batch, dtype)
    print(f"batch {r['batch']} {r['dtype']}: {r['step_ms']} ms/step -> "
          f"{r['windows_per_s']} windows/s, MFU {r['mfu_pct']}% of "
          f"{PEAK_FLOPS[dtype] / 1e12:g} TFLOP/s ({dtype})", file=sys.stderr)
    print(json.dumps({
        "metric": "beat_train_windows_per_s",
        "value": r["windows_per_s"],
        "unit": "windows/s",
        "batch": r["batch"], "dtype": r["dtype"], "mfu_pct": r["mfu_pct"],
    }))


if __name__ == "__main__":
    main()
