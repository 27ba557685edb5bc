#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Drives ``diffsheg_tpu_torch`` on one NVIDIA card:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — compiles the CUDA kernels from ``diffsheg_tpu_torch/csrc``;
3. kernels  — each kernel against its plain PyTorch version on the card at
              the main path's shapes (BEAT branches in bf16 and f32, the
              SHOW classifier-free shape with null rows), with times;
4. stream   — a two-window BEAT stream with the same injected noise through
              the bf16 kernel path, the f32 kernel path and the f32 plain
              path, held to the port's numerics bands;
5. e2e      — the BEAT serving pipeline (60 s of audio -> mel -> HuBERT-large
              -> windowed DDIM-25 + RePaint sampler -> motion) at full
              width with seeded random weights, through the branch kernel;
              then a short stream through the per-layer kernel.

Prints its findings, a ``kernels`` JSON line, the nvidia-smi line, and
ends with ``{"ok": true, "device": {...}}``.  Any failed phase raises and
the exit code is non-zero; with no CUDA device it exits 1 and prints no
result.

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --only kernels
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


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


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def random_layers(n, L, F, Cp, c_real, dtype, gen, device):
    """Perturbed random weights for every leaf (zero-init output
    projections would hide the attention and FFN)."""
    from diffsheg_tpu_torch.ops.fused_layer import LayerParams

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


def kernel_case(name, dtype, B, T, Cp, c_real, null, dev, seed, reps,
                L=512, H=8, F=1024, n_layers=8):
    """Both kernels at one shape; returns a dict of findings."""
    from diffsheg_tpu_torch.ops.fused_layer import (
        chain_feats, fused_branch, fused_branch_reference, fused_layer,
        fused_layer_reference, layer_at)
    gen = torch.Generator().manual_seed(seed)
    slp = random_layers(n_layers, L, F, Cp, c_real, dtype, gen, dev)
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
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    out = {}

    # fused_branch: the whole stack
    got = fused_branch(x, cond, mods, slp, H, c_real, null_emb, null_mask)
    ref = fused_branch_reference(x, cond, mods, slp, H, c_real, null_emb,
                                 null_mask)
    torch.cuda.synchronize()
    e_rel, e_abs = rel_rms(got, ref), float((got.float() - ref.float()).abs().max())
    def kernel():
        fused_branch(x, cond, mods, slp, H, c_real, null_emb, null_mask)

    def plain():
        fused_branch_reference(x, cond, mods, slp, H, c_real, null_emb,
                               null_mask)

    branch_ms, branch_wall = device_ms(kernel, reps), wall_ms(kernel, reps)
    plain_ms = device_ms(plain, max(3, reps // 4))
    w_bytes = sum(t.numel() * t.element_size() for t in slp)
    io_bytes = sum(t.numel() * t.element_size() for t in (x, cond, mods, x))
    flops = n_layers * 2 * B * T * (Cp * 2 * L + 2 * L * L + 5 * L * L
                                    + 2 * L * F) \
        + n_layers * 4 * B * T * L * (L // H)
    bound = max((w_bytes + io_bytes) / HBM_BYTES_PER_S,
                flops / PEAK_FLOPS[dtype]) * 1e3
    out["fused_branch"] = dict(
        rel_rms=e_rel, max_abs_err=e_abs, ms=branch_ms, wall_ms=branch_wall,
        plain_ms=plain_ms,
        bound_ms=bound, bound_by="bytes" if (w_bytes + io_bytes)
        / HBM_BYTES_PER_S >= flops / PEAK_FLOPS[dtype] else "operations")

    # fused_layer: layer 0 on assembled, padded feats
    lp = layer_at(slp, 0)
    feats = chain_feats(x, cond, None if null_emb is None else null_emb[0],
                        null_mask).to(dtype).contiguous()
    ms_, mf_ = mods[0, 0].contiguous(), mods[0, 1].contiguous()
    got = fused_layer(x, feats, ms_, mf_, lp, H, c_real)
    ref = fused_layer_reference(x, feats, ms_, mf_, lp, H, c_real)
    torch.cuda.synchronize()
    l_rel, l_abs = rel_rms(got, ref), float((got.float() - ref.float()).abs().max())
    def lkernel():
        fused_layer(x, feats, ms_, mf_, lp, H, c_real)

    def lplain():
        fused_layer_reference(x, feats, ms_, mf_, lp, H, c_real)

    layer_ms, layer_wall = device_ms(lkernel, reps), wall_ms(lkernel, reps)
    lplain_ms = device_ms(lplain, max(3, reps // 4))
    lw = w_bytes / n_layers
    lio = sum(t.numel() * t.element_size() for t in (x, feats, ms_, mf_, x))
    lbound = max((lw + lio) / HBM_BYTES_PER_S,
                 flops / n_layers / PEAK_FLOPS[dtype]) * 1e3
    out["fused_layer"] = dict(
        rel_rms=l_rel, max_abs_err=l_abs, ms=layer_ms, wall_ms=layer_wall,
        plain_ms=lplain_ms,
        bound_ms=lbound, bound_by="bytes" if (lw + lio) / HBM_BYTES_PER_S
        >= flops / n_layers / PEAK_FLOPS[dtype] else "operations")
    if name.startswith("beat-ges"):
        from diffsheg_tpu_torch.ops.fused_layer import PHASES, branch_phase_ns
        ns = branch_phase_ns(x, cond, mods, slp, H, c_real, null_emb,
                             null_mask).mean(0)
        log(f"phases[fused_branch {name}] us/layer: " + " ".join(
            f"{p}={t / 1e3:.2f}" for p, t in zip(PHASES, ns)))
    for k, r in out.items():
        log(f"kernel[{k} {name}]: rel_rms={r['rel_rms']:.3e} (tol {tol:g}) "
            f"max_abs={r['max_abs_err']:.3e} ms={r['ms']:.4f} "
            f"wall_ms={r['wall_ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']})")
        if not r["rel_rms"] <= tol:
            raise AssertionError(f"{k} {name}: rel_rms {r['rel_rms']:.3e} "
                                 f"> {tol:g}")
    return out


def phase_kernels(dev, reps):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
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
    return results


# --------------------------------------------------------------------------
# phase 4: stream numerics
# --------------------------------------------------------------------------

def beat_cfg(dtype: str, fused_layer: str):
    import dataclasses
    from diffsheg_tpu_torch.config import beat_config
    cfg = beat_config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype=dtype),
        diffusion=dataclasses.replace(cfg.diffusion, jump_n_sample=2,
                                      fused_layer=fused_layer))


def run_stream(cfg, model, mel, pid, hub, seed, dev):
    from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator
    from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator
    stream = StreamingGenerator(WindowGenerator(cfg, model, device=dev))
    out = stream.generate_fused(mel, pid, GeneratorNoise(seed, dev), hub)
    torch.cuda.synchronize()
    return out


def phase_stream(dev, model):
    """A 68-frame stream (windows at 0, 30 and a left-shifted 34) with the
    same noise through the bf16 and f32 kernel paths and the f32 plain
    path (the fast path's kernel calls swapped for their plain versions
    in this process only)."""
    import diffsheg_tpu_torch.models.fast_forward as ff
    from diffsheg_tpu_torch.ops import fused_layer as ops
    gen = torch.Generator().manual_seed(7)
    T = 68
    mel = torch.randn(1, T, 128, generator=gen).to(dev)
    hub = torch.randn(1, T, 1024, generator=gen).to(dev)
    pid = torch.nn.functional.one_hot(torch.tensor([1]), 30).float().to(dev)
    bf16 = run_stream(beat_cfg("bfloat16", "chain"), model, mel, pid, hub, 5, dev)
    f32k = run_stream(beat_cfg("float32", "chain"), model, mel, pid, hub, 5, dev)
    saved = ff.fused_branch, ff.fused_layer
    ff.fused_branch, ff.fused_layer = (ops.fused_branch_reference,
                                       ops.fused_layer_reference)
    try:
        f32p = run_stream(beat_cfg("float32", "chain"), model, mel, pid, hub,
                          5, dev)
    finally:
        ff.fused_branch, ff.fused_layer = saved
    r16, r32 = rel_rms(bf16, f32p), rel_rms(f32k, f32p)
    log(f"stream[68 frames]: bf16-kernel vs f32-plain rel_rms={r16:.3e} "
        f"(tol 2.5e-2); f32-kernel vs f32-plain rel_rms={r32:.3e} "
        f"(tol 5e-3); |x| max {float(f32p.abs().max()):.3e}")
    if not (torch.isfinite(bf16).all() and r16 < 2.5e-2 and r32 < 5e-3):
        raise AssertionError(f"stream bands failed: {r16:.3e}, {r32:.3e}")
    return {"bf16_rel_rms": r16, "f32_rel_rms": r32}


# --------------------------------------------------------------------------
# phase 5: the serving pipeline end to end
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
    """One pipeline call on ``secs`` of audio with the launch counts set
    to 0 just before and read just after; returns (out, seconds, counts)."""
    from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
    from diffsheg_tpu_torch.ops.fused_layer import fused_branch, fused_layer
    a18 = torch.from_numpy(synth(secs, 18000)).to(dev)
    a16 = torch.from_numpy(synth(secs, 16000)).to(dev)
    pid = torch.nn.functional.one_hot(torch.tensor([1]), 30).float().to(dev)
    torch.cuda.synchronize()
    fused_branch.launches = fused_layer.launches = 0
    t0 = time.perf_counter()
    out = pipe(a18, a16, pid, GeneratorNoise(seed, dev))
    torch.cuda.synchronize()
    secs_taken = time.perf_counter() - t0
    counts = {"fused_branch": fused_branch.launches,
              "fused_layer": fused_layer.launches}
    return out, secs_taken, counts


def phase_e2e(dev, model):
    from diffsheg_tpu_torch.audio.hubert_runner import HubertFeatureExtractor
    from diffsheg_tpu_torch.models.hubert import HubertConfig
    t0 = time.perf_counter()
    hubert_fe = HubertFeatureExtractor(HubertConfig(dtype="bfloat16"), seed=3,
                                       device=dev)
    cfg = beat_cfg("bfloat16", "chain")
    pipe = make_pipeline(cfg, model, hubert_fe, dev)
    log(f"e2e: set-up (random HuBERT-large + model to the card) "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    _, warm_s, _ = drive(pipe, 60, dev, 11)
    out, secs, counts = drive(pipe, 60, dev, 12)
    frames = out.shape[1]
    # stage split of the same call: frontend (mel + HuBERT) alone
    a18 = torch.from_numpy(synth(60, 18000)).to(dev)
    a16 = torch.from_numpy(synth(60, 16000)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mel = pipe.frontend(a18)
    hubert_fe(a16, target_frames=mel.shape[1])
    torch.cuda.synchronize()
    front_s = time.perf_counter() - t0
    log(f"e2e[beat 60 s, bf16, fused_layer=chain]: frames={frames} "
        f"warm_s={warm_s:.3f} seconds={secs:.3f} fps={frames / secs:.1f} "
        f"frontend_s={front_s:.3f} launches={counts} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if tuple(out.shape) != (1, 900, 192) or not torch.isfinite(out).all():
        raise AssertionError(f"bad output {tuple(out.shape)}")
    if counts["fused_branch"] != 2 * 808:
        raise AssertionError(f"fused_branch launched {counts['fused_branch']}"
                             " times, expected 1616")

    # the library default 'auto' runs the per-layer kernel
    pipe = make_pipeline(beat_cfg("bfloat16", "auto"), model, hubert_fe, dev)
    drive(pipe, 10, dev, 13)
    out10, secs10, counts10 = drive(pipe, 10, dev, 14)
    log(f"e2e[beat 10 s, bf16, fused_layer=auto]: frames={out10.shape[1]} "
        f"seconds={secs10:.3f} fps={out10.shape[1] / secs10:.1f} "
        f"launches={counts10}")
    calls = 25 + 4 * 27          # windows at 0, 30, 60, 90, 116
    if (not torch.isfinite(out10).all()
            or counts10["fused_layer"] != 16 * calls
            or counts10["fused_branch"] != 0):
        raise AssertionError(f"auto path: {counts10}")
    return {"fused_branch": counts["fused_branch"],
            "fused_layer": counts10["fused_layer"]}


# --------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("kernels", "stream", "e2e"),
                    default=None, help="run the build and one phase")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import diffsheg_tpu_torch  # noqa: F401  (fails outside a checkout)
    from diffsheg_tpu_torch.ops import build
    from diffsheg_tpu_torch.ops.fused_layer import fused_branch, fused_layer

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build(verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s")

    launches = {"fused_branch": None, "fused_layer": None}
    kres = phase_kernels(dev, args.reps) if args.only in (None, "kernels") \
        else None
    if args.only in (None, "stream", "e2e"):
        from diffsheg_tpu_torch.config import beat_config
        from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
        model = init_unidiffuser(beat_config().model, seed=0)
        if args.only in (None, "stream"):
            phase_stream(dev, model)
        if args.only in (None, "e2e"):
            launches = phase_e2e(dev, model)
    if kres is None:
        return 0
    main_case = kres["beat-ges-bf16"]
    entries = []
    for name, line in (("fused_branch", "ops/fused_layer.py:475"),
                       ("fused_layer", "ops/fused_layer.py:556")):
        r = main_case[name]
        entries.append(dict(
            name=name, route="cuda",
            source="diffsheg_tpu_torch/csrc/fused_layer.cu",
            replaces=f"diffsheg_tpu/{line}",
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
