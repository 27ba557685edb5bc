"""Closed-loop streams: one client sends clips of speech back to back, each
waiting for the motion of the one before (``FusedPipeline.__call__``:
mel, HuBERT, the level cache and the windowed DDIM sampler).

The mix file gives ``clip_seconds`` (every clip the same length, so
every seed does the same work), ``audio_clips`` (the pool of synthetic
clips made at set-up and sent in turn), the program's settings, how many
clips the check compares (``check_clips``) and how many the traced run
traces (``trace_clips``).  Each clip draws a speaker style and fresh
sampler noise from the seed.  ``fps`` is the frames of every clip
completed in the window over the window's seconds; the window ends at a
clip boundary, the first one past ``--seconds``.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark import program, weights
from benchmark.flops import model as flops
from benchmark.reference import precision
from benchmark.reference import sampler as ref_sampler
from benchmark.reference import speech as ref_speech
from benchmark.reference.denoiser import UniDiffuser as RefUniDiffuser
from diffsheg_tpu_torch.diffusion.sampler import NoiseSource

HUBERT_SR = 16000


class SlotNoise(NoiseSource):
    """A clip's sampler noise: one draw per (window, step), made in one
    call from the clip's seed.  Slot 0 of a window is its starting noise,
    slot 1 + s the draw of step s ('gt' on a denoise step, 'undo' on an
    undo step: never both)."""

    def __init__(self, seed: int, windows: int, slots: int, shape, device):
        self.shape, self.slots = tuple(shape), slots
        gen = torch.Generator(device=device).manual_seed(seed)
        self.buf = torch.randn((windows * slots,) + self.shape, generator=gen,
                               device=device)

    def _at(self, window, slot, shape):
        if tuple(shape) != self.shape or not 0 <= slot < self.slots:
            raise ValueError(f"no noise for window {window} slot {slot} "
                             f"shape {tuple(shape)}")
        return self.buf[window * self.slots + slot]

    def initial(self, window, shape, device):
        return self._at(window, 0, shape)

    def step(self, window, step, kind, shape, device):
        if kind not in ("gt", "undo"):
            raise ValueError(f"no {kind!r} noise: eta is 0")
        return self._at(window, 1 + step, shape)


def synth_audio(gen, seconds, rates, device):
    """One clip at each of ``rates``: six partials under a syllable-rate
    envelope plus a little noise, the same partials at every rate."""
    f = 80.0 + 900.0 * torch.rand(6, generator=gen, device=device)
    a = 0.05 + 0.2 * torch.rand(6, generator=gen, device=device)
    ph = 2 * math.pi * torch.rand(7, generator=gen, device=device)
    rate = 2.0 + 4.0 * torch.rand(1, generator=gen, device=device)
    out = []
    for sr in rates:
        t = torch.arange(int(seconds * sr), device=device) / sr
        tone = (a[:, None] * torch.sin(2 * math.pi * f[:, None] * t
                                       + ph[:6, None])).sum(0)
        env = 0.5 + 0.5 * torch.sin(2 * math.pi * rate * t + ph[6])
        noise = 0.02 * torch.randn(t.shape, generator=gen, device=device)
        out.append((tone * env + noise)[None])
    return out


class _Spanned:
    """A callable the pipeline is handed, run inside a benchmark span."""

    def __init__(self, fn, tracer, name):
        self.fn, self.tracer, self.name = fn, tracer, name

    def __call__(self, *args, **kwargs):
        with self.tracer.span(self.name):
            return self.fn(*args, **kwargs)


class _SpannedStream:
    """The streamer the pipeline is handed: ``generate_fused`` in a span."""

    def __init__(self, stream, tracer):
        self.stream, self.tracer = stream, tracer

    def generate_fused(self, *args, **kwargs):
        with self.tracer.span("sampler"):
            return self.stream.generate_fused(*args, **kwargs)


def stream_shape(config):
    """(windows, noise slots a window, a window's (1, T, C), model calls,
    respaced levels) of one clip."""
    m, d = config["model"], config["diffusion"]
    size = config["data"]["n_poses"]
    frames = clip_frames(config)
    K = len(ref_sampler.window_starts(
        frames, size, size - config["stream"]["overlap_len"]))
    sched = ref_sampler.Schedule(d["num_steps"], d["respacing"])
    plain, harm = ref_sampler.programs(sched, d)
    calls = sum(dn for _, dn in plain) + (K - 1) * sum(dn for _, dn in harm)
    C = m["pose_dim"] + m["expression_dim"]
    return K, 1 + max(len(plain), len(harm)), (1, size, C), calls, sched.n


def clip_frames(config):
    return int(config["clip_seconds"] * config["data"]["fps"])


def clip_ops(config):
    """Operations one clip needs (mel, HuBERT, the level cache, every
    model call)."""
    m, data = config["model"], config["data"]
    K, _, shape, calls, levels = stream_shape(config)
    secs = config["clip_seconds"]
    return (flops.mel_ops(int(secs * data["mel_sr"]), data["mel_hop"],
                          data["n_mels"])
            + flops.hubert_ops(config["hubert"], int(secs * HUBERT_SR))
            + K * flops.conditioning_ops(m, 1, shape[1], levels)
            + calls * flops.denoiser_call_ops(m, 1, shape[1]))


class Generator:
    def __init__(self, cell, mix, config, seed, device, tracer):
        self.cell, self.mix, self.seed = cell, mix, seed
        self.device, self.tracer = device, tracer
        self.config = program.merged(config, mix["program"])
        self.config["clip_seconds"] = mix["clip_seconds"]
        self.outputs = {}

    # -- set-up ------------------------------------------------------------
    def _pipeline(self, settings=None):
        from diffsheg_tpu_torch.audio.hubert_runner import \
            HubertFeatureExtractor
        from diffsheg_tpu_torch.audio.mel import MelFrontend
        from diffsheg_tpu_torch.sampling.generator import WindowGenerator
        from diffsheg_tpu_torch.sampling.pipeline import FusedPipeline
        from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator
        conf = program.merged(self.config, settings or {})
        cfg = program.port_config(conf)
        dev = self.device
        model = program.port_denoiser(
            cfg, program.denoiser_state(conf, self.seed, dev), dev)
        hcfg = program.hubert_config(conf, conf["hubert_dtype"])
        hub = program.port_hubert(
            hcfg, program.hubert_state(conf, self.seed, dev), dev)
        stream = StreamingGenerator(WindowGenerator(cfg, model, device=dev))
        del model
        data = conf["data"]
        mel = MelFrontend(sr=data["mel_sr"], hop=data["mel_hop"],
                          n_mels=data["n_mels"], device=dev)
        return FusedPipeline(
            _SpannedStream(stream, self.tracer),
            _Spanned(mel, self.tracer, "frontend"),
            _Spanned(HubertFeatureExtractor(hcfg, model=hub, device=dev),
                     self.tracer, "frontend"))

    def setup(self):
        program.precise(True)
        cfg, dev = self.config, self.device
        self.K, self.slots, self.shape, _, _ = stream_shape(cfg)
        n_audio = self.mix["audio_clips"]
        gen = weights.generator(self.seed, "audio", dev)
        self.audio = [synth_audio(gen, cfg["clip_seconds"],
                                  (cfg["data"]["mel_sr"], HUBERT_SR), dev)
                      for _ in range(n_audio)]
        g = weights.generator(self.seed, "speakers", dev)
        self.speakers = torch.randint(cfg["model"]["style_dim"], (4096,),
                                      generator=g, device=dev).tolist()
        self.pipe = self._pipeline()
        self.serve(-1)      # warm-up: every shape of the cell, every kernel
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def request(self, i):
        """Clip ``i``'s inputs: audio at both rates, style, noise."""
        a18, a16 = self.audio[i % len(self.audio)]
        style = self.speakers[i % len(self.speakers)]
        pid = torch.zeros((1, self.config["model"]["style_dim"]),
                          device=self.device)
        pid[0, style] = 1.0
        noise = SlotNoise(weights.sub_seed(self.seed, f"noise:{i}"), self.K,
                          self.slots, self.shape, self.device)
        return a18, a16, pid, noise

    def serve(self, i, pipe=None):
        a18, a16, pid, noise = self.request(i)
        with self.tracer.span("clip"):
            out = (pipe or self.pipe)(a18, a16, pid, noise)
            return out.cpu()

    # -- the window ----------------------------------------------------------
    def run(self, seconds):
        from diffsheg_tpu_torch.ops import fused_layer
        tracing = self.tracer.enabled
        n_trace = self.mix["trace_clips"]
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        frames = failed = 0
        view = trace_window = facts = None
        before = fused_layer.fused_branch.launches
        t0 = time.perf_counter()
        times, cpu = [], []
        i = 0
        while True:
            t_item, c_item = time.perf_counter(), time.process_time()
            if tracing and i == 0:
                self.tracer.start()
            out = self.serve(i)
            if tracing and i + 1 == n_trace:
                view = self.tracer.stop()
                lo, hi = view.window()
                trace_window = (view.busy(lo, hi), hi - lo)
                facts = self._facts(n_trace,
                                    fused_layer.fused_branch.launches - before)
            ok = (out.shape[1] == clip_frames(self.config)
                  and bool(torch.isfinite(out).all()))
            failed += not ok
            frames += out.shape[1]
            self.outputs[i] = out
            i += 1
            times.append(time.perf_counter() - t_item)
            cpu.append(time.process_time() - c_item)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and (not tracing or i >= n_trace):
                break
        return {"attempted": i, "failed": failed, "item_seconds": times,
                "item_cpu_seconds": cpu,
                "end_to_end": {"fps": frames / elapsed},
                "trace": view, "trace_window": trace_window, "facts": facts}

    def _facts(self, clips, branch_launches):
        return {"config": self.config, "items": clips,
                "branch_launches": branch_launches,
                "model_calls": branch_launches // 2,
                "ops_per_item": clip_ops(self.config),
                "branch_bounds": self._branch_bounds()}

    def _branch_bounds(self):
        """(operations, bytes) of one launch of each branch's kernel."""
        m = self.config["model"]
        rows = 2 if m["classifier_free"] and m["cond_scale"] != 1.0 else 1
        es = 2 if m["compute_dtype"] == "bfloat16" else 4
        return [flops.fused_branch_bound(m, rows, self.shape[1], c, es)
                for c in (0, m["expression_dim"])]

    def free(self):
        self.pipe = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------------
    def checked_clips(self):
        done = sorted(self.outputs)
        rng = np.random.default_rng(weights.sub_seed(self.seed, "check"))
        n = min(self.mix["check_clips"], len(done))
        return sorted(rng.choice(done, size=n, replace=False).tolist())

    def reference(self, clips, fp8=False):
        """The f32 reference's motion for ``clips``, one row each; with
        ``fp8`` its products on e4m3 operands (a control)."""
        program.precise(True)
        cfg, dev = self.config, self.device
        ref = weights.build(RefUniDiffuser, cfg["model"],
                            state=program.denoiser_state(cfg, self.seed, dev),
                            device=dev).eval()
        hub = weights.build(ref_speech.Hubert, cfg["hubert"],
                            state=program.hubert_state(cfg, self.seed, dev),
                            device=dev).eval()
        if fp8:
            precision.to_fp8_(ref)
            precision.to_fp8_(hub)
        data = cfg["data"]
        mels, hubs, pids, noises = [], [], [], []
        with torch.no_grad():
            for i in clips:
                a18, a16, pid, noise = self.request(i)
                mel = ref_speech.mel_spectrogram(a18, data["mel_sr"],
                                                 data["mel_hop"],
                                                 data["n_mels"])
                mels.append(mel)
                hubs.append(ref_speech.hubert_features(hub, a16, mel.shape[1]))
                pids.append(pid)
                noises.append(noise)
            del hub
            sched = ref_sampler.Schedule(cfg["diffusion"]["num_steps"],
                                         cfg["diffusion"]["respacing"])
            out = ref_sampler.sample_stream(
                ref, cfg, sched, torch.cat(mels), torch.cat(pids),
                torch.cat(hubs), noises)
        return out.cpu()

    def check(self):
        limit = self.cell["limits"]["window_rel_rms"]
        clips = self.checked_clips()
        if not clips:
            return {"window_rel_rms": {"value": float("inf"), "limit": limit}}
        ref = self.reference(clips)
        step = self.config["data"]["n_poses"] - self.config["stream"]["overlap_len"]
        worst = max(max(window_errors(self.outputs[i][0], ref[k], step))
                    for k, i in enumerate(clips))
        return {"window_rel_rms": {"value": worst, "limit": limit}}


def rel_rms(x, ref):
    """||x - ref|| / ||ref||."""
    x, ref = x.double(), ref.double()
    return float((x - ref).norm() / ref.norm())


def window_errors(x, ref, step):
    """rel_rms of each stretch of ``step`` frames (a window's new frames)
    of a clip's motion (frames, channels)."""
    return [rel_rms(x[a:a + step], ref[a:a + step])
            for a in range(0, ref.shape[0], step)]
