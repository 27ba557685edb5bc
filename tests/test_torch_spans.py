"""The port's spans (``utils/profiling.py``): off without a profiler, the
records and ``diffsheg/`` ranges of a three-window stream under a CPU
``torch.profiler``, the buffer's capacity, and threads that share it.

The stream is the port half of ``test_torch_pipeline.py``'s three-window
pipeline (windows at 0, 30 and 46), on seeded random weights: no JAX.
The timing check is loose (1 ms) on purpose: the tests share the CPU
with other workers.
"""

import dataclasses
import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffsheg_tpu_torch.utils import profiling  # noqa: E402
from diffsheg_tpu_torch.utils.profiling import (SpanRecorder,  # noqa: E402
                                                clear_spans, recorded_spans,
                                                span)

HUB = dict(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
           conv_dim=(8, 8, 8, 8, 8, 8, 8))
T = 80   # motion frames: windows at 0, 30 and 46


def _audio(n, seed):
    t = np.arange(n) / 16000.0
    rng = np.random.RandomState(seed)
    return torch.tensor((0.3 * np.sin(2 * np.pi * 220 * t)
                         + 0.1 * rng.randn(n)).astype(np.float32)[None])


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """Two pipeline calls of a three-window stream under a CPU profiler:
    the records, the exported trace's ``diffsheg/`` ranges (ts, dur in
    us), the generator and the window count."""
    from diffsheg_tpu_torch.audio.hubert_runner import HubertFeatureExtractor
    from diffsheg_tpu_torch.audio.mel import MelFrontend
    from diffsheg_tpu_torch.config import beat_config
    from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
    from diffsheg_tpu_torch.models.factory import build_denoiser, random_init_
    from diffsheg_tpu_torch.models.hubert import HubertConfig
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator
    from diffsheg_tpu_torch.sampling.pipeline import FusedPipeline
    from diffsheg_tpu_torch.sampling.streamer import (StreamingGenerator,
                                                      window_starts)

    cfg = beat_config()
    cfg = cfg.replace(
        model=dataclasses.replace(
            cfg.model, latent_dim=64, num_layers=2, num_heads=4, ff_size=128,
            hubert_dim=HUB["hidden_size"], hubert_latent_dim=32),
        diffusion=dataclasses.replace(cfg.diffusion, jump_n_sample=2,
                                      fused_layer="chain", fused_step="jnp"))
    starts = window_starts(T, cfg.data.n_poses,
                           cfg.data.n_poses - cfg.stream.overlap_len)
    assert starts == [0, 30, 46] and not cfg.stream.fix_very_first
    gen = WindowGenerator(cfg, random_init_(build_denoiser(cfg.model), 31),
                          device="cpu")
    pipe = FusedPipeline(StreamingGenerator(gen),
                         MelFrontend(sr=18000, hop=1200, device="cpu"),
                         HubertFeatureExtractor(HubertConfig(**HUB), seed=32,
                                                device="cpu"))
    a18, a16 = _audio(T * 1200, 33), _audio(T * 16000 // 15, 34)
    pid = torch.eye(cfg.model.style_dim)[[2]]
    clear_spans()
    with _profiled() as prof:
        for seed in (35, 36):
            out = pipe(a18, a16, pid, GeneratorNoise(seed, "cpu"))
    records = recorded_spans()
    clear_spans()
    assert out.shape == (1, T, 192) and torch.isfinite(out).all()
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"
              and e.get("name", "").startswith(profiling.SPAN_PREFIX)]
    return records, ranges, gen, len(starts)


def test_span_is_off_without_a_profiler():
    clear_spans()
    first, second = span("pipeline"), span("sampler.call")
    assert first is second
    with first:
        with second:
            pass
    assert recorded_spans() == []
    assert profiling.RECORDER.dropped == 0


def test_pipeline_call_nests_its_stages(stream):
    records, _, _, _ = stream
    tops = [i for i, r in enumerate(records) if r.parent < 0]
    assert [records[i].name for i in tops] == ["pipeline", "pipeline"]
    for top in tops:
        children = [r.name for r in records if r.parent == top]
        assert children == ["frontend.mel", "frontend.hubert", "sampler"]


def test_one_call_span_a_model_call(stream):
    records, _, gen, K = stream
    calls = [r for r in records if r.name == "sampler.call"]
    per_clip = (gen.num_model_calls_plain
                + (K - 1) * gen.num_model_calls_repaint)
    assert len(calls) == 2 * per_clip
    # each denoise step's update, and every undo step, in its own span
    updates = [r for r in records if r.name == "sampler.update"]
    assert len(updates) >= len(calls)
    names = {r.name for r in records}
    assert names == {"pipeline", "frontend.mel", "frontend.hubert",
                     "sampler", "sampler.call", "sampler.update"}


def test_parents_and_requests(stream):
    records, _, _, _ = stream
    sampler = {i for i, r in enumerate(records) if r.name == "sampler"}
    for i, r in enumerate(records):
        assert 0 < r.start_ns <= r.end_ns
        if r.parent < 0:
            assert r.request == i
            continue
        up = records[r.parent]
        assert r.parent < i and r.request == up.request
        assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns
        assert records[r.request].name == "pipeline"
        if r.name.startswith("sampler."):
            assert r.parent in sampler


def test_trace_ranges_match_the_records(stream):
    records, ranges, _, _ = stream
    assert len(ranges) == len(records)
    # parents first where two ranges open in the same microsecond
    ranges = sorted(ranges, key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in ranges] == [profiling.SPAN_PREFIX + r.name
                                           for r in records]
    lo = [e["ts"] for e in ranges]
    hi = [e["ts"] + e["dur"] for e in ranges]
    for i, r in enumerate(records):
        if r.parent >= 0:
            assert lo[r.parent] <= lo[i] and hi[i] <= hi[r.parent]
    # one offset (us) maps every record onto its range
    offset = float(np.median([a - r.start_ns / 1e3
                              for a, r in zip(lo, records)]))
    for r, a, b in zip(records, lo, hi):
        assert abs(r.start_ns / 1e3 + offset - a) <= 1e3
        assert abs(r.end_ns / 1e3 + offset - b) <= 1e3


def test_buffer_drops_past_its_capacity():
    rec = SpanRecorder(capacity=3)
    with _profiled():
        with rec.span("pipeline"):
            for _ in range(4):
                with rec.span("sampler.call"):
                    pass
    got = rec.records()
    assert [r.name for r in got] == ["pipeline", "sampler.call",
                                     "sampler.call"]
    assert rec.dropped == 2 and len(rec._records) == 3
    assert [r.parent for r in got] == [-1, 0, 0]
    assert rec.records() == got          # reading does not clear
    rec.clear()
    assert rec.records() == [] and rec.dropped == 0


def test_threads_keep_their_own_nesting():
    """Eight threads, each opening nested spans on one recorder with a
    short switch interval: every child's parent is its own thread's
    span."""
    rec = SpanRecorder()
    n_threads, n_outer = 8, 40
    errors = []

    def work(k):
        try:
            for _ in range(n_outer):
                with rec.span(f"pipeline.{k}"):
                    for _ in range(3):
                        with rec.span(f"sampler.call.{k}"):
                            pass
        except Exception as e:   # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiled():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    got = rec.records()
    assert len(got) == n_threads * n_outer * 4 and rec.dropped == 0
    for i, r in enumerate(got):
        k = r.name.rsplit(".", 1)[1]
        if r.name.startswith("pipeline"):
            assert r.parent == -1 and r.request == i
        else:
            assert got[r.parent].name == f"pipeline.{k}"
            assert r.request == r.parent
        assert r.end_ns >= r.start_ns > 0
