"""The idle-share and span arithmetic on a small synthetic profiler
timeline, and the per-layer readers on it."""

import json

import pytest

from benchmark.harness import Loader
from benchmark.tracing import breakdown, read_chrome_trace


def event(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.fixture
def view(tmp_path):
    """A traced window of 1000 us: a frontend span (launches 1, 2) and a
    sampler span (launches 3, 4, 5: two branch kernels and a copy); the
    device busy 100-150, 180-200 (frontend) and 400-500, 520-560, 560-580
    (sampler), idle the rest."""
    us = [
        event("user_annotation", "bench/traced", 0, 1000),
        event("user_annotation", "bench/clip", 0, 900),
        event("user_annotation", "bench/frontend", 50, 150),
        event("user_annotation", "bench/sampler", 300, 400),
        event("cpu_op", "aten::mm", 60, 5),
        event("cuda_runtime", "cudaLaunchKernel", 60, 2, corr=1),
        event("cuda_runtime", "cudaLaunchKernel", 70, 2, corr=2),
        event("cuda_runtime", "cudaLaunchKernel", 310, 2, corr=3),
        event("cuda_runtime", "cudaLaunchKernel", 320, 2, corr=4),
        event("cuda_runtime", "cudaMemcpyAsync", 330, 2, corr=5),
        event("kernel", "ampere_bf16_gemm", 100, 50, corr=1),
        event("kernel", "conv_kernel", 180, 20, corr=2),
        event("kernel", "void fused_layers_kernel<bf16, 0>(Args)", 400, 100,
              corr=3),
        event("kernel", "void fused_layers_kernel<bf16, 0>(Args)", 520, 40,
              corr=4),
        event("gpu_memcpy", "Memcpy DtoH", 560, 20, corr=5),
        {"ph": "f", "cat": "ac2g", "ts": 1},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": us}))
    return read_chrome_trace(str(path))


def test_busy_gaps_and_spans(view):
    assert view.window() == pytest.approx((0.0, 1000e-6))
    lo, hi = view.window()
    assert view.busy(lo, hi) == pytest.approx(230e-6)
    gaps = view.gaps(lo, hi)
    assert [(round(a * 1e6), round(b * 1e6)) for a, b in gaps] == [
        (0, 100), (150, 180), (200, 400), (500, 520), (580, 1000)]
    assert view.busy(300e-6, 700e-6) == pytest.approx(160e-6)
    front = view.launched_in("frontend")
    assert sorted(op.name for op in front) == ["ampere_bf16_gemm",
                                              "conv_kernel"]
    assert len(view.launched_in("sampler")) == 3
    assert view.innermost_span(310e-6) == "sampler"
    assert view.innermost_span(950e-6) == "traced"


def test_breakdown_names_gaps_by_span(view):
    b = breakdown(view)
    assert b["device_ops"][0] == [
        "void fused_layers_kernel<bf16, 0>(Args)", pytest.approx(140e-6)]
    # each gap is named by the innermost span open when it began
    assert b["idle_gaps"][0] == ["sampler", pytest.approx(420e-6)]
    assert b["idle_gaps"][1] == ["frontend", pytest.approx(200e-6)]
    assert b["idle_gaps"][2] == ["clip", pytest.approx(100e-6)]


def read(name, view, facts):
    return Loader().metric_reader(name).read(view, facts)


def test_stream_readers(view):
    facts = {"items": 1, "model_calls": 2, "branch_launches": 2,
             "ops_per_item": 989e12 * 1e-3 * 0.25,
             "branch_bounds": [(0, 3.35e12 * 10e-6), (0, 3.35e12 * 10e-6)],
             "config": {"model": {"compute_dtype": "bfloat16"}}}
    assert read("frontend_ms.stream", view, facts) == pytest.approx(0.070)
    # the sampler span 300-700 us: 160 us busy, 240 idle over 2 calls
    assert read("sampler_idle_ms_per_call.stream", view,
                facts) == pytest.approx(0.120)
    assert read("device_idle_pct.stream", view, facts) == pytest.approx(77.0)
    assert read("mfu_pct.stream", view, facts) == pytest.approx(25.0)
    # 2 launches of 10 us bound (one each branch) over 140 us of kernel
    assert read("branch_roofline_pct.stream", view,
                facts) == pytest.approx(100 * 20 / 140)


def test_readers_return_none_with_nothing_to_read(view):
    facts = {"items": 1, "model_calls": 0, "branch_launches": 0,
             "linear_attention_launches": {}, "config": {}}
    for name in ("sampler_idle_ms_per_call.stream",
                 "branch_roofline_pct.stream",
                 "linear_attention_roofline_pct.train",
                 "peak_mem_gib.train"):
        assert read(name, view, facts) is None


def test_train_readers(view):
    facts = {"items": 2, "ops_per_item": 495e12 * 1e-3 * 0.5,
             "linear_attention_launches": {}, "peak_bytes": 3 * 2 ** 30}
    assert read("products_ms_per_step.train", view,
                facts) == pytest.approx(0.035)
    assert read("mfu_pct.train", view, facts) == pytest.approx(100.0)
    assert read("peak_mem_gib.train", view, facts) == pytest.approx(3.0)
