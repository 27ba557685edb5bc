"""The program's spans on the trace's clock (``program_spans.py``) and
the five readers of them, on a synthetic view and synthetic records.

Traced clips of 1000 us each: the benchmark's ``frontend`` spans around
mel (50-100) and HuBERT (110-200), its ``sampler`` span (300-700); the
program's records of the same calls 2 us inside each, on a clock
``OFF`` seconds behind the view's, each record's start moved by a jitter;
two model calls with their launches, two updates; device operations well
inside the spans they were launched in.
"""

import random

import pytest

from benchmark import program_spans
from benchmark.harness import Loader
from benchmark.tracing import DeviceOp, TraceView

profiling = pytest.importorskip("diffsheg_tpu_torch.utils.profiling")
SpanRecord = profiling.SpanRecord

US = 1e-6
OFF = 5.0    # the view's clock minus the records'
READERS = ("mel_ms.stream", "hubert_ms.stream", "call_idle_ms.stream",
           "update_idle_ms.stream", "launch_us.stream")


def scene(jitters=((0.0, 1.0, 3.0),), extra=()):
    """The view, and the records of one clip a ``jitters`` entry (clip k
    1000 us after clip k - 1; its entry's us added to the record starts
    of mel, HuBERT and the sampler: their pairs' offsets)."""
    spans, ops, rows = {"traced": [(0, 1000 * US * len(jitters))]}, [], []
    for k, jitter in enumerate(jitters):
        t0 = 1000 * k
        for name, a, b in (("clip", 0, 900), ("frontend", 50, 100),
                           ("frontend", 110, 200), ("sampler", 300, 700)):
            spans.setdefault(name, []).append(((t0 + a) * US, (t0 + b) * US))
        ops += [DeviceOp(name, (t0 + a) * US, (t0 + b) * US, (t0 + at) * US)
                for name, a, b, at in (
                    ("mel_op", 60, 80, 60), ("hubert_gemm", 130, 170, 120),
                    ("fused_layers_kernel", 330, 390, 320),
                    ("fused_layers_kernel", 470, 520, 460),
                    ("elementwise", 620, 640, 610))]
        top = len(rows)
        rows += [  # name, start us, end us (view clock), parent, request
            (name, t0 + a, t0 + b, -1 if parent is None else top + parent,
             top) for name, a, b, parent in (
                ("pipeline", 40, 890, None),
                ("frontend.mel", 52 + jitter[0], 98, 0),
                ("frontend.hubert", 112 + jitter[1], 198, 0),
                ("sampler", 302 + jitter[2], 698, 0),
                ("sampler.call", 310, 400, 3),
                ("launch.fused_branch", 315, 325, 4),
                ("sampler.update", 400, 450, 3),
                ("sampler.call", 450, 550, 3),
                ("launch.fused_branch", 455, 469, 7),
                ("sampler.update", 550, 600, 3))]
    rows += list(extra)

    def ns(t_us):
        return round((t_us * US - OFF) * 1e9)

    recs = [SpanRecord(n, ns(a), ns(b), p, r) for n, a, b, p, r in rows]
    return TraceView(ops, spans), recs


@pytest.fixture
def given(monkeypatch):
    """Makes the port's recorder hand out ``recs``."""
    def use(recs):
        monkeypatch.setattr(profiling, "recorded_spans", lambda: list(recs))
    return use


def read(name, view, items=1):
    return Loader().metric_reader(name).read(view, {"items": items})


def test_program_view_takes_the_soonest_pair(given):
    view, recs = scene(((0.0, 1.0, 3.0),))
    given(recs)
    # each record 2 us (+ its jitter) after its benchmark span opens and
    # 2 us before it closes
    lo, hi = program_spans.bounds(view, recs)
    assert (lo - OFF, hi - OFF) == pytest.approx((-2 * US, 2 * US),
                                                 abs=1e-9)
    pv = program_spans.program_view(view)
    off = OFF - 2 * US     # the soonest pair: mel's
    (a, b), = pv.spans["frontend.mel"]
    assert (a, b) == pytest.approx((52 * US + off - OFF, 98 * US + off - OFF),
                                   abs=1e-9)
    assert len(pv.spans["sampler.call"]) == 2
    assert pv.spans["sampler"] == view.spans["sampler"]    # bench span kept
    assert pv.spans["frontend"] == view.spans["frontend"]
    assert [o.name for o in pv.launched_in("frontend.hubert")] == [
        "hubert_gemm"]


@pytest.mark.parametrize("case", ["extra_mel", "no_sampler", "mel_outside",
                                  "sampler_outside", "no_bench_span"])
def test_program_view_refuses(given, case):
    if case == "extra_mel":       # three frontend records, two bench spans
        view, recs = scene(extra=[("frontend.mel", 205, 210, 0, 0)])
    elif case == "no_sampler":
        view, recs = scene()
        recs = [r for r in recs if r.name != "sampler"]
    elif case == "mel_outside":   # a record that opens 5 us before its
        # benchmark span, against the others' 2 us of room at the close
        view, recs = scene(((0.0, 0.0, 0.0), (-7.0, 0.0, 0.0)))
    elif case == "sampler_outside":
        view, recs = scene(((0.0, 0.0, -7.0), (0.0, 0.0, 0.0)))
    else:
        view, recs = scene()
        view.spans.pop("frontend")
    given(recs)
    assert program_spans.program_view(view) is None


@pytest.mark.parametrize("jitters", [
    ((0.0, 0.0, 0.0), (0.0, 200.0, 0.0)),     # one pair 200 us late
    ((0.0, 30.0, 60.0), (2.0, 31.0, 61.0))],  # sites 60 us apart
    ids=["late_pair", "sites_apart"])
def test_program_view_takes_pairs_that_open_late(given, jitters):
    view, recs = scene(jitters)
    given(recs)
    pv = program_spans.program_view(view)
    assert pv is not None
    # placed by the soonest pair (2 us after its benchmark span)
    (a, _), _ = pv.spans["frontend.mel"]
    assert a == pytest.approx(50 * US, abs=1e-9)


@pytest.mark.parametrize("clips", [1, 2])
def test_stream_readers(given, clips):
    view, recs = scene(((0.0, 1.0, 3.0), (2.0, 0.0, 1.0))[:clips])
    given(recs)
    assert read("mel_ms.stream", view, clips) == pytest.approx(0.020)
    assert read("hubert_ms.stream", view, clips) == pytest.approx(0.040)
    # calls 310-400 (60 busy) and 450-550 (50 busy): 80 us idle, 2 calls
    assert read("call_idle_ms.stream", view, clips) == pytest.approx(0.040)
    # updates 400-450 and 550-600, idle through: 100 us over 2 calls
    assert read("update_idle_ms.stream", view,
                clips) == pytest.approx(0.050)
    # launches of 10 and 14 us
    assert read("launch_us.stream", view, clips) == pytest.approx(12.0)


@pytest.mark.parametrize("case", ["no_recorder", "no_records",
                                  "unplaceable"])
@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_with_nothing_to_read(given, monkeypatch, name,
                                                  case):
    view, recs = scene()
    if case == "no_recorder":     # a program without spans
        monkeypatch.delattr(profiling, "recorded_spans")
    elif case == "no_records":
        given([])
    else:                         # records that cannot be placed or read
        given([r for r in recs if r.name not in (
            "frontend.mel", "launch.fused_branch")])
    assert read(name, view) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_idle_seconds_matches_busy_span_by_span(seed):
    rng = random.Random(seed)
    ops = []
    for _ in range(60):
        a = rng.uniform(0, 1e-3)
        ops.append(DeviceOp("k", a, a + rng.uniform(1e-6, 4e-5), None))
    view = TraceView(ops, {})
    spans = []
    for _ in range(25):
        a = rng.uniform(0, 1e-3)
        spans.append((a, a + rng.uniform(0, 1e-4)))
    want = sum((b - a) - view.busy(a, b) for a, b in spans)
    assert program_spans.idle_seconds(view, spans) == pytest.approx(
        want, abs=1e-12)
    assert program_spans.idle_seconds(view, []) == 0.0
