"""The training cells added with WavLM-Large: a tiny dry run of the
frontend cell and of the data-parallel generator on the CPU, the
generator's processes, the training spans on the trace's clock
(``train_spans.py``) with the three readers of them, and the encoder's
operation count.  The data-parallel cell is not in BENCHMARK.json (its
runs on 4 cards spread too far for its bound, PERF.md section 7); the
tests add its entry themselves (:class:`DpLoader`).

Data-parallel runs start real processes (gloo on the CPU): 2 equal 1 to
rounding, and a rank that raises ends the run with an error within
seconds, with no process left behind.
"""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import ROOT, Loader, run_cell
from benchmark.tests.tiny import dry_run, tiny
from benchmark.tracing import DeviceOp, TraceView

profiling = pytest.importorskip("diffsheg_tpu_torch.utils.profiling")
SpanRecord = profiling.SpanRecord
US = 1e-6
OFF = 3.0    # the view's clock minus the records'

# the data-parallel cell's entry as BENCHMARK.json would hold it
DP_CELL = {"name": "beat-train-dp4-f32", "config": "beat",
           "traffic": "train-dp4-f32", "chips": 4,
           "why": "the reference's DDP training at its global batch over 4 "
                  "cards: the all-reduce and the per-card step at 625 rows"}


class DpLoader(Loader):
    """The benchmark's files with the data-parallel cell among its cells."""

    def spec(self) -> dict:
        spec = super().spec()
        spec["workloads"].append(DP_CELL)
        return spec


def dp_run(processes, seed=7, **mix):
    def over(c, m):
        c, m = tiny(c, m)
        m.update(processes=processes, join_timeout_s=60, **mix)
        return c, m
    torch.manual_seed(0)
    return run_cell(DpLoader(), "beat-train-dp4-f32", seed, 0.1, False,
                    torch.device("cpu"), time.perf_counter(), overrides=over)


def test_frontend_cell_dry_run_is_correct():
    res = dry_run("beat-wavlm-train-fe-f32")
    assert res["correct"] and res["attempted"] >= 1
    c = res["checks"]
    # f32 on both sides at the tiny size: rounding only
    assert c["encoder_window_rel_rms"]["value"] < 1e-5
    assert c["loss_rel_gap"]["value"] < 1e-5
    assert c["first_grad_leaf_gap"]["value"] < 1e-5
    assert c["change_leaf_gap"]["value"] < 1e-4


def test_frontend_cell_without_the_gate_is_not_correct(monkeypatch):
    from diffsheg_tpu_torch.models import hubert
    monkeypatch.setattr(hubert.GatedRelPosAttention, "bias",
                        lambda self, x, position_bias: position_bias)
    res = dry_run("beat-wavlm-train-fe-f32")
    assert not res["correct"]
    assert res["checks"]["encoder_window_rel_rms"]["value"] > 1e-2


@pytest.mark.parametrize("processes", [1, 2])
def test_dp_cell_dry_run_is_correct(processes):
    res = dp_run(processes)
    assert res["correct"] and res["attempted"] >= 1


def dp_generator(processes, seed=7):
    """The data-parallel generator at the tiny size, set up (its check
    steps taken) and its processes ended."""
    from benchmark.tracing import Tracer
    loader = DpLoader()
    entry = loader.cell("beat-train-dp4-f32")
    config, mix = tiny(loader.config("beat"), loader.traffic(entry["traffic"]))
    mix.update(processes=processes, join_timeout_s=60)
    gen = loader.generator("train_dp").Generator(
        entry, mix, config, seed, torch.device("cpu"), Tracer(False, ""))
    gen.setup()
    gen.free()
    return gen


def test_two_gloo_processes_equal_one():
    # one first: a later group in the same process must still reduce over
    # its own processes (the BatchNorm sums once took the first group's)
    from benchmark.traffic.train import compare
    one, two = dp_generator(1), dp_generator(2)
    # as the check measures them, one process standing for the reference:
    # rounding only (the reduction order of the gradients differs)
    gaps = compare({"loss_rel_gap": 0, "first_grad_leaf_gap": 0,
                    "change_leaf_gap": 0},
                   two.losses, two.first_grad, two.change,
                   one.losses, one.first_grad, one.change)
    assert gaps["loss_rel_gap"]["value"] < 1e-6
    assert gaps["first_grad_leaf_gap"]["value"] < 1e-5
    assert gaps["change_leaf_gap"]["value"] < 1e-4


@pytest.mark.parametrize("rank", [0, 1])
def test_a_rank_that_raises_ends_the_run(rank):
    """In a process of its own (rank 0's watcher ends its process with
    ``os._exit`` when a child dies): an error within seconds, and no
    child left running."""
    code = f"""
import sys, time, torch
sys.path.insert(0, {str(ROOT)!r})
from benchmark.harness import run_cell
from benchmark.tests.test_harness_train_cells import DpLoader
from benchmark.tests.tiny import tiny
def over(c, m):
    c, m = tiny(c, m)
    m.update(processes=2, join_timeout_s=60, fail_rank={rank})
    return c, m
run_cell(DpLoader(), "beat-train-dp4-f32", 7, 0.1, False, torch.device("cpu"),
         time.perf_counter(), overrides=over)
"""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert f"rank {rank} fails on purpose" in proc.stderr
    assert time.perf_counter() - t0 < 60
    left = subprocess.run(["pgrep", "-f", r"train_dp\.py .*fail_rank"],
                          capture_output=True, text=True).stdout.split()
    assert left == []


def scene(steps=2, frontend=True, allreduce=False):
    """Traced steps of 1000 us each: the benchmark's ``frontend`` span
    (0-400 us) and ``step`` span (410-990); the program's records of the
    same calls 2 us inside each, on a clock ``OFF`` behind the view's;
    encoder operations in the frontend, an all-reduce in the step."""
    spans, ops, rows = {"traced": [(0, 1000 * US * steps)]}, [], []
    for k in range(steps):
        t0 = 1000 * k
        if frontend:
            spans.setdefault("frontend", []).append((t0 * US, (t0 + 400) * US))
            rows += [("train.frontend.mel", t0 + 2, t0 + 20),
                     ("train.frontend.encoder", t0 + 22, t0 + 398)]
            ops += [DeviceOp("mel", (t0 + 5) * US, (t0 + 15) * US,
                             (t0 + 3) * US),
                    DeviceOp("gemm", (t0 + 30) * US, (t0 + 330) * US,
                             (t0 + 25) * US)]
        spans.setdefault("step", []).append(((t0 + 410) * US, (t0 + 990) * US))
        rows.append(("train.step", t0 + 412, t0 + 988))
        ops.append(DeviceOp("gemm_tf32x3", (t0 + 420) * US, (t0 + 800) * US,
                            (t0 + 415) * US))
        if allreduce:
            rows.append(("train.allreduce", t0 + 900, t0 + 950))
            ops.append(DeviceOp("ncclAllReduce", (t0 + 905) * US,
                                (t0 + 945) * US, (t0 + 901) * US))

    def ns(t_us):
        return round((t_us * US - OFF) * 1e9)

    recs = [SpanRecord(n, ns(a), ns(b), -1, -1) for n, a, b in rows]
    return TraceView(ops, spans), recs


def test_training_spans_are_placed_and_read(monkeypatch):
    view, recs = scene(allreduce=True)
    monkeypatch.setattr(profiling, "recorded_spans", lambda: list(recs))
    h = Loader().config("beat-wavlm")["hubert"]
    from benchmark.flops import speech_encoder
    ops = 2500 * speech_encoder.window_ops(h, 36266)
    facts = {"items": 2, "encoder_ops_per_step": ops}
    loader = Loader()
    enc_ms = loader.metric_reader("speech_encoder_ms.train").read(view, facts)
    assert enc_ms == pytest.approx(0.300)    # 300 us a step
    mfu = loader.metric_reader("speech_encoder_mfu_pct.train").read(
        view, facts)
    assert mfu == pytest.approx(100 * ops / (300e-6 * 495e12))
    ar = loader.metric_reader("allreduce_ms.train").read(view, facts)
    assert ar == pytest.approx(0.040)


def test_training_spans_read_nothing_without_records(monkeypatch):
    view, recs = scene(frontend=False)
    loader = Loader()
    monkeypatch.setattr(profiling, "recorded_spans", lambda: [])
    for name in ("speech_encoder_ms.train", "speech_encoder_mfu_pct.train",
                 "allreduce_ms.train"):
        assert loader.metric_reader(name).read(
            view, {"items": 2, "encoder_ops_per_step": 1.0}) is None
    # one process: spans, but no all-reduce in them
    monkeypatch.setattr(profiling, "recorded_spans", lambda: list(recs))
    assert loader.metric_reader("allreduce_ms.train").read(
        view, {"items": 2}) is None


def test_unequal_counts_place_nothing(monkeypatch):
    from benchmark.train_spans import program_view
    view, recs = scene()
    monkeypatch.setattr(profiling, "recorded_spans", lambda: list(recs[:-1]))
    assert program_view(view) is None


def test_encoder_operations_from_shapes():
    from benchmark.flops import speech_encoder as s
    h = Loader().config("beat-wavlm")["hubert"]
    assert s.frames(h, 36266) == 113
    T, H = 113, 1024
    conv = s.conv_ops(h, 36266)
    layer = (2 * T * 4 * H * H + 4 * T * T * H + 4 * T * H * 4096
             + 2 * T * H * 8 + 2 * 16 * T * T)
    assert s.window_ops(h, 36266) == (conv + 2 * T * 512 * H
                                      + 2 * T * H * 64 * 128 + 24 * layer)
    # ~82.7 GFLOP a window, ~11.1 of them in the conv stack
    assert 82e9 < s.window_ops(h, 36266) < 83.5e9
    assert 11e9 < conv < 11.3e9
    hub = Loader().config("beat")["hubert"]
    assert s.window_ops(hub, 36266) < s.window_ops(h, 36266)


def test_configuration_names_its_source_and_cuts_nothing():
    spec = Loader().spec()
    entry = next(c for c in spec["configs"] if c["name"] == "beat-wavlm")
    assert entry["reduced"] == []
    conf = Loader().config("beat-wavlm")
    beat = Loader().config("beat")
    for group in ("model", "diffusion", "stream", "data", "train"):
        assert conf[group] == beat[group]
    assert conf["hubert"]["rel_pos_buckets"] == 320
    assert conf["hubert"]["conv_bias"] is False
    assert conf["source"] == entry["source"]
    assert json.dumps(conf["assumed"])
