"""The examples of the port (``diffsheg_tpu_torch/examples/``) against the
JAX repository's scripts (``examples/*.py``).

For each of the ten scripts: its configuration equals the JAX script's,
field for field (the JAX script's own code runs until it hands the
configuration to its first heavy call, which the test replaces by a
capture); its synthetic data equal JAX's bit for bit; its ``main`` runs
under ``--device cpu`` at a tiny width and prints what the JAX script
prints (the same JSON keys, or the same line forms).  Without a card and
without ``--device cpu`` each exits non-zero.  ``train_bench``'s operation
count is held against the analytic sum over the step's products.
"""

import argparse
import ast
import contextlib
import dataclasses
import functools
import importlib
import importlib.util
import io
import json
import os
import re
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (one intra-op thread)
from diffsheg_tpu_torch import config as tconfig  # noqa: E402
from diffsheg_tpu_torch.models.hubert import HubertConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("batch_probe", "convergence_demo", "live_demo", "live_hubert_drift",
         "live_latency", "overfit_demo", "perf_probe", "serve_capacity",
         "show_bench", "train_bench")
CALIB_KEYS = {"backend", "device_kind", "calib_tflops", "dispatch_ms",
              "valid"}
TINY_HUB = HubertConfig(hidden_size=16, num_layers=1, num_heads=2,
                        intermediate_size=32, conv_dim=(8,) * 7)


class Captured(Exception):
    def __init__(self, **kw):
        super().__init__(sorted(kw))
        self.kw = kw


def port(name):
    return importlib.import_module(f"diffsheg_tpu_torch.examples.{name}")


def jax_path(name):
    return os.path.join(ROOT, "examples", f"{name}.py")


def jax_script(name, monkeypatch):
    """The JAX script as a fresh module (its persistent compilation cache
    left off)."""
    import diffsheg_tpu.utils.compile_cache as cc
    monkeypatch.setattr(cc, "enable_persistent_cache", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(f"_jax_example_{name}",
                                                  jax_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_dicts(name, anchor):
    """The string keys of every dict literal of the JAX script that has
    the key ``anchor``."""
    tree = ast.parse(open(jax_path(name)).read())
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys
                    if isinstance(k, ast.Constant) and isinstance(k.value,
                                                                  str)}
            if anchor in keys:
                found.append(keys)
    assert found, (name, anchor)
    return found


def cfg_dict(cfg):
    return dataclasses.asdict(cfg)


def tiny(cfg, **model):
    """A preset at a tiny width (the scripts' own overrides on top)."""
    return cfg.replace(model=dataclasses.replace(
        cfg.model, latent_dim=32, num_layers=1, num_heads=2, ff_size=64,
        hubert_dim=16, hubert_latent_dim=8, **model))


def tiny_preset(preset):
    return lambda: tiny(getattr(tconfig, f"{preset}_config")())


def no_jax_model(monkeypatch):
    monkeypatch.setattr("diffsheg_tpu.models.unidiffuser.init_unidiffuser",
                        lambda *a, **k: (None, None))


def capture_at(monkeypatch, target, **fixed):
    """Replace ``target`` by a function that raises :class:`Captured`
    with its arguments."""
    def grab(*args, **kw):
        raise Captured(args=args, kw=kw, **fixed)
    monkeypatch.setattr(target, grab)


def run_main(fn, *args, **kw):
    """(stdout, stderr, exit code) of ``fn(*args, **kw)``."""
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            fn(*args, **kw)
        except SystemExit as e:
            code = e.code
    return out.getvalue(), err.getvalue(), code


def json_lines(text):
    return [json.loads(s) for s in text.splitlines() if s.startswith("{")]


def fake(**methods):
    """A class whose instances take any arguments and have ``methods``."""
    return type("Fake", (), {"__init__": lambda self, *a, **k: None,
                             **methods})


# --------------------------------------------------------------------------
# every script: its counterpart, its imports, its device
# --------------------------------------------------------------------------

def test_every_jax_example_has_a_counterpart():
    ref = sorted(n[:-3] for n in os.listdir(os.path.join(ROOT, "examples"))
                 if n.endswith(".py"))
    assert tuple(ref) == NAMES
    for name in NAMES:
        assert os.path.exists(os.path.join(
            ROOT, "diffsheg_tpu_torch", "examples", f"{name}.py")), name


@pytest.mark.parametrize("name", NAMES)
def test_without_a_card_the_script_exits_non_zero(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = port(name)
    entry = mod.cli if name == "live_demo" else mod.main
    argv = ["8"] if name == "batch_probe" else []
    out, err, code = run_main(entry, argv)
    assert code not in (0, None), (out, err)
    assert "CUDA is not available" in str(code) + err
    assert '"metric"' not in out


# --------------------------------------------------------------------------
# convergence_demo
# --------------------------------------------------------------------------

def test_convergence_config_and_data_equal_jax(monkeypatch):
    j = jax_script("convergence_demo", monkeypatch)
    p = port("convergence_demo")
    for every in (10, 2):
        assert cfg_dict(p.make_config(every)) == cfg_dict(j.make_config(every))
    for n, seed in ((256, 0), (64, 1)):
        a = p.AudioDrivenDataset(p.make_config(), n=n, seed=seed).data
        b = j.AudioDrivenDataset(j.make_config(), n=n, seed=seed).data
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_convergence_main_prints_the_jax_lines(tmp_path):
    p = port("convergence_demo")
    curve = tmp_path / "curve.json"
    out, err, code = run_main(p.main, [
        "10", "--device", "cpu", "--workdir", str(tmp_path / "wd"),
        "--curve-out", str(curve)])
    assert code in (0, None), err
    rows = json_lines(out)
    summary = rows[-1]
    assert set(summary) in jax_dicts("convergence_demo", "evals")
    assert summary["evals"] == 1 and summary["value"] == 1.0
    assert {"val_mse", "val_fgd", "val_pck", "val_pck2",
            "val_diversity"} <= set(rows[0])
    assert out.splitlines()[-1] == f"curve -> {curve}"
    assert json.load(open(curve))["epochs"] == 10


# --------------------------------------------------------------------------
# overfit_demo
# --------------------------------------------------------------------------

def test_overfit_config_and_window_equal_jax(monkeypatch):
    j = jax_script("overfit_demo", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["overfit_demo.py"])
    monkeypatch.setattr("diffsheg_tpu.models.factory.init_denoiser",
                        lambda *a, **k: (None, None))
    monkeypatch.setattr("diffsheg_tpu.train.step.create_train_state",
                        lambda *a, **k: None)

    def make_step(cfg, sched):
        def step(state, batch, rng):
            raise Captured(cfg=cfg, batch=batch)
        return step
    monkeypatch.setattr("diffsheg_tpu.train.step.make_train_step", make_step)
    with pytest.raises(Captured) as got:
        j.main()
    cfg, batch = got.value.kw["cfg"], got.value.kw["batch"]
    p = port("overfit_demo")
    assert cfg_dict(p.make_config()) == cfg_dict(cfg)
    motion, mel, pid = p.overfit_window(p.make_config())
    for ours, theirs in ((motion, batch["motion"][0]), (mel, batch["mel"][:1]),
                         (pid, batch["pid"][:1])):
        theirs = np.asarray(theirs)
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def test_overfit_main_prints_the_jax_lines():
    p = port("overfit_demo")
    out, err, code = run_main(p.main, ["--steps", "2", "--device", "cpu"])
    assert code in (0, None), err
    lines = out.splitlines()
    assert re.fullmatch(r"step 1: eps_mse=\d+\.\d{4} total=\d+\.\d",
                        lines[0]), lines[0]
    assert re.fullmatch(r"trained 2 steps in \d+\.\ds", lines[2])
    assert re.fullmatch(r"GT variance: \d\.\d{4}", lines[3])
    assert re.fullmatch(r"sample MSE vs GT \(3 seeds\): \[[-\d., e]+\]",
                        lines[4]), lines[4]
    assert re.fullmatch(r"normalized error: \d+\.\d{3} \((NOT )?LEARNED\)",
                        lines[5]), lines[5]


# --------------------------------------------------------------------------
# serve_capacity
# --------------------------------------------------------------------------

def test_serve_capacity_config_and_audio_equal_jax(monkeypatch):
    j = jax_script("serve_capacity", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["serve_capacity.py"])
    no_jax_model(monkeypatch)
    capture_at(monkeypatch, "diffsheg_tpu.serving.server.MotionServer")
    with pytest.raises(Captured) as got:
        j.main()
    p = port("serve_capacity")
    assert cfg_dict(p.make_config()) == cfg_dict(got.value.kw["args"][0])

    pushed = []
    client = fake(start=lambda self, **k: {}, finish=lambda self: None,
                  push=lambda self, x: pushed.append(np.asarray(x)),
                  __enter__=lambda self: self,
                  __exit__=lambda self, *a: False)
    monkeypatch.setattr("diffsheg_tpu.serving.server.MotionClient", client)
    run_main(j.run_row, 1, 1, 0.1, 0, 18000, 30)
    ours = p.session_audio(1, 0.1, 18000)
    assert ours.dtype == pushed[0].dtype
    assert np.array_equal(ours, np.stack(pushed))


def test_serve_capacity_main_prints_the_jax_rows(monkeypatch):
    p = port("serve_capacity")
    monkeypatch.setattr(p, "beat_config", tiny_preset("beat"))
    out, err, code = run_main(p.main, ["--secs", "3", "--sessions", "1,2",
                                       "--device", "cpu"])
    assert code in (0, None), err
    rows = json_lines(out)
    assert [r["sessions"] for r in rows] == [1, 1, 2]
    for r in rows:
        assert set(r) in jax_dicts("serve_capacity", "rt_factor")
    assert out.splitlines()[1].startswith("# warmup row above")


# --------------------------------------------------------------------------
# show_bench and batch_probe: the fused pipeline
# --------------------------------------------------------------------------

def pipeline_fakes(monkeypatch):
    """The JAX pipeline's constructors as fakes; the pipeline's call raises
    :class:`Captured` with its audio and styles, WindowGenerator records
    its configuration."""
    seen = {}
    no_jax_model(monkeypatch)

    def window_generator(cfg, variables, *a, **k):
        seen["cfg"] = cfg
    monkeypatch.setattr("diffsheg_tpu.sampling.generator.WindowGenerator",
                        window_generator)
    for target in ("diffsheg_tpu.sampling.streamer.StreamingGenerator",
                   "diffsheg_tpu.audio.mel.MelFrontend",
                   "diffsheg_tpu.audio.hubert_runner.HubertFeatureExtractor"):
        monkeypatch.setattr(target, fake())

    def call(self, a18, a16, pid, key):
        raise Captured(cfg=seen["cfg"], a18=np.asarray(a18),
                       a16=np.asarray(a16), pid=np.asarray(pid))
    monkeypatch.setattr("diffsheg_tpu.sampling.pipeline.FusedPipeline",
                        fake(__call__=call))


def assert_audio_equal(mod, cfg, got, B, device_pid):
    for sr, theirs in ((cfg.data.mel_sr, got["a18"]), (16000, got["a16"])):
        ours = mod.synth(sr)
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    assert np.array_equal(device_pid.numpy(), got["pid"])


def test_show_bench_config_and_audio_equal_jax(monkeypatch):
    j = jax_script("show_bench", monkeypatch)
    from diffsheg_tpu.utils.calibration import CalibrationResult
    monkeypatch.setattr(
        "diffsheg_tpu.utils.benchguard.calibrate_or_exit",
        lambda *a, **k: CalibrationResult(ok=True, reason="", backend="cpu"))
    monkeypatch.setattr("diffsheg_tpu.utils.benchguard.build_guarded",
                        lambda build, *a, **k: build())
    pipeline_fakes(monkeypatch)
    with pytest.raises(Captured) as got:
        j.main()
    p = port("show_bench")
    cfg = got.value.kw["cfg"]
    assert cfg_dict(p.make_config()) == cfg_dict(cfg)
    pid = torch.nn.functional.one_hot(torch.tensor([1]),
                                      cfg.model.style_dim).float()
    assert_audio_equal(p, cfg, got.value.kw, 1, pid)


def test_show_bench_main_prints_the_jax_record(monkeypatch):
    p = port("show_bench")
    monkeypatch.setattr(p, "show_config", tiny_preset("show"))
    monkeypatch.setattr(p, "HubertConfig",
                        functools.partial(dataclasses.replace, TINY_HUB))
    monkeypatch.setattr(p, "SECS", 4)
    out, err, code = run_main(p.main, ["--device", "cpu"])
    record = json_lines(out)[-1]
    # the spread of timed calls on a shared CPU may exceed its 30% bound:
    # then the record is the invalid one, with the same keys and a reason
    assert code in (0, None) or record["valid"] is False, err
    keys = set(record) - {"invalid_reason"}
    assert CALIB_KEYS <= keys
    assert keys - CALIB_KEYS in jax_dicts("show_bench", "spread_pct")
    assert record["backend"] == "cpu" and "fused pipeline (best of 6)" in err


def test_batch_probe_config_and_audio_equal_jax(monkeypatch):
    import diffsheg_tpu.utils.compile_cache as cc
    monkeypatch.setattr(cc, "enable_persistent_cache", lambda *a, **k: None)
    pipeline_fakes(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["batch_probe.py", "8"])
    with pytest.raises(Captured) as got:
        runpy.run_path(jax_path("batch_probe"))
    p = port("batch_probe")
    cfg = got.value.kw["cfg"]
    assert cfg_dict(p.make_config()) == cfg_dict(cfg)
    pid = torch.nn.functional.one_hot(torch.arange(8) % cfg.model.style_dim,
                                      cfg.model.style_dim).float()
    assert_audio_equal(p, cfg, got.value.kw, 8, pid)


def test_batch_probe_main_prints_the_jax_line(monkeypatch):
    p = port("batch_probe")
    monkeypatch.setattr(p, "beat_config", tiny_preset("beat"))
    monkeypatch.setattr(p, "HubertConfig",
                        functools.partial(dataclasses.replace, TINY_HUB))
    monkeypatch.setattr(p, "SECS", 4)
    out, err, code = run_main(p.main, ["2", "--device", "cpu"])
    assert code in (0, None), err
    assert re.fullmatch(r"B=2: \d+\.\d{3}s -> aggregate \d+ FPS "
                        r"\(\d+x A100 single-stream\)", out.strip()), out


# --------------------------------------------------------------------------
# train_bench
# --------------------------------------------------------------------------

@pytest.mark.parametrize("batch,dtype,remat", [(256, "float32", False),
                                               (2500, "bfloat16", True)])
def test_train_bench_config_equals_jax(batch, dtype, remat, monkeypatch):
    j = jax_script("train_bench", monkeypatch)
    no_jax_model(monkeypatch)
    capture_at(monkeypatch, "diffsheg_tpu.train.step.create_train_state")
    with pytest.raises(Captured) as got:
        j.build(batch, dtype, remat=remat)
    p = port("train_bench")
    assert cfg_dict(p.make_config(dtype, remat)) == cfg_dict(
        got.value.kw["args"][0])


def test_train_bench_main_prints_the_jax_lines(monkeypatch):
    p = port("train_bench")
    monkeypatch.setattr(p, "beat_config", tiny_preset("beat"))
    out, err, code = run_main(p.main, ["4", "f32", "--device", "cpu"])
    assert code in (0, None), err
    (summary,) = json_lines(out)
    assert set(summary) in jax_dicts("train_bench", "mfu_pct")
    assert summary["batch"] == 4 and summary["mfu_pct"] is not None
    assert "MFU" in err and "67 TFLOP/s (float32)" in err
    row = p.measure(2, "float32", reps=1, device="cpu")
    assert set(row) in jax_dicts("train_bench", "step_ms")
    assert row["roofline_mfu_pct"] is None and row["tflops_per_step"] is not None


def linear_products(model, batch_fields, run):
    """2·M·N·K of every Linear / Conv1d product and of linear attention's
    two contractions in one ``run()``, forward and backward: a weight's
    gradient always, an input's gradient where the input needs one."""
    total = [0.0]
    hooks = []

    def linear_hook(mod, inp, out):
        x = inp[0]
        rows = x.numel() // x.shape[-1]
        fwd = 2 * rows * mod.in_features * mod.out_features
        total[0] += fwd * (2 + x.requires_grad)

    def conv_hook(mod, inp, out):
        x = inp[0]
        k = mod.in_channels // mod.groups * mod.kernel_size[0]
        fwd = 2 * out.numel() * k
        total[0] += fwd * (2 + x.requires_grad)

    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            hooks.append(m.register_forward_hook(linear_hook))
        elif isinstance(m, torch.nn.Conv1d):
            hooks.append(m.register_forward_hook(conv_hook))
    import diffsheg_tpu_torch.models.attention as attn
    orig = attn.linear_attention

    def attention(q, k, v, num_heads, **kw):
        B, T, D = q.shape
        # both contractions forward; backward each input of each
        total[0] += 3 * 4 * B * T * D * (D // num_heads)
        return orig(q, k, v, num_heads, **kw)
    attn.linear_attention = attention
    try:
        run()
    finally:
        attn.linear_attention = orig
        for h in hooks:
            h.remove()
    return total[0]


def test_train_bench_counts_the_steps_products(monkeypatch):
    """FlopCounterMode's count of one step equals the analytic sum of
    2·M·N·K over the step's products at a tiny width; JAX's
    ``cost_analysis()`` of its step at the same width is printed beside
    it as a ratio (XLA counts its elementwise operations too)."""
    p = port("train_bench")
    monkeypatch.setattr(p, "beat_config", tiny_preset("beat"))
    cfg, state, step, batch, _, _ = p.build(4, "float32", device="cpu")
    counted = p.counted_flops(lambda: step(state, batch))
    analytic = linear_products(state.model, batch,
                               lambda: step(state, batch))
    assert counted == analytic, (counted, analytic)

    import jax
    from diffsheg_tpu.config import beat_config as jbeat
    from diffsheg_tpu.diffusion.schedule import (get_named_beta_schedule,
                                                 make_schedule)
    from diffsheg_tpu.models.unidiffuser import init_unidiffuser
    from diffsheg_tpu.train.step import create_train_state, make_train_step
    jcfg = jbeat()
    jcfg = jcfg.replace(model=dataclasses.replace(
        jcfg.model, **{k: getattr(cfg.model, k) for k in (
            "latent_dim", "num_layers", "num_heads", "ff_size", "hubert_dim",
            "hubert_latent_dim")}))
    _, variables = init_unidiffuser(jcfg.model, jcfg.data.n_poses,
                                    jax.random.PRNGKey(0))
    jstep = make_train_step(jcfg, make_schedule(get_named_beta_schedule(
        jcfg.diffusion.beta_schedule, jcfg.diffusion.num_steps)))
    jbatch = {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()}
    cost = jstep.lower(create_train_state(jcfg, variables), jbatch,
                       jax.random.PRNGKey(1)).compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    print(f"train_bench tiny step: counted {counted:.4g} operations, JAX "
          f"cost_analysis {cost['flops']:.4g} (ratio "
          f"{cost['flops'] / counted:.3f})")


# --------------------------------------------------------------------------
# the live harnesses
# --------------------------------------------------------------------------

def test_live_latency_config_and_audio_equal_jax(monkeypatch):
    j = jax_script("live_latency", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["live_latency.py"])
    no_jax_model(monkeypatch)
    heard = {}

    def mel(self, audio):
        heard["audio"] = np.asarray(audio)
    monkeypatch.setattr("diffsheg_tpu.audio.mel.MelFrontend",
                        fake(__call__=mel))
    capture_at(monkeypatch, "diffsheg_tpu.sampling.generator.WindowGenerator")
    with pytest.raises(Captured) as got:
        j.main()
    p = port("live_latency")
    cfg = got.value.kw["args"][0]
    assert cfg_dict(p.make_config()) == cfg_dict(cfg)
    ours = p.live_audio(40, cfg.data.mel_sr)[None]
    assert ours.dtype == heard["audio"].dtype
    assert np.array_equal(ours, heard["audio"])
    x = np.random.RandomState(0).randn(1, 75, 6).astype(np.float32)
    assert np.array_equal(p.fgd_windows(x, 34), j.fgd_windows(x, 34))


def test_live_latency_main_prints_the_jax_rows(monkeypatch):
    p = port("live_latency")
    monkeypatch.setattr(p, "beat_config", tiny_preset("beat"))
    out, err, code = run_main(p.main, ["--secs", "6", "--sizes", "34,12",
                                       "--device", "cpu"])
    assert code in (0, None), err
    rows = json_lines(out)
    assert [r["window"] for r in rows] == [34, 12]
    for r in rows:
        assert set(r) in jax_dicts("live_latency", "fgd_vs_offline")


def test_live_demo_config_and_audio_equal_jax(monkeypatch):
    j = jax_script("live_demo", monkeypatch)
    no_jax_model(monkeypatch)
    seen, chunks = {}, []

    def window_generator(cfg, variables, *a, **k):
        seen["cfg"] = cfg
    monkeypatch.setattr("diffsheg_tpu.sampling.generator.WindowGenerator",
                        window_generator)

    def push(self, x):
        chunks.append(np.asarray(x))
        return np.zeros((1, 0, 192), np.float32)
    monkeypatch.setattr("diffsheg_tpu.sampling.live.LiveSession", fake(
        push=push, finish=lambda self: np.zeros((1, 10, 192), np.float32)))
    run_main(j.main, 12.0)
    p = port("live_demo")
    assert cfg_dict(p.make_config()) == cfg_dict(seen["cfg"])
    ours = p.capture_audio(12.0, seen["cfg"].data.mel_sr)
    theirs = np.concatenate(chunks)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def test_live_demo_prints_the_jax_lines(monkeypatch):
    p = port("live_demo")
    monkeypatch.setattr(p, "beat_config", tiny_preset("beat"))
    out, err, code = run_main(p.cli, ["4", "--device", "cpu"])
    assert code in (0, None), err
    lines = err.strip().splitlines()
    for line in lines[:-1]:
        assert re.fullmatch(r"t=[ \d]\d\.\d\ds  \+\d+ frames \(window in "
                            r"\d+ ms, motion through \d+\.\d\ds\)", line), line
    assert re.fullmatch(r"session: \d+ frames of motion for 4\.0s of audio "
                        r"in \d+\.\d\ds wall \(\d+% coverage, first window "
                        r"after 2\.3s of audio\)", lines[-1]), lines[-1]


def test_live_hubert_drift_defaults_equal_jax(monkeypatch):
    j = jax_script("live_hubert_drift", monkeypatch)
    orig = argparse.ArgumentParser.parse_args

    def defaults(self, args=None, namespace=None):
        raise Captured(ns=vars(orig(self, [])))
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", defaults)
    with pytest.raises(Captured) as theirs:
        j.main()
    with pytest.raises(Captured) as ours:
        port("live_hubert_drift").main([])
    a, b = ours.value.kw["ns"], theirs.value.kw["ns"]
    # the JAX default wav is a file of the reference corpus; the port
    # makes seeded speech-like audio unless --wav names a file
    assert a.pop("device") is None and a.pop("wav") is None
    b.pop("wav")
    assert a == b


def test_live_hubert_drift_prints_the_jax_result(monkeypatch):
    p = port("live_hubert_drift")
    monkeypatch.setattr(p, "HubertFeatureExtractor", functools.partial(
        p.HubertFeatureExtractor, TINY_HUB))
    out, err, code = run_main(p.main, ["--seconds", "6", "--ctx", "1,2",
                                       "--device", "cpu"])
    assert code in (0, None), err
    (res,) = json_lines(out)
    base = {k for k in res if not k.startswith("left_ctx_")}
    assert base in jax_dicts("live_hubert_drift", "window_local_mean")
    assert set(res) - base == {"left_ctx_1s_mean", "left_ctx_1s_max",
                               "left_ctx_2s_mean", "left_ctx_2s_max"}
    assert res["windows"] == 3 and res["weights"] == "random-init"
    assert all(np.isfinite(v) for k, v in res.items()
               if k.startswith(("left_", "window_local")))


# --------------------------------------------------------------------------
# perf_probe
# --------------------------------------------------------------------------

def test_perf_probe_variants_equal_jax(monkeypatch):
    j = jax_script("perf_probe", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["perf_probe.py"])
    no_jax_model(monkeypatch)
    theirs, ours = [], []
    monkeypatch.setattr(j, "run_variant",
                        lambda name, cfg, *a, **k: theirs.append(cfg))
    j.main()
    p = port("perf_probe")
    monkeypatch.setattr(p, "init_unidiffuser", lambda *a, **k: None)
    monkeypatch.setattr(p, "run_variant",
                        lambda name, cfg, *a, **k: ours.append(cfg))
    p.main(["--device", "cpu"])
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert cfg_dict(a) == cfg_dict(b)


def test_perf_probe_prints_the_jax_lines(monkeypatch):
    p = port("perf_probe")
    monkeypatch.setattr(p, "beat_config", tiny_preset("beat"))
    out, err, code = run_main(p.main, ["--secs", "3", "--device", "cpu"])
    assert code in (0, None), err
    lines = out.splitlines()
    assert len(lines) == 4
    for line in lines:
        assert re.fullmatch(r".{28} sampler=\d+\.\d{3}s  [ \d]{5}\d\.\d fps "
                            r"\(frames=45\)", line), line
