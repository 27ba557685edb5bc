"""Calibration and bench guards of the port (``diffsheg_tpu_torch/utils/
{calibration,benchguard,benchcfg}.py``) on the CPU: the H100 envelopes,
the bounded readback, the stderr tee, the CPU refusals, the locality
decision on a CPU program, the guards' exits, and ``BENCH_JN`` against
the JAX package's reader."""

import json
import os
import time

import numpy as np
import pytest
import torch

from diffsheg_tpu_torch.utils import benchguard
from diffsheg_tpu_torch.utils.calibration import (
    MIN_DEVICE_KERNELS, CalibrationResult, DeviceActivity, _busy_seconds,
    _readback, calibrate, device_activity, envelope_for, host_cpu_fraction,
    scan_stderr)


class TestEnvelope:
    def test_h100_envelope(self):
        lo, hi = envelope_for("NVIDIA H100 80GB HBM3")
        assert lo <= 700.0 <= hi        # a healthy sustained bf16 rate
        assert hi <= 1000.0              # the SXM5 dense peak is 989
        assert not lo <= 2.0 <= hi       # a host CPU's rate: fails low
        assert not lo <= 3179.0 <= hi    # an impossible rate: fails high

    def test_pcie_matches_before_the_generic_prefix(self):
        pcie, sxm = envelope_for("NVIDIA H100 PCIe"), envelope_for(
            "NVIDIA H100 80GB HBM3")
        assert pcie != sxm and pcie[1] < sxm[1]
        assert pcie[0] <= 700.0 <= pcie[1]       # PCIe peak is 756
        assert not pcie[0] <= 900.0 <= pcie[1]
        assert not pcie[0] <= 3179.0 <= pcie[1]

    def test_unknown_kind_gets_the_loose_default(self):
        lo, hi = envelope_for("NVIDIA A100-SXM4-80GB")
        assert 0 < lo < hi and hi >= 1000.0
        assert envelope_for("cpu") == (lo, hi)


class TestReadback:
    def test_returns_value(self):
        out = _readback(np.arange(3.0), timeout=5.0)
        np.testing.assert_array_equal(out, [0.0, 1.0, 2.0])

    def test_tensor_and_callable(self):
        t = torch.tensor([1.5, 2.5], dtype=torch.bfloat16)
        np.testing.assert_array_equal(_readback(t, 5.0), [1.5, 2.5])
        np.testing.assert_array_equal(_readback(lambda: t * 2, 5.0),
                                      [3.0, 5.0])

    def test_bounded_on_a_callable_that_never_returns(self):
        t0 = time.perf_counter()
        assert _readback(lambda: time.sleep(30.0), timeout=0.2) is None
        assert time.perf_counter() - t0 < 5.0

    def test_bounded_on_a_hung_transfer(self):
        class Hangs:
            def __array__(self, dtype=None, copy=None):
                time.sleep(30.0)
                return np.zeros(1)

        t0 = time.perf_counter()
        assert _readback(Hangs(), timeout=0.2) is None
        assert time.perf_counter() - t0 < 5.0

    def test_propagates_errors(self):
        def fails():
            raise RuntimeError("transfer failed")

        with pytest.raises(RuntimeError, match="transfer failed"):
            _readback(fails, timeout=5.0)


class TestStderrScan:
    def test_sees_fd_level_writes(self):
        with scan_stderr() as scan:
            os.write(2, b"raw: native library marker\n")
        assert scan.found("native library marker")
        assert scan.count("native library marker") == 1

    def test_tee_restores_stderr(self):
        before = os.fstat(2).st_ino
        with scan_stderr() as scan:
            os.write(2, b"tee check\n")
        os.write(2, b"")
        assert scan.found("tee check")
        assert os.fstat(2).st_ino == before

    def test_exception_does_not_swallow(self):
        with pytest.raises(RuntimeError):
            with scan_stderr() as scan:
                os.write(2, b"pre-raise output\n")
                raise RuntimeError("boom")
        assert scan.found("pre-raise output")


class TestCalibrateOnCpu:
    def test_cpu_refused_by_default(self):
        res = calibrate(device="cpu")
        assert res.backend == "cpu" and not res.ok and "cpu" in res.reason
        fields = res.json_fields()
        assert fields["valid"] is False and "invalid_reason" in fields

    def test_cpu_allowed_explicitly(self):
        res = calibrate(device="cpu", allow_cpu=True)
        assert res.ok
        assert res.json_fields()["valid"] is True
        assert "invalid_reason" not in res.json_fields()

    def test_no_card_is_not_ok(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        res = calibrate()
        assert not res.ok and res.backend == "cuda"
        assert "CUDA is not available" in res.reason

    def test_json_fields(self):
        res = CalibrationResult(ok=True, reason="", backend="cuda",
                                device_kind="NVIDIA H100 80GB HBM3",
                                calib_tflops=701.234, dispatch_ms=0.0412)
        assert res.json_fields() == {
            "backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
            "calib_tflops": 701.23, "dispatch_ms": 0.04, "valid": True}


class TestLocality:
    def test_cpu_program_is_not_on_the_card(self):
        """The per-program decision: a program whose tensors live on the
        host runs no kernel on the card and its output is off it."""
        x = torch.randn(64, 64)
        act = device_activity(lambda: x @ x)
        assert act.kernels == 0 and not act.outputs_on_card
        assert not act.on_card and act.device_busy_s == 0.0
        assert f"limit >= {MIN_DEVICE_KERNELS}" in act.line()

    def test_decision(self):
        def act(kernels, on_card):
            return DeviceActivity(0.1, 0.9, kernels, 0.05, on_card)
        assert act(MIN_DEVICE_KERNELS, True).on_card
        assert not act(0, True).on_card
        assert not act(100, False).on_card
        assert act(1, True).busy_share == pytest.approx(0.5)

    def test_busy_seconds_is_the_union(self):
        assert _busy_seconds([(0, 10), (5, 15), (20, 30), (21, 22)]) == \
            pytest.approx(25e-6)
        assert _busy_seconds([]) == 0.0

    def test_busy_loop_against_a_blocking_wait(self):
        """A busy loop burns host CPU and a sleeping wait does not (the
        margin leaves room for a loaded host sharing the loop's core)."""
        def busy():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.1:
                pass

        wall, busy_frac = host_cpu_fraction(busy)
        assert wall >= 0.1
        wall, idle_frac = host_cpu_fraction(lambda: time.sleep(0.1))
        assert wall >= 0.1 and idle_frac < 0.1
        assert busy_frac > idle_frac + 0.2


def _card_calib():
    return CalibrationResult(ok=True, reason="", backend="cuda",
                             device_kind="NVIDIA H100 80GB HBM3",
                             calib_tflops=700.0, dispatch_ms=0.03)


class TestGuards:
    def test_calibrate_or_exit_exits_without_a_card(self, monkeypatch,
                                                    capsys):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit) as e:
            benchguard.calibrate_or_exit("fps")
        assert e.value.code == 1
        artifact = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert artifact["valid"] is False and artifact["value"] == 0.0
        assert "CUDA is not available" in artifact["invalid_reason"]

    def test_calibrate_or_exit_exits_on_cpu(self, capsys):
        with pytest.raises(SystemExit) as e:
            benchguard.calibrate_or_exit("fps", device="cpu")
        assert e.value.code == 1
        artifact = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert artifact["valid"] is False and artifact["backend"] == "cpu"

    def test_calibrate_or_exit_cpu_allowed(self):
        res = benchguard.calibrate_or_exit("fps", allow_cpu=True,
                                           device="cpu")
        assert res.ok and res.backend == "cpu"

    def test_build_guarded_passes_an_honest_cpu_run(self):
        calib = calibrate(device="cpu", allow_cpu=True)
        probes = []
        built = benchguard.build_guarded(
            lambda: "program", probes.append, lambda: None, "fps", calib)
        assert built == "program" and probes == []

    def test_build_guarded_exits_on_a_cpu_program(self, capsys):
        """A program on the host under a card's calibration: one retry,
        then the invalid artifact and exit 1."""
        x = torch.randn(32, 32)
        retries = []
        with pytest.raises(SystemExit) as e:
            benchguard.build_guarded(lambda: x, lambda a: a @ a,
                                     lambda: retries.append(1), "fps",
                                     _card_calib())
        assert e.value.code == 1 and retries == [1]
        captured = capsys.readouterr()
        artifact = json.loads(captured.out.strip().splitlines()[-1])
        assert artifact["valid"] is False and artifact["value"] == 0.0
        assert "does not run on the card" in artifact["invalid_reason"]
        assert "kernels=0" in captured.err

    def test_build_guarded_retries_once_then_passes(self, monkeypatch):
        seen = iter([DeviceActivity(0.1, 0.9, 0, 0.0, True),
                     DeviceActivity(0.1, 0.9, 500, 0.05, True)])
        monkeypatch.setattr(benchguard, "device_activity",
                            lambda call: (call(), next(seen))[1])
        builds, retries = [], []
        built = benchguard.build_guarded(
            lambda: builds.append(1) or len(builds), lambda b: b,
            lambda: retries.append(1), "fps", _card_calib())
        assert built == 2 and retries == [1]

    def test_build_guarded_wall_floor(self, monkeypatch):
        monkeypatch.setattr(
            benchguard, "device_activity",
            lambda call: DeviceActivity(9.0, 0.1, 500, 8.0, True))
        with pytest.raises(SystemExit):
            benchguard.build_guarded(lambda: 1, lambda b: b, lambda: None,
                                     "fps", _card_calib(), max_probe_wall=1.0)

    def test_timed_reps(self):
        seen = []
        totals, frac = benchguard.timed_reps(
            lambda i: seen.append(i) or time.sleep(0.01), 3)
        assert seen == [0, 1, 2] and len(totals) == 3
        assert all(t >= 0.01 for t in totals) and 0.0 <= frac < 0.5


@pytest.mark.parametrize("jn", [None, "2", "5", "3"])
def test_jump_config_baseline_matches_jax(jn, monkeypatch):
    from diffsheg_tpu.utils.benchcfg import jump_config_baseline as jax_jcb
    from diffsheg_tpu_torch.utils.benchcfg import jump_config_baseline
    if jn is None:
        monkeypatch.delenv("BENCH_JN", raising=False)
    else:
        monkeypatch.setenv("BENCH_JN", jn)
    baselines = {2: 55.0, 5: 22.5}

    def outcome(fn):
        try:
            return fn(baselines)
        except SystemExit as e:
            return str(e.code)

    got = outcome(jump_config_baseline)
    assert got == outcome(jax_jcb)
    if jn == "3":
        assert "no published A100 baseline" in got
    else:
        assert got == (int(jn or 2), baselines[int(jn or 2)])
