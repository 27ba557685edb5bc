"""``cli doctor`` of the port (``diffsheg_tpu_torch/cli/doctor.py``) on the
CPU: every line named under ``--device cpu``, the CUDA checks warning
there and failing without a card, the kernel check failing on a build,
launch or band it misses, the kernel probes' inputs at the main path's
shapes, and the CLI wiring."""

import numpy as np
import pytest
import torch

from diffsheg_tpu_torch.cli import doctor
from diffsheg_tpu_torch.cli.doctor import run_doctor


def _lines(out):
    return {ln[7:].split()[0]: ln[:6] for ln in out.splitlines()}


def test_doctor_passes_on_cpu(capsys):
    rc = run_doctor(device="cpu")
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = _lines(out)
    for name in ("torch", "numpy", "scipy", "devices", "dispatch", "kernels",
                 "dataplane", "build-cache", "doctor"):
        assert name in lines, out
    assert "all checks passed" in out
    assert lines["dataplane"] == "[ok  ]"
    assert "calibration" not in lines


def test_cuda_checks_warn_under_device_cpu(capsys):
    assert run_doctor(device="cpu", calibrate=True) == 0
    lines = _lines(capsys.readouterr().out)
    for name in ("devices", "dispatch", "kernels", "calibration"):
        assert lines[name] == "[warn]", name


def test_without_a_card_the_doctor_fails(monkeypatch, capsys):
    """No fallback to the CPU: the devices line fails, the card's checks
    are not run, rc 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_doctor(calibrate=True) == 1
    out = capsys.readouterr().out
    lines = _lines(out)
    assert lines["devices"] == "[FAIL]" and "CUDA is not available" in out
    for name in ("dispatch", "kernels", "calibration", "doctor"):
        assert lines[name] == "[FAIL]", name


def test_env_lines_warn(monkeypatch, capsys):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("CUDA_HOME", "cuda-home")
    assert run_doctor(device="cpu") == 0
    lines = _lines(capsys.readouterr().out)
    assert lines["CUDA_VISIBLE_DEVICES"] == lines["CUDA_HOME"] == "[warn]"


def test_dataplane_line_fails_without_the_library(monkeypatch):
    from diffsheg_tpu_torch import runtime
    monkeypatch.setattr(runtime, "native_available", lambda: False)
    ok, name, detail = doctor._dataplane_status()
    assert ok is False and name == "dataplane" and "numpy" in detail


def test_build_cache_line(monkeypatch):
    from diffsheg_tpu_torch.ops import build
    monkeypatch.setattr(build, "is_built", lambda s: s != build.BUILDS[-1])
    ok, name, detail = doctor._build_cache_status()
    assert ok is None and build.BUILDS[-1] in detail
    monkeypatch.setattr(build, "is_built", lambda s: True)
    ok, _, detail = doctor._build_cache_status()
    assert ok is True and str(build.BUILD_DIR) in detail


@pytest.fixture
def built(monkeypatch):
    """The kernel check past its build: nvcc, the build and the bindings
    stubbed (none exists here)."""
    from diffsheg_tpu_torch.ops import (build, fused_layer, linear_attention,
                                        step_math)
    monkeypatch.setattr(doctor, "_nvcc", lambda: "nvcc (stub)")
    monkeypatch.setattr(build, "build", lambda sources: {})
    for mod in (fused_layer, linear_attention, step_math):
        monkeypatch.setattr(mod, "_lib", lambda: None)


def test_kernel_check_fails_on_a_missed_band_or_launch(built, monkeypatch):
    def within(gen, dev):
        return "shape", "rel-RMS", 1e-6, 1e-5, 0.1

    def outside(gen, dev):
        return "shape", "rel-RMS", 2e-5, 1e-5, 0.1

    def raises(gen, dev):
        raise RuntimeError("fused layer kernel launch failed: CUDA error 98")

    monkeypatch.setattr(doctor, "PROBES", dict(zip(
        doctor.KERNELS, (within, outside, raises, within))))
    checks = {name: ok for ok, name, _ in doctor._kernel_checks()}
    assert checks == {"kernels": True, "fused_branch": True,
                      "fused_layer": False, "fused_linear_attention": False,
                      "fused_ddim_repaint_step": True}


def test_kernel_check_fails_on_a_failed_build(monkeypatch):
    from diffsheg_tpu_torch.ops import build
    monkeypatch.setattr(doctor, "_nvcc", lambda: "nvcc (stub)")

    def fails(sources):
        raise RuntimeError("nvcc fused_layer.cu failed (1):\nerror")

    monkeypatch.setattr(build, "build", fails)
    assert doctor._kernel_checks() == [
        (False, "kernels", "RuntimeError: nvcc fused_layer.cu failed (1): | "
                           "error")]


def test_kernel_check_fails_without_nvcc(monkeypatch):
    from diffsheg_tpu_torch.ops import build
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "no-such-cuda-home")
    ((ok, name, detail),) = doctor._kernel_checks()
    assert ok is False and name == "kernels" and "nvcc not found" in detail


def test_kernel_probes_at_the_main_path_shapes(monkeypatch):
    """Each probe's inputs through its wrapper on the CPU, which runs the
    plain version (so the error is 0): the shapes and dtypes of PERF.md's
    kernel-table rows 1, 2f, 3 and 4."""
    monkeypatch.setattr(doctor, "_timed", lambda launch: (launch(), 0.0))
    gen = torch.Generator().manual_seed(0)
    got = {name: doctor.PROBES[name](gen, torch.device("cpu"))
           for name in doctor.KERNELS}
    assert got["fused_branch"][0] == "bf16 (1, 34, 1024) x 8 layers"
    assert got["fused_layer"][0] == "f32 (1, 34) one layer"
    assert got["fused_linear_attention"][0] == "f32 (1, 34, 512), 8 heads"
    assert got["fused_ddim_repaint_step"][0] == "f32 (1, 34, 192), overlap 4"
    for name, (_, _, err, tol, _) in got.items():
        assert err == 0.0, name
    assert [g[3] for g in got.values()] == [8e-3, 1e-5, 1e-5, 1e-6]


def test_rel_rms():
    a = torch.tensor([1.0, 2.0, 2.0])
    b = torch.tensor([1.0, 2.0, 3.0])
    assert doctor._rel_rms(a, b) == pytest.approx(
        float(np.sqrt(1 / 3) / np.sqrt(14 / 3)))


def test_cli_wiring(capsys):
    from diffsheg_tpu_torch.cli.main import build_parser, main
    args = build_parser().parse_args(["doctor", "--device-timeout", "5"])
    assert args.device_timeout == 5.0 and args.device == "cuda"
    assert not args.calibrate and args.fn is not None
    assert main(["doctor", "--device", "cpu"]) == 0
    assert "[warn] kernels" in capsys.readouterr().out
