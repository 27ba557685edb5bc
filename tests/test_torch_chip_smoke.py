"""``chip_smoke.py``'s module-level parts, checked without a card: the
closing ``kernels`` line's rows, the peaks its bounds divide by, and its
``--only`` choices.

    python -m pytest tests/test_torch_chip_smoke.py -q
"""

import json
from pathlib import Path

import pytest

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
LAYER_CU = "diffsheg_tpu_torch/csrc/fused_layer.cu"
ATTENTION_CU = "diffsheg_tpu_torch/csrc/linear_attention.cu"
STEP_CU = "diffsheg_tpu_torch/csrc/step_math.cu"

# (name, source, replaces) of every row, in order: the ``kernels`` line's
# contract with its readers, frozen
ROWS = (
    ("fused_branch", LAYER_CU, "diffsheg_tpu/ops/fused_layer.py:475"),
    ("fused_layer", LAYER_CU, "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_linear_attention", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_linear_attention_audio_enc", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_ddim_repaint_step", STEP_CU, "diffsheg_tpu/ops/step_math.py:153"),
    ("fused_branch_int8", LAYER_CU, "diffsheg_tpu/ops/fused_layer.py:374"),
    ("fused_layer_int8", LAYER_CU, "diffsheg_tpu/ops/fused_layer.py:492"),
    ("fused_branch_int4", LAYER_CU, "diffsheg_tpu/ops/fused_layer.py:374"),
    ("fused_layer_int4", LAYER_CU, "diffsheg_tpu/ops/fused_layer.py:492"),
    ("fused_layer_live_w34", LAYER_CU, "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_layer_live_w12", LAYER_CU, "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_layer_live_b4", LAYER_CU, "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_branch_live", LAYER_CU, "diffsheg_tpu/ops/fused_layer.py:475"),
    ("fused_linear_attention_decoder", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_linear_attention_decoder_audio_enc", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_ddim_repaint_step_decoder", STEP_CU,
     "diffsheg_tpu/ops/step_math.py:153"),
    ("fused_linear_attention_learned_var", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_linear_attention_learned_var_audio_enc", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_linear_attention_single", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_ddim_repaint_step_single", STEP_CU,
     "diffsheg_tpu/ops/step_math.py:153"),
    ("fused_ddim_repaint_step_learned_var", STEP_CU,
     "diffsheg_tpu/ops/step_math.py:153"),
    ("fused_layer_generate", LAYER_CU, "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_branch_generate", LAYER_CU, "diffsheg_tpu/ops/fused_layer.py:475"),
    ("fused_layer_generate_staged", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_layer_generate_show", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_linear_attention_generate_audio_enc", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_linear_attention_generate_staged_audio_enc", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_linear_attention_generate_show_audio_enc", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_layer_raw_stream", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_branch_raw_stream", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:475"),
    ("fused_layer_generate_raw", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_layer_show352_stream", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_branch_show352_stream", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:475"),
    ("fused_layer_live_show352", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_layer_odd_stream", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_branch_odd_stream", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:475"),
    ("fused_linear_attention_wide_stream", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_linear_attention_train", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_linear_attention_train_audio_enc", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_layer_eval", LAYER_CU, "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_linear_attention_eval_audio_enc", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_linear_attention_data_train", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_linear_attention_data_train_audio_enc", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_layer_data_eval", LAYER_CU, "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_layer_data_eval_b4", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_linear_attention_data_eval_audio_enc", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_layer_test_stream", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_linear_attention_test_stream_audio_enc", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_linear_attention_scale_train", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_linear_attention_scale_train_audio_enc", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_layer_scale_eval", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_linear_attention_scale_eval_audio_enc", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_linear_attention_scale_world1", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_linear_attention_scale_world1_audio_enc", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_linear_attention_scale_dp", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_linear_attention_scale_dp_audio_enc", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_layer_scale_testset", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_linear_attention_scale_testset_audio_enc", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_branch_doctor", LAYER_CU, "diffsheg_tpu/ops/fused_layer.py:475"),
    ("fused_layer_doctor", LAYER_CU, "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_linear_attention_doctor", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_ddim_repaint_step_doctor", STEP_CU,
     "diffsheg_tpu/ops/step_math.py:153"),
    ("fused_linear_attention_examples_convergence", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_layer_examples_convergence", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_linear_attention_examples_overfit", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_layer_examples_overfit", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_layer_examples_capacity", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_branch_examples_show", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:475"),
    ("fused_ddim_repaint_step_examples_show", STEP_CU,
     "diffsheg_tpu/ops/step_math.py:153"),
    ("fused_linear_attention_examples_train_bench", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"),
    ("fused_layer_examples_batch", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_layer_examples_live", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_layer_examples_probe", LAYER_CU,
     "diffsheg_tpu/ops/fused_layer.py:556"),
    ("fused_linear_attention_examples_probe", ATTENTION_CU,
     "diffsheg_tpu/ops/linear_attention.py:99"))
ENTRY_KEYS = ["name", "route", "source", "replaces", "launches",
              "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms"]


def case_keys():
    """The case keys phase 3 returns: (those of both layer kernels, those
    of one kernel), from the script's case tables."""
    attention = [f"attn-{c[0]}" for c in (
        *chip_smoke.ATTENTION_CASES, *chip_smoke.WIDE_ATTENTION_CASES,
        *chip_smoke.EXAMPLE_ATTENTION_CASES)] + ["attn-cross-beat-f32"]
    steps = [f"step-{c[0]}" for c in chip_smoke.STEP_CASES]
    layers = [f"{s}-{t}" for s in ("beat-exp", "beat-ges", "show-cfg")
              for t in ("bf16", "f32")]
    layers += [f"{s}-{t}-{q}" for q in chip_smoke.QUANT_BITS
               for s, t in (("beat-ges", "bf16"), ("beat-ges", "f32"),
                            ("show-cfg", "bf16"), ("raw-ges", "f32"))]
    layers += [c[0] for c in (*chip_smoke.LIVE_LAYER_CASES,
                              *chip_smoke.WIDE_CASES, *chip_smoke.LONG_CASES,
                              *chip_smoke.ODD_CASES,
                              *chip_smoke.EXAMPLE_LAYER_CASES)]
    return set(layers), set(attention + steps)


def stub_results():
    """Phase 3's results with made-up numbers, a case for every key."""
    layers, single = case_keys()
    case = dict(max_abs_err=1.0, ms=2.0, plain_ms=3.0, bound_ms=4.0,
                bound_by="bytes")
    out = {k: dict(case) for k in single}
    out.update({k: {"fused_branch": dict(case, ms=5.0),
                    "fused_layer": dict(case, ms=6.0)} for k in layers})
    return out


def test_kernel_rows_are_the_parents():
    entries = chip_smoke.kernels_line(stub_results(), {})
    assert [(e["name"], e["source"], e["replaces"]) for e in entries] == list(
        ROWS)
    assert all(list(e) == ENTRY_KEYS for e in entries)
    assert {e["route"] for e in entries} == {"cuda"}
    assert {e["library_ms"] for e in entries} == {None}


def test_each_row_reads_its_kernels_case():
    """A layer kernel's row reads its own kernel's result of a layer case;
    the others read a case of their own kernel."""
    layers, single = case_keys()
    for e in chip_smoke.kernels_line(stub_results(), {}):
        key = dict(chip_smoke.KERNEL_ROWS)[e["name"]]
        if e["name"].startswith("fused_branch"):
            assert key in layers and e["ms"] == 5.0, e["name"]
        elif e["name"].startswith("fused_layer"):
            assert key in layers and e["ms"] == 6.0, e["name"]
        else:
            prefix = ("attn-" if e["name"].startswith("fused_linear")
                      else "step-")
            assert key in single and key.startswith(prefix), e["name"]


def test_launches_by_row_name():
    names = [name for name, _ in chip_smoke.KERNEL_ROWS]
    assert len(set(names)) == len(names)
    launches = {n: i for i, n in enumerate(names[::2])}
    entries = chip_smoke.kernels_line(stub_results(), launches)
    assert [e["launches"] for e in entries] == [
        launches.get(n) for n in names]


def test_a_case_that_did_not_run_leaves_its_rows_out():
    kres = stub_results()
    del kres["beat-ges-bf16"]
    names = [e["name"] for e in chip_smoke.kernels_line(kres, {})]
    assert len(names) == len(ROWS) - 8
    assert "fused_branch" not in names and "fused_layer_doctor" in names


def test_peaks_are_the_benchmarks():
    peaks = json.loads((ROOT / "benchmark" / "flops" / "peaks.json")
                       .read_text())
    assert chip_smoke.HBM_BYTES_PER_S == peaks["hbm_bytes_per_s"]
    assert chip_smoke.TF32_FLOPS == peaks["tf32_flops"]
    assert chip_smoke.PEAK_FLOPS == {
        chip_smoke.torch.bfloat16: peaks["bf16_flops"],
        chip_smoke.torch.float32: peaks["f32_simt_flops"]}


def test_only_offers_the_parents_choices(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["chip_smoke.py", "--only", "none"])
    with pytest.raises(SystemExit):
        chip_smoke.main()
    err = capsys.readouterr().err
    choices = err.split("choose from ")[1].strip().rstrip(")")
    assert [c.strip(" '") for c in choices.split(",")] == [
        "kernels", "qkernels", "speech", "crossover", "stream", "e2e",
        "uncached", "live", "variants", "generate", "train", "data", "scale",
        "tools", "examples"]
