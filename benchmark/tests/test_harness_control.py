"""The controls of ``correct`` on the card, at each cell's own size and
one seed: the program passes its limits and the control fails one (bf16
streams: the reference on e4m3 operands; f32 training: the reference
with TF32 on, and the reference over half of each batch).
Run on the card: ``python -m pytest benchmark/tests -m card``."""

import pytest

from benchmark import control
from benchmark.harness import Loader
from benchmark.tracing import Tracer

CELLS = [w["name"] for w in Loader().spec()["workloads"]]


def over(checks):
    return any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    loader = Loader()
    entry = loader.cell(cell)
    mix = loader.traffic(entry["traffic"])
    gen = loader.generator(mix["generator"]).Generator(
        entry, mix, loader.config(entry["config"]), 2 ** 31 + 17, card,
        Tracer(False, ""))
    gen.setup()
    if mix["generator"] == "train":
        out = control.train_readings(gen)
        assert not over(out["program"])
        assert over(out["control"]) and over(out["fault_half_batch"])
    else:
        out = control.stream_readings(gen, False)
        limit = entry["limits"]["window_rel_rms"]
        assert out["program"] <= limit < out["fp8_reference"]
