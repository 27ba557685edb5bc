"""The loader finds a configuration, a cell, a traffic mix and a metric by
name, here from a temporary folder laid out as the benchmark is."""

import json

from benchmark.harness import Loader


def test_finds_pieces_by_name(tmp_path):
    bench = tmp_path / "benchmark"
    for sub in ("configs", "workloads", "traffic", "metrics"):
        (bench / sub).mkdir(parents=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "workloads": [{"name": "m-a.x", "config": "m", "traffic": "mix-1",
                       "chips": 1, "why": "w"}],
        "end_to_end": [{"name": "rate", "unit": "1/s", "workloads": ["m-a.x"]},
                       {"name": "setup_s", "unit": "s"},
                       {"name": "other", "unit": "1/s", "workloads": ["z"]}],
        "per_layer": [{"name": "a.b", "unit": "%", "moves": "rate",
                       "workloads": ["m-a.x"]},
                      {"name": "c", "unit": "ms", "moves": "rate"},
                      {"name": "d", "unit": "ms", "moves": "other"}]}))
    (bench / "configs" / "m.json").write_text('{"model": {"w": 3}}')
    (bench / "workloads" / "m-a.x.json").write_text('{"limits": {"e": 1}}')
    (bench / "traffic" / "mix-1.json").write_text('{"generator": "g"}')
    (bench / "traffic" / "g.py").write_text("KIND = 'g'\n")
    (bench / "metrics" / "a.b.py").write_text(
        "def read(view, facts):\n    return facts['x'] * 2\n")
    loader = Loader(tmp_path)
    cell = loader.cell("m-a.x")
    assert cell["config"] == "m" and cell["limits"] == {"e": 1}
    assert loader.config("m") == {"model": {"w": 3}}
    assert loader.traffic("mix-1")["generator"] == "g"
    assert loader.generator("g").KIND == "g"
    assert loader.metric_reader("a.b").read(None, {"x": 4}) == 8
    assert [m["name"] for m in loader.metrics_of("m-a.x", "end_to_end")] == [
        "rate", "setup_s"]
    # listed, or without a list and moving a metric the cell reports
    assert [m["name"] for m in loader.metrics_of("m-a.x", "per_layer")] == [
        "a.b", "c"]


def test_every_cell_of_the_benchmark_has_its_pieces():
    loader = Loader()
    spec = loader.spec()
    for w in spec["workloads"]:
        cell = loader.cell(w["name"])
        mix = loader.traffic(cell["traffic"])
        assert loader.config(cell["config"])["name"] == cell["config"]
        assert hasattr(loader.generator(mix["generator"]), "Generator")
        assert cell["limits"]
        names = {m["name"] for m in loader.metrics_of(w["name"], "end_to_end")}
        assert "setup_s" in names and len(names) >= 2
        for m in loader.metrics_of(w["name"], "per_layer"):
            assert callable(loader.metric_reader(m["name"]).read)
            assert m["moves"] in names
