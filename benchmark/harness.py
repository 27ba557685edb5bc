"""The benchmark's harness: finds a cell's pieces by name, runs its
set-up, the measured window and the check, and prints the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own under ``benchmark/``:

- ``configs/<config>.json``: the sizes as they are run (the reference in
  ``reference/`` reads the same file);
- ``traffic/<traffic>.json``: a traffic mix, read by the general
  generator it names, ``traffic/<generator>.py``;
- ``workloads/<cell>.json``: the cell's limits for ``correct``, with the
  readings they were set from;
- ``metrics/<metric>.py``: one per-layer metric's reader, ``read(view,
  facts)`` -> a number or None (nothing to read).

``BENCHMARK.json`` at the checkout's root lists the cells and the metrics
each reports.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# what the program may not load in a benchmark process, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "diffsheg_tpu")


class Loader:
    """Finds the pieces of a benchmark under ``root`` by name."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "benchmark"

    def spec(self) -> dict:
        return json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        """The cell's entry in BENCHMARK.json merged with its own file."""
        entry = next((w for w in self.spec()["workloads"]
                      if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        return {**entry, **self._json("workloads", name)}

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def generator(self, name: str):
        return self._module("traffic", name)

    def metric_reader(self, name: str):
        return self._module("metrics", name)

    def metrics_of(self, cell: str, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics ``cell`` reports: those
        that list it, and those without a list whose moved metric it
        reports."""
        spec = self.spec()
        e2e = [m for m in spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if kind == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]

    def _json(self, sub: str, name: str) -> dict:
        return json.loads((self.dir / sub / f"{name}.json").read_text())

    def _module(self, sub: str, name: str):
        path = self.dir / sub / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{sub}_{name.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def device_info(chips: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port builds its kernels into ``<checkout>/.cache/
    diffsheg_tpu_torch`` by itself)."""
    cache = ROOT / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def run_cell(loader: Loader, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t0: float, overrides=None) -> dict:
    """Set-up, window, check; returns the result (without ``device``).
    ``overrides`` shrinks a configuration for a run on the CPU (tests)."""
    from benchmark.tracing import Tracer, breakdown
    cell = loader.cell(cell_name)
    mix = loader.traffic(cell["traffic"])
    config = loader.config(cell["config"])
    if overrides:
        config, mix = overrides(config, mix)
    gen_mod = loader.generator(mix["generator"])
    tracer = Tracer(trace, str(ROOT / ".cache" / "benchmark"))
    gen = gen_mod.Generator(cell, mix, config, seed, device, tracer)
    gen.setup()
    setup_s = time.perf_counter() - t0
    window = gen.run(seconds)
    memory_peak = None
    if device.type == "cuda":
        memory_peak = device_info(cell["chips"])
    for what, values in (("item seconds", window["item_seconds"]),
                         ("item host cpu seconds", window["item_cpu_seconds"])):
        print(f"{what}: " + " ".join(f"{t:.4f}" for t in values),
              file=sys.stderr)
    gen.free()
    checks = gen.check()
    correct = (window["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"]}
    if trace:
        view = window.get("trace")
        metrics = {}
        for m in loader.metrics_of(cell_name, "per_layer"):
            value = (loader.metric_reader(m["name"]).read(view, window["facts"])
                     if view is not None else None)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        result["trace_window"] = window.get("trace_window")
        if view is not None:
            result["breakdown"] = breakdown(view)
    else:
        values = dict(window["end_to_end"], setup_s=setup_s)
        result["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in loader.metrics_of(cell_name, "end_to_end")}
    result["memory"] = memory_peak
    result["checks"] = checks
    return result


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    loader = Loader()
    cell = loader.cell(args.workload)

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " present", file=sys.stderr)
        return 2
    result = run_cell(loader, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda"), t0)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    device = result.pop("memory")
    if args.trace:
        busy, window_s = result.pop("trace_window")
        device.update(busy_s=busy, window_s=window_s)
    checks = result.pop("checks")
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
        if not math.isfinite(c["value"]):   # no NaN in the JSON line
            c["value"] = None
    line = {**result, "device": device, "checks": checks}
    print(json.dumps(line))
    return 0

