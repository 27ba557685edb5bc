"""What the benchmark loads: after a CPU dry run of each cell no module
of JAX or of the JAX package is in ``sys.modules`` (whole top-level
names: the port's name begins with the JAX package's), and the reference
imports nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import FORBIDDEN, Loader

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "benchmark" / "reference"


@pytest.mark.parametrize("cell", [w["name"] for w in Loader().spec()["workloads"]])
def test_dry_run_loads_no_jax(cell):
    code = (
        "import json, sys\n"
        "from benchmark.tests.tiny import dry_run\n"
        "from benchmark.harness import forbidden_modules\n"
        f"res = dry_run({cell!r})\n"
        "print(json.dumps({'correct': res['correct'],"
        " 'found': forbidden_modules(),"
        " 'port': 'diffsheg_tpu_torch' in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line == {"correct": True, "found": [], "port": True}


def test_forbidden_names_are_whole_top_level_names():
    assert "diffsheg_tpu_torch" not in FORBIDDEN
    assert {"jax", "jaxlib", "flax", "diffsheg_tpu"} <= set(FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in (
                    "diffsheg_tpu_torch", "diffsheg_tpu", "jax", "jaxlib",
                    "flax"), f"{path.name} imports {name}"
    code = ("import sys\n"
            "import benchmark.reference.denoiser, benchmark.reference.speech\n"
            "import benchmark.reference.sampler, benchmark.reference.train\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'diffsheg_tpu_torch', 'diffsheg_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]
