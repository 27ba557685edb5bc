"""Build-at-first-use for the port's CUDA sources.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds.  Libraries are keyed by a hash of the
source and the flags and kept under ``<checkout>/.cache/diffsheg_tpu_torch``
(listed in ``.gitignore``), so a fresh checkout builds on its first call
and reuses the result afterwards.  Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".cache" / "diffsheg_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("fused_layer.cu", "linear_attention.cu", "step_math.cu",
           "gemm_tf32x3.cu")
# "source:flag": another build of a source with one more flag: the layer
# kernels with their stamps compiled in, and their ragged instantiations
# alone (widths off a multiple of 16, ctx in column groups)
TRACED_FUSED_LAYER = "fused_layer.cu:-DDIFFSHEG_TRACE"
RAGGED_FUSED_LAYER = "fused_layer.cu:-DDIFFSHEG_RAGGED"
BUILDS = SOURCES + (TRACED_FUSED_LAYER, RAGGED_FUSED_LAYER)  # every library

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _split(source: str):
    """``"name.cu"`` or ``"name.cu:flag"`` -> (path, extra flags).  A name
    is a source of ``csrc/``; anything with a directory in it is taken as
    the path of some other ``.cu`` (a second version of a kernel, built to
    be timed beside the package's)."""
    name, _, flag = source.partition(":")
    path = CSRC / name if os.sep not in name else Path(name).resolve()
    return path, ((flag,) if flag else ())


def _target(source: str) -> Path:
    path, extra = _split(source)
    text = path.read_bytes()
    for dep in sorted(CSRC.glob("*.cuh")):
        text += dep.read_bytes()
    key = hashlib.sha256(
        text + " ".join(NVCC_FLAGS + extra).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{path.stem}-{key}.so"


def is_built(source: str) -> bool:
    """True when ``source``'s library for its current text and flags is in
    the build directory."""
    return _target(source).exists()


def build(sources: Sequence[str] = BUILDS, verbose: bool = False) -> Dict[str, Path]:
    """Compile every source not yet built, one ``nvcc`` per source, all
    started together.  Returns {source: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {s: _target(s) for s in sources}
    todo = {s: t for s, t in targets.items() if not t.exists()}
    procs = []
    t0 = time.perf_counter()
    for s, t in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        path, extra = _split(s)
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, str(path)]
        procs.append((s, t, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for s, t, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc {s} failed ({proc.returncode}):\n{out}")
            continue
        if verbose:
            print(f"{out}nvcc {s}: done by {time.perf_counter() - t0:.1f} s")
        os.replace(tmp, t)   # atomic: a concurrent build sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def library(source: str) -> ctypes.CDLL:
    """The loaded library for ``source``, building it on first use."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build([source])[source]))
        _loaded[source] = lib
    return lib
