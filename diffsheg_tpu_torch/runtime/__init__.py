"""Host data plane: bulk float parsing for frame files, batch row gather.

The port's own copy of ``diffsheg_tpu/runtime/__init__.py``: the C++
library ``native/dataplane.cpp`` (its own copy of JAX's, the same C ABI)
is built with ``g++`` at first use and bound with ``ctypes``:

  - :func:`parse_float_text` / :func:`parse_frames_file` — the cache
    build's reader of header-less numeric frame files (BEAT ``bvh_rot``);
  - :func:`gather_rows` — ``dst[i] = src[indices[i]]`` over a memory
    mapped array, rows copied by several threads (the loader's batch
    assembly, ``data/cache.py``).

The library goes to ``<checkout>/.cache/diffsheg_tpu_torch/`` (the kernels'
build directory, ``ops/build.py``) under a name keyed by a hash of the
source and the flags, written to a temporary file and renamed into place,
so processes that build at once never see half a library and an edited
source builds anew.  It is built without ``-march=native``: the build
directory may be copied to another machine, whose CPU may lack this one's
instructions.

Without a compiler the numpy paths run.  ``gather_rows`` then copies with
``np.take`` (the same bytes).  The numpy parser reads only what it reads
exactly as the native parser does: decimal values separated by spaces,
tabs and carriage returns, rows ended by newlines.  On anything else (a
comma, a byte that is not part of a value, a hex float) it raises rather
than return another array than the native library would.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from diffsheg_tpu_torch.ops.build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "native" / "dataplane.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
ABI_VERSION = 1
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _library_path() -> Path:
    """Where the library for the current source and flags lives."""
    key = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdataplane-{key}.so"


def _build(target: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, target)   # atomic: a concurrent build sees all or nothing
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dt_abi_version.argtypes = []
    lib.dt_abi_version.restype = ctypes.c_int32
    lib.dt_gather_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int32]
    lib.dt_gather_rows.restype = None
    lib.dt_parse_floats.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.dt_parse_floats.restype = ctypes.c_int64
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        target = _library_path()
        if not target.exists() and not _build(target):
            return None
        try:
            lib = _bind(ctypes.CDLL(str(target)))
        except OSError:
            return None
        if lib.dt_abi_version() == ABI_VERSION:
            _lib = lib
        return _lib


def native_available() -> bool:
    """True when the C++ library is built and loaded."""
    return _load() is not None


def gather_rows(src: np.ndarray, indices: np.ndarray,
                out: Optional[np.ndarray] = None,
                n_threads: int = 4) -> np.ndarray:
    """dst[i] = src[indices[i]]; src is (N, ...) C-contiguous (memmap ok)."""
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    row_shape = src.shape[1:]
    if out is None:
        out = np.empty((len(idx),) + row_shape, dtype=src.dtype)
    elif (out.shape != (len(idx),) + row_shape or out.dtype != src.dtype
          or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(f"out must be a C-contiguous {src.dtype} array of "
                         f"shape {(len(idx),) + row_shape}")
    lib = _load()
    if lib is None or not src.flags["C_CONTIGUOUS"]:
        np.take(src, idx, axis=0, out=out)
        return out
    if len(idx) and (idx.min() < 0 or idx.max() >= src.shape[0]):
        raise IndexError(f"row index out of range for {src.shape[0]} rows")
    row_bytes = int(np.prod(row_shape, dtype=np.int64)) * src.dtype.itemsize
    lib.dt_gather_rows(src.ctypes.data, row_bytes, idx.ctypes.data,
                       len(idx), out.ctypes.data, n_threads)
    return out


# what the numpy parser reads exactly as strtod does: decimal values
_DECIMAL = re.compile(rb"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")
_SEPARATORS = re.compile(rb"[ \t\r]+")


def _parse_numpy(text: bytes) -> Tuple[np.ndarray, int]:
    values, rows = [], 0
    for line in text.split(b"\n"):
        tokens = [t for t in _SEPARATORS.split(line) if t]
        for t in tokens:
            if not _DECIMAL.fullmatch(t):
                raise ValueError(
                    f"{t[:32]!r} is not a decimal value: the native parser "
                    "(diffsheg_tpu_torch/runtime/native/dataplane.cpp) reads "
                    "such text differently, and its library did not build "
                    "(g++ missing?)")
            values.append(float(t))
        rows += bool(tokens)
    return np.asarray(values, dtype=np.float64), rows


def parse_float_text(text: bytes) -> Tuple[np.ndarray, int]:
    """Floats separated by spaces, tabs, carriage returns or commas ->
    (flat float64 array, number of newline-ended rows holding values)."""
    lib = _load()
    if lib is None:
        return _parse_numpy(text)
    # Upper bound on value count: N single-char values need 2N-1 bytes,
    # so (len+1)//2 + 1 can never truncate.
    max_vals = max(16, (len(text) + 1) // 2 + 1)
    out = np.empty(max_vals, dtype=np.float64)
    n_rows = ctypes.c_int64(0)
    n = lib.dt_parse_floats(text, len(text), out.ctypes.data, max_vals,
                            ctypes.byref(n_rows))
    return out[:n].copy(), int(n_rows.value)


def parse_frames_file(path: str) -> np.ndarray:
    """Numeric frame file -> (T, C) float64."""
    with open(path, "rb") as f:
        text = f.read()
    flat, rows = parse_float_text(text)
    if rows == 0:
        return np.zeros((0, 0))
    if len(flat) % rows:
        raise ValueError(f"{path}: {len(flat)} values do not split into "
                         f"{rows} rows")
    return flat.reshape(rows, -1)
