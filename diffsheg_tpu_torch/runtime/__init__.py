"""Host data plane: bulk float parsing for frame files, batch row gather.

The port's own numpy copy of ``diffsheg_tpu/runtime/__init__.py``'s
entry points (its numpy fallbacks, without the C++ ``dataplane.cpp``):

  - :func:`parse_float_text` / :func:`parse_frames_file` — the cache
    build's reader of header-less numeric frame files (BEAT ``bvh_rot``);
  - :func:`gather_rows` — ``dst[i] = src[indices[i]]`` over a (memory
    mapped) array, ``np.take``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def gather_rows(src: np.ndarray, indices: np.ndarray,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """dst[i] = src[indices[i]], ``src`` (N, ...) (memory-mapped or not)."""
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    if out is None:
        out = np.empty((len(idx),) + src.shape[1:], dtype=src.dtype)
    np.take(src, idx, axis=0, out=out)
    return out


def parse_float_text(text: bytes) -> Tuple[np.ndarray, int]:
    """Whitespace-separated floats -> (flat float64 array, number of
    non-blank rows)."""
    n_rows = sum(1 for r in text.splitlines() if r.strip())
    flat = np.array([float(v) for v in text.split()], dtype=np.float64)
    return flat, n_rows


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
