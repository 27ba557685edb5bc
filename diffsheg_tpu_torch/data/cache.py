"""Memory-mapped array cache: one ``.npy`` file a field.

The port's own copy of ``diffsheg_tpu/data/cache.py`` (numpy only), with
the same directory layout (``manifest.json`` + one ``.npy`` per field,
ragged fields as a flat array + an ``.offsets.npy`` table), so a cache
that the JAX package's ``build-cache`` wrote reads here:

  - fixed-shape fields (train windows): (N, ...) arrays, a batch gather
    copies rows straight from the page cache (``runtime.gather_rows``);
  - ragged fields (whole clips of different lengths): a flat (sum_T, ...)
    array + (N+1,) offsets.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from diffsheg_tpu_torch import runtime

MANIFEST = "manifest.json"


class CacheWriter:
    """Accumulates samples and writes one array file per field.

    Fields whose per-sample shape varies are stored ragged automatically.
    """

    def __init__(self, out_dir: str, meta: Optional[Dict] = None):
        self.out_dir = out_dir
        self.meta = dict(meta or {})
        self._rows: List[Dict[str, np.ndarray]] = []

    def add(self, sample: Mapping[str, np.ndarray]) -> None:
        self._rows.append({k: np.asarray(v) for k, v in sample.items()})

    def __len__(self) -> int:
        return len(self._rows)

    def finalize(self) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        if not self._rows:
            fields: Dict[str, Dict] = {}
        else:
            keys = list(self._rows[0].keys())
            fields = {}
            for k in keys:
                arrs = [r[k] for r in self._rows]
                shapes = {a.shape for a in arrs}
                if len(shapes) == 1:
                    stacked = np.stack(arrs)
                    np.save(os.path.join(self.out_dir, f"{k}.npy"), stacked)
                    fields[k] = {"kind": "fixed", "shape": list(stacked.shape),
                                 "dtype": str(stacked.dtype)}
                else:
                    # ragged along axis 0; remaining dims must agree
                    tails = {a.shape[1:] for a in arrs}
                    if len(tails) != 1:
                        raise ValueError(f"ragged field {k}: {tails}")
                    flat = np.concatenate(arrs, axis=0)
                    offsets = np.zeros(len(arrs) + 1, dtype=np.int64)
                    np.cumsum([a.shape[0] for a in arrs], out=offsets[1:])
                    np.save(os.path.join(self.out_dir, f"{k}.npy"), flat)
                    np.save(os.path.join(self.out_dir, f"{k}.offsets.npy"),
                            offsets)
                    fields[k] = {"kind": "ragged", "shape": list(flat.shape),
                                 "dtype": str(flat.dtype)}
        manifest = {"n_samples": len(self._rows), "fields": fields,
                    "meta": self.meta}
        with open(os.path.join(self.out_dir, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2)


class ArrayCache:
    """Read side: memory-maps every field; samples come out as numpy views."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        with open(os.path.join(cache_dir, MANIFEST)) as f:
            manifest = json.load(f)
        self.n_samples: int = manifest["n_samples"]
        self.meta: Dict = manifest.get("meta", {})
        self._fields: Dict[str, Dict] = manifest["fields"]
        self._arrays: Dict[str, np.ndarray] = {}
        self._offsets: Dict[str, np.ndarray] = {}
        for k, spec in self._fields.items():
            self._arrays[k] = np.load(os.path.join(cache_dir, f"{k}.npy"),
                                      mmap_mode="r")
            if spec["kind"] == "ragged":
                self._offsets[k] = np.load(
                    os.path.join(cache_dir, f"{k}.offsets.npy"))

    @property
    def fields(self) -> List[str]:
        return list(self._fields.keys())

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        out = {}
        for k, spec in self._fields.items():
            if spec["kind"] == "fixed":
                out[k] = self._arrays[k][idx]
            else:
                o = self._offsets[k]
                out[k] = self._arrays[k][o[idx]:o[idx + 1]]
        return out

    def gather(self, field: str, indices: np.ndarray) -> np.ndarray:
        """Batch gather of a fixed-shape field: the native data plane's
        threaded row copy (``runtime.gather_rows``), ``np.take`` without
        it."""
        if self._fields[field]["kind"] != "fixed":
            raise ValueError(f"{field} is ragged")
        return runtime.gather_rows(self._arrays[field],
                                   np.asarray(indices, dtype=np.int64))

    def batch(self, indices: np.ndarray,
              fields: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        fields = fields or self.fields
        return {k: self.gather(k, indices) for k in fields
                if self._fields[k]["kind"] == "fixed"}


def cache_exists(cache_dir: str) -> bool:
    return os.path.exists(os.path.join(cache_dir, MANIFEST))
