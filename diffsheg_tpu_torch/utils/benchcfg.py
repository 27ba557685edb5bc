"""Shared benchmark-configuration knobs.

The port's own copy of ``diffsheg_tpu/utils/benchcfg.py``.  A throughput
benchmark honours ``BENCH_JN`` — which of the reference's published
inference configurations to measure (jump_n_sample 2 = the fast config,
5 = the default slow one, each with its own A100 baseline FPS from
``inference_custom_audio_{beat,show}.sh``).  The env parsing and the
unknown-value failure live here so benchmarks cannot drift.  Nothing on
the port's serving or training path reads ``BENCH_JN``.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Tuple


def jump_config_baseline(baselines: Dict[int, float]) -> Tuple[int, float]:
    """Read ``BENCH_JN`` and return ``(jump_n_sample, baseline_fps)``.

    ``baselines`` maps jump_n_sample -> the published A100 FPS for that
    configuration; an unpublished value exits rather than reporting a
    meaningless ``vs_baseline`` ratio.
    """
    jn = int(os.environ.get("BENCH_JN", "2"))
    if jn not in baselines:
        sys.exit(f"BENCH_JN={jn}: no published A100 baseline for this "
                 f"jump_n_sample (known: {sorted(baselines)}) — a "
                 "vs_baseline ratio would be meaningless")
    return jn, baselines[jn]
