"""Metric logging: a JSONL file and stdout.

The port's own copy of ``diffsheg_tpu/utils/logging.py``: one JSON record
per metrics step (and per text line) in ``<workdir>/metrics.jsonl``,
human-readable lines on stdout, wandb only when asked for and importable.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, workdir: str, name: str = "run",
                 use_wandb: bool = False, wandb_project: Optional[str] = None):
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self.name = name
        self._t0 = time.time()
        self._wandb = None
        if use_wandb:
            try:  # pragma: no cover - wandb optional
                import wandb
                self._wandb = wandb
                wandb.init(project=wandb_project or "diffsheg_tpu",
                           name=name)
            except Exception:
                self._wandb = None

    def log_metrics(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3),
               **{k: (float(v) if isinstance(v, (int, float)) else v)
                  for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:  # pragma: no cover
            self._wandb.log(metrics, step=step)

    def log_text(self, msg: str) -> None:
        line = f"[{self.name}] {msg}"
        print(line, file=sys.stdout, flush=True)
        self._f.write(json.dumps({"text": msg,
                                  "t": round(time.time() - self._t0, 3)})
                      + "\n")

    def close(self) -> None:
        self._f.close()
