"""Shared validity guards for throughput benchmarks.

Counterpart of ``diffsheg_tpu/utils/benchguard.py`` with CUDA semantics.
A benchmark that publishes a JSON artifact refuses to certify a number
the card did not produce (see ``utils/calibration.py``):

1. :func:`calibrate_or_exit` — device-level probe (achieved TFLOP/s
   against the card's physical envelope), JSON + nonzero rc on failure;
2. :func:`build_guarded` — per-program probe around build + warm-up: the
   card must record kernels while the program runs and its outputs must
   be on the card (``calibration.device_activity``); a miss triggers ONE
   call of the caller's ``retry()`` and a rebuild, then a loud invalid
   exit;
3. :func:`timed_reps` — the measured loop, each call waited for with a
   blocking CUDA event, returning per-rep wall times plus the host-CPU
   fraction over the whole block for the artifact.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, Tuple

from diffsheg_tpu_torch.utils.calibration import (CalibrationResult,
                                                  calibrate, device_activity,
                                                  wait_blocking)


def calibrate_or_exit(metric: str, unit: str = "frames/s",
                      allow_cpu: bool = False,
                      device=None) -> CalibrationResult:
    """Run the device calibration; on failure print an invalid artifact
    (``value`` 0, ``valid: false``) and exit nonzero."""
    calib = calibrate(allow_cpu=allow_cpu, device=device)
    print(f"calibration[{calib.backend}/{calib.device_kind}]: "
          f"{calib.calib_tflops:.1f} TFLOP/s sustained, "
          f"dispatch {calib.dispatch_ms:.3f} ms"
          + ("" if calib.ok else f"  INVALID: {calib.reason}"),
          file=sys.stderr)
    if not calib.ok:
        print(json.dumps({"metric": metric, "value": 0.0, "unit": unit,
                          "vs_baseline": 0.0, **calib.json_fields()}))
        sys.exit(1)
    return calib


def build_guarded(build_and_warm: Callable[[], object],
                  probe_call: Callable[[object], object],
                  retry: Callable[[], None],
                  metric: str, calib: CalibrationResult,
                  unit: str = "frames/s",
                  max_probe_wall: float = float("inf")):
    """Build + warm a program with per-program placement detection.

    ``build_and_warm()`` constructs and warms the program under test;
    ``probe_call(built)`` runs ONE call of the program that will be timed
    and returns its output.  When the card records no kernel during that
    call, its output is not on the card, or the call is slower than
    ``max_probe_wall`` seconds, ``retry()`` is invoked and the build runs
    once more; a second detection prints an invalid artifact and exits 1.
    With a CPU calibration (``device="cpu"``) the program is expected on
    the host and is returned unprobed.  Returns the built object.
    """
    for attempt in (0, 1):
        built = build_and_warm()
        if calib.backend == "cpu":
            return built
        act = device_activity(lambda: probe_call(built))
        print(f"execution-locality probe: {act.line()} "
              f"max_wall={max_probe_wall:.1f}s", file=sys.stderr)
        if act.on_card and act.wall_s <= max_probe_wall:
            return built
        reason = ((f"the card ran {act.kernels} kernels and the outputs "
                   f"are {'' if act.outputs_on_card else 'not '}on it "
                   f"during a {act.wall_s:.2f}s call")
                  if not act.on_card else
                  f"probe call took {act.wall_s:.1f}s > "
                  f"{max_probe_wall:.1f}s plausibility floor")
        if attempt == 0:
            print(f"program not on the card at warm-up ({reason}) — "
                  f"retrying the build", file=sys.stderr)
            retry()
            continue
        print(json.dumps({
            "metric": metric, "value": 0.0, "unit": unit,
            "vs_baseline": 0.0, **calib.json_fields(),
            "valid": False,
            "invalid_reason": "benched program does not run on the card "
                              f"even after a rebuild: {reason}",
        }))
        sys.exit(1)


def timed_reps(call: Callable[[int], object], n: int) -> Tuple[list, float]:
    """Time ``call(i)`` for i in range(n), each waited for with a blocking
    CUDA event.  Returns (per-rep wall seconds, host_cpu_frac over the
    whole block)."""
    totals = []
    c0, w0 = time.process_time(), time.perf_counter()
    for i in range(n):
        t0 = time.perf_counter()
        call(i)
        wait_blocking()
        totals.append(time.perf_counter() - t0)
    frac = (time.process_time() - c0) / max(time.perf_counter() - w0, 1e-9)
    return totals, frac
