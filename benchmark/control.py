"""Readings for a cell's limits of ``correct``, on the card at the cell's
own size: per seed, the program's numbers as a run's check computes them
(the lower reading), the control's (the upper reading) and, for
training, a planted fault's.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--profile]

A bf16 stream reads two controls: the program with its weight-only int8
path on (``controls`` in the traffic mix), and the reference computed on
e4m3 operands (``reference/precision.py``); f32 training's control is the
reference with TF32 on, put in the program's place.  The training fault is the
reference over half of each batch (the mean taken over the rest).
``--profile`` adds a stream's error by window.  One JSON line a seed.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import json  # noqa: E402

import torch  # noqa: E402

from benchmark.harness import Loader, cache_dirs  # noqa: E402
from benchmark.tracing import Tracer  # noqa: E402


def stream_readings(gen, profile):
    from benchmark.traffic.stream import window_errors
    clips = list(range(gen.mix["check_clips"]))
    prog = {i: gen.serve(i) for i in clips}
    gen.pipe = None
    ctrl_pipe = gen._pipeline(gen.mix["controls"]["program_path"])
    ctrl = {i: gen.serve(i, ctrl_pipe) for i in clips}
    del ctrl_pipe
    gen.free()
    ref = gen.reference(clips)
    fp8 = gen.reference(clips, fp8=True)
    step = gen.config["data"]["n_poses"] - gen.config["stream"]["overlap_len"]
    errs = {name: [window_errors(y[i][0], ref[k], step)
                   for k, i in enumerate(clips)]
            for name, y in (("program", prog), ("int8_path", ctrl),
                            ("fp8_reference",
                             {i: fp8[k][None] for k, i in enumerate(clips)}))}
    out = {name: max(max(e) for e in v) for name, v in errs.items()}
    if profile:
        out["by_window"] = {name: [round(x, 6) for x in v[0]]
                            for name, v in errs.items()}
    return out


def train_readings(gen):
    from benchmark.traffic.train import compare
    limits = gen.cell["limits"]
    gen.free()
    ref = gen.reference()
    out = {"program": compare(limits, gen.losses, gen.first_grad, gen.change,
                              *ref)}
    out["control"] = compare(limits, *gen.reference(tf32=True), *ref)
    draw = gen.draw

    def half(k):
        batch, t, noise = draw(k)
        n = t.shape[0] // 2
        return {k_: v[:n] for k_, v in batch.items()}, t[:n], noise[:n]

    gen.draw = half
    out["fault_half_batch"] = compare(limits, *gen.reference(), *ref)
    gen.draw = draw
    return out


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    cache_dirs()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    loader = Loader()
    cell = loader.cell(args.workload)
    mix = loader.traffic(cell["traffic"])
    config = loader.config(cell["config"])
    gen_mod = loader.generator(mix["generator"])
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        gen = gen_mod.Generator(cell, mix, config, seed, dev, Tracer(False, ""))
        gen.setup()
        out = (train_readings(gen) if mix["generator"] == "train"
               else stream_readings(gen, args.profile))
        gen.free()
        del gen
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": round(time.perf_counter() - t0, 1),
                          **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
