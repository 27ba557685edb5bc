"""Readings for the limits of a frontend training cell's ``correct``
(``traffic/train_frontend.py``), on the card at the cell's own size, per
seed: the program's numbers as a run's check computes them, and two
controls that the limits must reject:

- ``reference_tf32``: the reference frontend and step with TF32 on, put
  in the program's place (a lower precision);
- ``program_ungated``: the program with the encoder's relative-position
  bias added ungated (``GatedRelPosAttention.bias`` replaced for the run:
  the gate held at 1), the same weights otherwise (a missing gate).

    python3 benchmark/control_frontend.py --workload beat-wavlm-train-fe-f32 --seeds 1,2,3

One JSON line a seed, each reading beside its limit's name.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")

import json  # noqa: E402

import torch  # noqa: E402

from benchmark.harness import Loader, cache_dirs  # noqa: E402
from benchmark.reference.wavlm import window_rel_rms  # noqa: E402
from benchmark.tracing import Tracer  # noqa: E402
from benchmark.traffic.train import compare  # noqa: E402


def readings(gen):
    limits = gen.cell["limits"]
    runs = {"program": (gen.features, gen.losses, gen.first_grad, gen.change)}
    gen.free()
    ref = gen.reference()
    ref_features = gen.ref_features
    tf32 = gen.reference(tf32=True)
    runs["reference_tf32"] = (gen.ref_features,) + tuple(tf32)
    from diffsheg_tpu_torch.models.hubert import GatedRelPosAttention
    gated = GatedRelPosAttention.bias
    GatedRelPosAttention.bias = lambda self, x, position_bias: position_bias
    try:
        gen.setup()
    finally:
        GatedRelPosAttention.bias = gated
    runs["program_ungated"] = (gen.features, gen.losses, gen.first_grad,
                               gen.change)
    gen.free()
    out = {}
    for name, (feats, losses, first, change) in runs.items():
        got = {"encoder_window_rel_rms": window_rel_rms(feats, ref_features)}
        got.update({k: v["value"] for k, v in compare(
            limits, losses, first, change, *ref).items()})
        out[name] = got
    return out


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    cache_dirs()
    if not torch.cuda.is_available():
        print("control_frontend: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
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
        out = readings(gen)
        del gen
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": round(time.perf_counter() - t0, 1),
                          "limits": cell["limits"], **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
