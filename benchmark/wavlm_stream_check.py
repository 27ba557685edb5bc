"""A 60 s BEAT stream with WavLM-Large as the speech encoder, in bf16
through ``FusedPipeline`` (as ``beat-stream-bf16`` serves with HuBERT),
against the f32 reference: shows that the generation path takes the
encoder of a configuration (not a cell of the benchmark).

    python3 benchmark/wavlm_stream_check.py --seed 3141592653 [--seconds 10]

``traffic/stream.py``'s generator with the ``beat-wavlm`` configuration,
the encoder's weights and reference swapped for WavLM's
(``traffic/train_frontend.py::encoder_state``, ``reference/wavlm.py``:
the long-audio runner of ``reference/speech.py`` takes any encoder with
HuBERT's call).  Prints one JSON line: the worst window's relative RMS
beside the stream cells' limit, the clips served and the fps.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import json  # noqa: E402

import torch  # noqa: E402

from benchmark import program  # noqa: E402
from benchmark.harness import Loader, cache_dirs  # noqa: E402
from benchmark.reference import speech as ref_speech  # noqa: E402
from benchmark.reference import wavlm as ref_wavlm  # noqa: E402
from benchmark.tracing import Tracer  # noqa: E402
from benchmark.traffic import stream  # noqa: E402
from benchmark.traffic.train_frontend import encoder_state  # noqa: E402


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    cache_dirs()
    torch.set_num_threads(1)
    program.hubert_state = encoder_state
    ref_speech.Hubert = ref_wavlm.WavLM
    loader = Loader()
    cell = loader.cell("beat-stream-bf16")
    gen = stream.Generator(cell, loader.traffic(cell["traffic"]),
                           loader.config("beat-wavlm"), args.seed,
                           torch.device("cuda"), Tracer(False, ""))
    gen.setup()
    window = gen.run(args.seconds)
    gen.free()
    check = gen.check()["window_rel_rms"]
    print(json.dumps({"seed": args.seed, "window_rel_rms": check["value"],
                      "limit": check["limit"], "clips": window["attempted"],
                      "failed": window["failed"],
                      "fps": window["end_to_end"]["fps"]}))
    return 0 if window["failed"] == 0 and check["value"] <= check["limit"] \
        else 1


if __name__ == "__main__":
    sys.exit(main())
