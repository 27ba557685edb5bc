"""A configuration shrunk for runs on the CPU, and a one-call dry run of
a cell at that size."""

import copy
import time

import torch

from benchmark.harness import Loader, run_cell
from benchmark.tracing import Tracer


def tiny(config, mix, dtype="float32", clip_seconds=3):
    """Widths cut to a few dozen, a 3 s clip (two windows), a batch of 8
    from a pool of 16; every setting in ``dtype`` (f32: the port's CPU
    path then agrees with the f32 reference to rounding)."""
    config, mix = copy.deepcopy(config), copy.deepcopy(mix)
    config["model"].update(latent_dim=32, num_layers=2, num_heads=2,
                           ff_size=64, hubert_dim=32, hubert_latent_dim=16,
                           aud_latent_dim=32)
    config["hubert"].update(hidden_size=32, num_layers=2, num_heads=2,
                            intermediate_size=64, conv_dim=[32] * 7,
                            num_conv_pos_embeddings=16,
                            num_conv_pos_embedding_groups=4)
    if "clip_seconds" in mix:
        mix["clip_seconds"] = clip_seconds
        mix["program"]["hubert_dtype"] = dtype
    if "pool" in mix:
        mix.update(pool=16, batch=8)
    mix["program"]["model"]["compute_dtype"] = dtype
    return config, mix


def dry_run(cell, seed=7, loader=None, **kw):
    torch.manual_seed(0)
    return run_cell(loader or Loader(), cell, seed, 0.1, False,
                    torch.device("cpu"), time.perf_counter(),
                    overrides=lambda c, m: tiny(c, m, **kw))


def generator(cell, seed=7, **kw):
    """The cell's generator at the tiny size, set up on the CPU."""
    loader = Loader()
    entry = loader.cell(cell)
    config, mix = tiny(loader.config(entry["config"]),
                       loader.traffic(entry["traffic"]), **kw)
    gen = loader.generator(mix["generator"]).Generator(
        entry, mix, config, seed, torch.device("cpu"), Tracer(False, ""))
    gen.setup()
    return gen
