"""The system under test: the DiffSHEG port's objects, built from a
configuration file, a traffic mix's ``program`` settings and the
benchmark's own weights.  The only module of the benchmark, with the
generators, that imports the port."""

from __future__ import annotations

import copy

import torch

from benchmark import weights


def merged(config: dict, settings: dict) -> dict:
    """``config`` with each group of ``settings`` laid over it."""
    out = copy.deepcopy(config)
    for group, values in settings.items():
        if isinstance(values, dict):
            out.setdefault(group, {}).update(values)
        else:
            out[group] = values
    return out


def port_config(config: dict):
    """The port's ``Config`` for a merged configuration dict."""
    from diffsheg_tpu_torch.config import (Config, DataConfig,
                                           DiffusionConfig, ModelConfig,
                                           StreamConfig, TrainConfig)
    return Config(name=config["name"],
                  model=ModelConfig(**config["model"]),
                  diffusion=DiffusionConfig(**config["diffusion"]),
                  stream=StreamConfig(**config["stream"]),
                  data=DataConfig(**config["data"]),
                  train=TrainConfig(**config["train"]))


def hubert_config(config: dict, dtype: str):
    from diffsheg_tpu_torch.models.hubert import HubertConfig
    h = {k: tuple(v) if isinstance(v, list) else v
         for k, v in config["hubert"].items()}
    return HubertConfig(dtype=dtype, **h)


def denoiser_state(config: dict, seed: int, device):
    from benchmark.reference.denoiser import UniDiffuser
    return weights.make_state(weights.build(UniDiffuser, config["model"]),
                              seed, "denoiser", device)


def hubert_state(config: dict, seed: int, device):
    from benchmark.reference.speech import Hubert
    return weights.make_state(weights.build(Hubert, config["hubert"]),
                              seed, "hubert", device)


def port_denoiser(cfg, state, device):
    from diffsheg_tpu_torch.models.unidiffuser import UniDiffuser
    return weights.build(UniDiffuser, cfg.model, state=state, device=device)


def port_hubert(hcfg, state, device):
    from diffsheg_tpu_torch.models.hubert import HubertModel
    return weights.build(HubertModel, hcfg, state=state, device=device)


def precise(f32: bool = True) -> None:
    """f32 products in f32 (no TF32), as the configurations state."""
    torch.backends.cuda.matmul.allow_tf32 = not f32
    torch.backends.cudnn.allow_tf32 = not f32
