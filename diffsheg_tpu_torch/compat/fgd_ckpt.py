"""Reference FGD autoencoder checkpoint conversion.

Counterpart of ``diffsheg_tpu/compat/fgd_ckpt.py``.  The reference
evaluates FGD with a pretrained frozen pose autoencoder (``ae_300.bin``
for BEAT, ``gesture_expression.pth.tar`` for SHOW) loaded into
``HalfEmbeddingNet`` (reference runner.py:60-65,
trainers/ddpm_beat_trainer.py:320-332).  Its state dict maps onto the
Flax variables tree of ``eval/fgd_net.py`` (the names the port's net
carries), which ``compat/from_jax.py::load_flax_tree`` loads:

  pose_encoder.net.0.{0,1}   Conv1d(dim, base, 3) + BN      -> conv0 / bn0
  pose_encoder.net.1.{0,1}   Conv1d(base, 2b, 3) + BN       -> conv1 / bn1
  pose_encoder.net.2.{0,1}   Conv1d(2b, 2b, 4, s2) + BN     -> conv2 / bn2
  pose_encoder.net.3         Conv1d(2b, base, 3)            -> conv3
  34-frame head:  out_net.{0,1,3,4,6}                       -> fc1/fcbn1/fc2/fcbn2/fc3
  88/64-frame head: out_net.{0,1,2,3,5,6,8}                 -> fc0/fcbn0/fc1/fcbn1/fc2/fcbn2/fc3
  pose_encoder.fc_mu                                        -> fc_mu
  (fc_logvar and the decoder are dropped: FGD uses mu only)

Linear (out, in) -> kernel (in, out); Conv1d (out, in, k) -> (k, in,
out); BatchNorm weight / bias -> scale / bias and its running statistics
-> batch_stats mean / var.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import torch

from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
from diffsheg_tpu_torch.compat.torch_ckpt import _conv1d, _linear, _t
from diffsheg_tpu_torch.device import DeviceLike, resolve_device
from diffsheg_tpu_torch.eval.fgd_net import FgdFeatureNet, FgdNetConfig


def _bn(sd: Dict[str, Any], prefix: str):
    """torch BatchNorm1d -> (params, batch_stats) under the ``_BN``
    wrapper's inner-module name."""
    params = {"BatchNorm_0": {"scale": _t(sd[f"{prefix}.weight"]),
                              "bias": _t(sd[f"{prefix}.bias"])}}
    stats = {"BatchNorm_0": {"mean": _t(sd[f"{prefix}.running_mean"]),
                             "var": _t(sd[f"{prefix}.running_var"])}}
    return params, stats


def normalize_fgd_state_dict(checkpoint: Any) -> Dict[str, Any]:
    """Unwrap the reference's checkpoint containers: ``model_state``, then
    ``state_dict``, then the raw dict, ``module.`` prefixes stripped
    (``load_fid_net``, ddpm_beat_trainer.py:320-332)."""
    sd = checkpoint
    if isinstance(sd, dict):
        for key in ("model_state", "state_dict"):
            if key in sd and isinstance(sd[key], dict):
                sd = sd[key]
                break
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def convert_fgd_state_dict(state_dict: Dict[str, Any],
                           cfg: FgdNetConfig) -> Dict[str, Any]:
    """HalfEmbeddingNet state dict -> the FgdFeatureNet variables tree
    (``{"params": ..., "batch_stats": ...}`` of float32 numpy arrays)."""
    sd = normalize_fgd_state_dict(state_dict)
    enc = "pose_encoder"
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def conv(prefix):
        return dict(_conv1d(sd, prefix), bias=_t(sd[f"{prefix}.bias"]))

    for i in range(3):
        params[f"conv{i}"] = conv(f"{enc}.net.{i}.0")
        params[f"bn{i}"], stats[f"bn{i}"] = _bn(sd, f"{enc}.net.{i}.1")
    params["conv3"] = conv(f"{enc}.net.3")

    if cfg.n_frames >= 64:
        # Linear,BN,Linear,BN,LReLU,Linear,BN,LReLU,Linear
        lin_idx = {"fc0": 0, "fc1": 2, "fc2": 5, "fc3": 8}
        bn_idx = {"fcbn0": 1, "fcbn1": 3, "fcbn2": 6}
    else:
        # Linear,BN,LReLU,Linear,BN,LReLU,Linear
        lin_idx = {"fc1": 0, "fc2": 3, "fc3": 6}
        bn_idx = {"fcbn1": 1, "fcbn2": 4}
    for name, i in lin_idx.items():
        params[name] = _linear(sd, f"{enc}.out_net.{i}")
    for name, i in bn_idx.items():
        params[name], stats[name] = _bn(sd, f"{enc}.out_net.{i}")
    params["fc_mu"] = _linear(sd, f"{enc}.fc_mu")
    return {"params": {"pose_encoder": params},
            "batch_stats": {"pose_encoder": stats}}


def load_torch_fgd_checkpoint(path: str, cfg: FgdNetConfig,
                              device: DeviceLike = None) -> FgdFeatureNet:
    """``ae_300.bin`` / ``gesture_expression.pth.tar`` -> an FgdFeatureNet
    in inference mode on ``device`` (default: the GPU; raises without
    one).  Loaded with ``weights_only``; the reference's checkpoints also
    hold their ``argparse.Namespace`` of options, which is allowed."""
    dev = resolve_device(device)
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    net = load_flax_tree(FgdFeatureNet(cfg), convert_fgd_state_dict(ckpt, cfg))
    return net.to(dev).eval()
