"""HuggingFace HuBERT / WavLM checkpoint -> the port's ``HubertModel``.

Counterpart of ``diffsheg_tpu/compat/hubert_ckpt.py`` for its two layouts:
HuBERT-large (``do_stable_layer_norm=True``, ``feat_extract_norm='layer'``:
the checkpoint DiffSHEG serves with, hubert-large-ls960-ft) and
HuBERT-base / wav2vec2-base (``feat_extract_norm='group'``: the first
conv's GroupNorm becomes ``gn_scale`` / ``gn_bias``; post-LN layers keep
the same key names), picked by the ``HubertConfig`` given; and, in the
port alone, a ``WavLMModel`` (microsoft/wavlm-large: bias-free convs, each
layer's ``attention.gru_rel_pos_linear`` and ``gru_rel_pos_const``, layer
0's ``attention.rel_attn_embed``).  A torch state dict becomes the
Flax-named numpy tree that ``compat/from_jax.py::load_flax_tree`` loads,
folding the weight-norm parametrization of the positional conv (the
legacy ``weight_g`` / ``weight_v`` names and torch >= 2.1's
``parametrizations.weight.original0/1``).

:func:`load_hf_hubert` reads a local file or directory only (never a hub
name) and does not import ``transformers``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
from diffsheg_tpu_torch.models.hubert import HubertConfig, HubertModel

# the prefixes of HF's heads over the encoder (``HubertForCTC``,
# ``WavLMForCTC``)
_HEAD_PREFIXES = ("hubert.", "wavlm.")


def _t(x) -> np.ndarray:
    """torch tensor / array -> float32 numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _dense(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": _t(sd[f"{prefix}.weight"]).T,
            "bias": _t(sd[f"{prefix}.bias"])}


def _ln(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _t(sd[f"{prefix}.weight"]),
            "bias": _t(sd[f"{prefix}.bias"])}


def _pos_conv_weight(sd: Mapping, prefix: str) -> np.ndarray:
    """The positional conv's weight, ``weight_norm(conv, dim=2)`` folded:
    w = g * v / ||v||, the norm over dims (0, 1) per kernel position."""
    if f"{prefix}.weight" in sd:
        return _t(sd[f"{prefix}.weight"])
    if f"{prefix}.weight_g" in sd:
        g, v = _t(sd[f"{prefix}.weight_g"]), _t(sd[f"{prefix}.weight_v"])
    else:
        g = _t(sd[f"{prefix}.parametrizations.weight.original0"])
        v = _t(sd[f"{prefix}.parametrizations.weight.original1"])
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def convert_hubert_state_dict(sd: Mapping[str, Any],
                              cfg: Optional[HubertConfig] = None
                              ) -> Dict[str, Any]:
    """HF HuBERT state dict -> ``{'params': ...}`` (Flax names, float32
    numpy) for the layout of ``cfg`` (default HuBERT-large); a ``hubert.``
    or ``wavlm.`` prefix (a ``...ForCTC`` head) is dropped."""
    cfg = cfg or HubertConfig()
    if not any(k.startswith("feature_extractor") for k in sd):
        for prefix in _HEAD_PREFIXES:
            if any(k.startswith(prefix) for k in sd):
                sd = {k[len(prefix):]: v for k, v in sd.items()
                      if k.startswith(prefix)}
                break
    fe: Dict[str, Any] = {}
    for i in range(len(cfg.conv_dim)):
        base = f"feature_extractor.conv_layers.{i}"
        conv = {"kernel": _t(sd[f"{base}.conv.weight"]).transpose(2, 1, 0)}
        if f"{base}.conv.bias" in sd:
            conv["bias"] = _t(sd[f"{base}.conv.bias"])
        fe[f"conv_{i}"] = conv
        if cfg.conv_norm != "group_first":
            fe[f"ln_{i}"] = _ln(sd, f"{base}.layer_norm")
        elif i == 0:    # the GroupNorm's affine parameters
            fe["gn_scale"] = _t(sd[f"{base}.layer_norm.weight"])
            fe["gn_bias"] = _t(sd[f"{base}.layer_norm.bias"])
    p: Dict[str, Any] = {
        "feature_extractor": fe,
        "feat_proj_ln": _ln(sd, "feature_projection.layer_norm"),
        "feat_proj": _dense(sd, "feature_projection.projection"),
        "pos_conv": {"conv": {
            "kernel": _pos_conv_weight(
                sd, "encoder.pos_conv_embed.conv").transpose(2, 1, 0),
            "bias": _t(sd["encoder.pos_conv_embed.conv.bias"])}},
    }
    for i in range(cfg.num_layers):
        base = f"encoder.layers.{i}"
        # pre-LN and post-LN share the key names: 'layer_norm' is the
        # attention-side norm, 'final_layer_norm' the ffn-side one
        p[f"layer_{i}"] = {
            "attn_ln": _ln(sd, f"{base}.layer_norm"),
            "attn": {n: _dense(sd, f"{base}.attention.{n}")
                     for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "ffn_ln": _ln(sd, f"{base}.final_layer_norm"),
            "fc1": _dense(sd, f"{base}.feed_forward.intermediate_dense"),
            "fc2": _dense(sd, f"{base}.feed_forward.output_dense"),
        }
        if cfg.rel_pos_buckets:
            attn, a = p[f"layer_{i}"]["attn"], f"{base}.attention"
            if i == 0:
                attn["rel_attn_embed"] = {
                    "embedding": _t(sd[f"{a}.rel_attn_embed.weight"])}
            attn["gru_rel_pos_linear"] = _dense(sd,
                                                f"{a}.gru_rel_pos_linear")
            # HF keeps it (1, heads, 1, 1)
            attn["gru_rel_pos_const"] = _t(
                sd[f"{a}.gru_rel_pos_const"]).reshape(-1)
    p["final_ln"] = _ln(sd, "encoder.layer_norm")
    return {"params": p}


def load_hf_hubert(path: str, cfg: Optional[HubertConfig] = None
                   ) -> HubertModel:
    """A ``HubertModel`` from a local HuggingFace checkpoint: a
    ``pytorch_model.bin`` / ``model.safetensors`` file, or a directory
    holding one (``.safetensors`` needs the ``safetensors`` package), in
    ``cfg``'s layout (default HuBERT-large;
    ``models/hubert.py::wavlm_large_config`` / ``wav2vec2_base_config``
    for the others).  On the CPU in float32."""
    if os.path.isdir(path):
        names = [n for n in ("model.safetensors", "pytorch_model.bin")
                 if os.path.exists(os.path.join(path, n))]
        if not names:
            raise FileNotFoundError(
                f"{path}: no model.safetensors or pytorch_model.bin")
        path = os.path.join(path, names[0])
    elif not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: not a local file or directory (hub names are not "
            "fetched; download the checkpoint first)")
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    cfg = cfg or HubertConfig()
    return load_flax_tree(HubertModel(cfg), convert_hubert_state_dict(sd, cfg))


def hf_state_dict(model: HubertModel) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`convert_hubert_state_dict`: ``model``'s
    weights under the HuggingFace ``HubertModel`` (``WavLMModel``) names of
    its layout
    (the positional conv's weight folded, as a plain ``weight``), e.g. to
    write a local checkpoint of seeded weights for :func:`load_hf_hubert`."""
    cfg = model.cfg
    ours = model.state_dict()
    sd: Dict[str, torch.Tensor] = {}

    def put(dst: str, src: str) -> None:
        for leaf in ("weight", "bias"):
            if f"{src}.{leaf}" in ours:
                sd[f"{dst}.{leaf}"] = ours[f"{src}.{leaf}"].detach().clone()

    for i in range(len(cfg.conv_dim)):
        base = f"feature_extractor.conv_layers.{i}"
        put(f"{base}.conv", f"feature_extractor.conv_{i}")
        put(f"{base}.layer_norm", f"feature_extractor.ln_{i}")
    if cfg.conv_norm == "group_first":
        fe = "feature_extractor"
        sd[f"{fe}.conv_layers.0.layer_norm.weight"] = ours[f"{fe}.gn_scale"]
        sd[f"{fe}.conv_layers.0.layer_norm.bias"] = ours[f"{fe}.gn_bias"]
    put("feature_projection.layer_norm", "feat_proj_ln")
    put("feature_projection.projection", "feat_proj")
    put("encoder.pos_conv_embed.conv", "pos_conv.conv")
    for i in range(cfg.num_layers):
        base = f"encoder.layers.{i}"
        put(f"{base}.layer_norm", f"layer_{i}.attn_ln")
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"{base}.attention.{n}", f"layer_{i}.attn.{n}")
        put(f"{base}.final_layer_norm", f"layer_{i}.ffn_ln")
        put(f"{base}.feed_forward.intermediate_dense", f"layer_{i}.fc1")
        put(f"{base}.feed_forward.output_dense", f"layer_{i}.fc2")
        if cfg.rel_pos_buckets:
            a, ours_a = f"{base}.attention", f"layer_{i}.attn"
            put(f"{a}.gru_rel_pos_linear", f"{ours_a}.gru_rel_pos_linear")
            sd[f"{a}.gru_rel_pos_const"] = ours[
                f"{ours_a}.gru_rel_pos_const"].detach().clone().view(
                    1, -1, 1, 1)
            put(f"{a}.rel_attn_embed", f"{ours_a}.rel_attn_embed")
    put("encoder.layer_norm", "final_ln")
    return sd
