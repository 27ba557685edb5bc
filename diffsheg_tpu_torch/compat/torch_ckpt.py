"""Reference (DiffSHEG) checkpoint conversion.

Counterpart of ``diffsheg_tpu/compat/torch_ckpt.py``.  The reference saves
``{'encoder': state_dict, 'opt_encoder': ..., 'ep': ...}`` tar files; its
module names map onto the Flax parameter tree that the port's modules
also use, so a reference state dict is converted to that tree (numpy)
and loaded by ``compat/from_jax.py::load_flax_tree`` — the one mapping
onto the port's modules.  Key mapping (reference -> Flax names):

  time_embed.{0,2}                         -> time_embed.{fc1,fc2}
  encoder_{exp,ges}.hubert_encoder.{0,1,3} -> hubert_encoder.{conv1,bn,conv2}
  encoder_{exp,ges}.{time,pid}_embed.{0,2} -> {time,pid}_embed.{fc1,fc2}
  ...temporal_decoder_blocks.N.feat_proj.{0,1,3} -> layer_N.feat_proj.{norm,fc1,fc2}
  ...temporal_decoder_blocks.N.ca_block.*  -> layer_N.ca_block.* (the
        decoder base: norm, text_norm, query, key, value, proj_out)
  ...proj_out.emb_layers.1 / out_layers.2  -> proj_out.emb_proj / out_proj
  everything else                          -> the same name

Layouts: torch Linear (out, in) -> Flax kernel (in, out); Conv1d (out,
in/groups, k) -> (k, in/groups, out); BatchNorm weight/bias -> scale/bias,
running statistics into ``batch_stats``.  The export direction
(:func:`export_unidiffuser_state_dict`) is the exact inverse; like JAX's,
it refuses what has no reference layout (a single branch, text or emotion
encoders).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from diffsheg_tpu_torch.compat.from_jax import export_flax_tree, load_flax_tree
from diffsheg_tpu_torch.config import ModelConfig
from diffsheg_tpu_torch.models.unidiffuser import UniDiffuser


def _t(x) -> np.ndarray:
    """torch tensor / array -> numpy float32."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _linear(sd, prefix) -> Dict[str, np.ndarray]:
    return {"kernel": _t(sd[f"{prefix}.weight"]).T,
            "bias": _t(sd[f"{prefix}.bias"])}


def _layernorm(sd, prefix) -> Dict[str, np.ndarray]:
    return {"scale": _t(sd[f"{prefix}.weight"]),
            "bias": _t(sd[f"{prefix}.bias"])}


def _conv1d(sd, prefix) -> Dict[str, np.ndarray]:
    return {"kernel": _t(sd[f"{prefix}.weight"]).transpose(2, 1, 0)}


def _stylization(sd, prefix) -> Dict[str, Any]:
    return {"emb_proj": _linear(sd, f"{prefix}.emb_layers.1"),
            "norm": _layernorm(sd, f"{prefix}.norm"),
            "out_proj": _linear(sd, f"{prefix}.out_layers.2")}


def _time_mlp(sd, prefix) -> Dict[str, Any]:
    return {"fc1": _linear(sd, f"{prefix}.0"), "fc2": _linear(sd, f"{prefix}.2")}


def _attention(sd, prefix) -> Dict[str, Any]:
    """sa_block / ca_block: norm, q / k / v, proj_out; the cross-attention
    adds text_norm."""
    out = {"norm": _layernorm(sd, f"{prefix}.norm"),
           "query": _linear(sd, f"{prefix}.query"),
           "key": _linear(sd, f"{prefix}.key"),
           "value": _linear(sd, f"{prefix}.value"),
           "proj_out": _stylization(sd, f"{prefix}.proj_out")}
    if f"{prefix}.text_norm.weight" in sd:
        out["text_norm"] = _layernorm(sd, f"{prefix}.text_norm")
    return out


def _layer(sd, prefix) -> Dict[str, Any]:
    out = {
        "sa_block": _attention(sd, f"{prefix}.sa_block"),
        "ffn": {"linear1": _linear(sd, f"{prefix}.ffn.linear1"),
                "linear2": _linear(sd, f"{prefix}.ffn.linear2"),
                "proj_out": _stylization(sd, f"{prefix}.ffn.proj_out")},
    }
    if f"{prefix}.ca_block.norm.weight" in sd:      # transformer_decoder
        out["ca_block"] = _attention(sd, f"{prefix}.ca_block")
    if f"{prefix}.feat_proj.0.weight" in sd:   # LN, Linear, SiLU, Linear
        out["feat_proj"] = {"norm": _layernorm(sd, f"{prefix}.feat_proj.0"),
                            "fc1": _linear(sd, f"{prefix}.feat_proj.1"),
                            "fc2": _linear(sd, f"{prefix}.feat_proj.3")}
    return out


def _branch(sd, prefix, num_layers: int) -> Tuple[Dict, Dict]:
    """(params, batch_stats) of one branch."""
    params: Dict[str, Any] = {
        "joint_embed": _linear(sd, f"{prefix}.joint_embed"),
        "audio_proj": _linear(sd, f"{prefix}.audio_proj"),
        "time_embed": _time_mlp(sd, f"{prefix}.time_embed"),
        "out": _linear(sd, f"{prefix}.out"),
    }
    stats: Dict[str, Any] = {}
    if f"{prefix}.pid_embed.0.weight" in sd:
        params["pid_embed"] = _time_mlp(sd, f"{prefix}.pid_embed")
    he = f"{prefix}.hubert_encoder"
    if f"{he}.0.weight" in sd:           # conv encoder: Conv, BN, GELU, Conv
        params["hubert_encoder"] = {
            "conv1": _conv1d(sd, f"{he}.0"), "conv2": _conv1d(sd, f"{he}.3"),
            "bn": {"scale": _t(sd[f"{he}.1.weight"]),
                   "bias": _t(sd[f"{he}.1.bias"])}}
        stats["hubert_encoder"] = {"bn": {
            "mean": _t(sd[f"{he}.1.running_mean"]),
            "var": _t(sd[f"{he}.1.running_var"])}}
    elif f"{he}.weight" in sd:           # wav2vec2 variant: one Linear
        params["hubert_encoder"] = _linear(sd, he)
    for name in ("null_cond_emb", "sequence_embedding"):
        if f"{prefix}.{name}" in sd:
            params[name] = _t(sd[f"{prefix}.{name}"])
    for i in range(num_layers):
        params[f"layer_{i}"] = _layer(sd, f"{prefix}.temporal_decoder_blocks.{i}")
    return params, stats


def convert_unidiffuser_state_dict(sd: Dict[str, Any], cfg: ModelConfig,
                                   num_layers: int = None) -> Dict[str, Any]:
    """Reference UniDiffuser state dict -> the Flax-named numpy tree
    ``{'params', 'batch_stats'}`` (``module.`` prefixes dropped)."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    num_layers = num_layers or cfg.num_layers
    params: Dict[str, Any] = {"time_embed": _time_mlp(sd, "time_embed"),
                              "encoder_aud": _layer(sd, "encoder_aud")}
    stats: Dict[str, Any] = {}
    for name in ("encoder_exp", "encoder_ges"):
        params[name], s = _branch(sd, name, num_layers)
        if s:
            stats[name] = s
    return {"params": params, "batch_stats": stats}


def load_reference_checkpoint(path: str, cfg: ModelConfig) -> UniDiffuser:
    """A reference ``.tar`` (or a bare state dict) -> the port's
    ``UniDiffuser`` of ``cfg`` with its weights, on the CPU in float32.
    Loaded with ``weights_only`` (tensors and plain containers only)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["encoder"] if "encoder" in ckpt else ckpt
    return load_flax_tree(UniDiffuser(cfg),
                          convert_unidiffuser_state_dict(sd, cfg))


# -- the export direction: the port's modules -> reference state dict ------

def _inv_linear(sd, prefix, p) -> None:
    sd[f"{prefix}.weight"] = p["kernel"].T
    if "bias" in p:
        sd[f"{prefix}.bias"] = p["bias"]


def _inv_layernorm(sd, prefix, p) -> None:
    sd[f"{prefix}.weight"] = p["scale"]
    sd[f"{prefix}.bias"] = p["bias"]


def _inv_stylization(sd, prefix, p) -> None:
    _inv_linear(sd, f"{prefix}.emb_layers.1", p["emb_proj"])
    _inv_layernorm(sd, f"{prefix}.norm", p["norm"])
    _inv_linear(sd, f"{prefix}.out_layers.2", p["out_proj"])


def _inv_time_mlp(sd, prefix, p) -> None:
    _inv_linear(sd, f"{prefix}.0", p["fc1"])
    _inv_linear(sd, f"{prefix}.2", p["fc2"])


def _inv_attention(sd, prefix, p) -> None:
    _inv_layernorm(sd, f"{prefix}.norm", p["norm"])
    if "text_norm" in p:
        _inv_layernorm(sd, f"{prefix}.text_norm", p["text_norm"])
    for name in ("query", "key", "value"):
        _inv_linear(sd, f"{prefix}.{name}", p[name])
    _inv_stylization(sd, f"{prefix}.proj_out", p["proj_out"])


def _inv_layer(sd, prefix, p) -> None:
    _inv_attention(sd, f"{prefix}.sa_block", p["sa_block"])
    if "ca_block" in p:
        _inv_attention(sd, f"{prefix}.ca_block", p["ca_block"])
    ffn = p["ffn"]
    _inv_linear(sd, f"{prefix}.ffn.linear1", ffn["linear1"])
    _inv_linear(sd, f"{prefix}.ffn.linear2", ffn["linear2"])
    _inv_stylization(sd, f"{prefix}.ffn.proj_out", ffn["proj_out"])
    if "feat_proj" in p:
        fp = p["feat_proj"]
        _inv_layernorm(sd, f"{prefix}.feat_proj.0", fp["norm"])
        _inv_linear(sd, f"{prefix}.feat_proj.1", fp["fc1"])
        _inv_linear(sd, f"{prefix}.feat_proj.3", fp["fc2"])


def _inv_branch(sd, prefix, params, stats) -> None:
    _inv_linear(sd, f"{prefix}.joint_embed", params["joint_embed"])
    _inv_linear(sd, f"{prefix}.audio_proj", params["audio_proj"])
    _inv_time_mlp(sd, f"{prefix}.time_embed", params["time_embed"])
    _inv_linear(sd, f"{prefix}.out", params["out"])
    if "pid_embed" in params:
        _inv_time_mlp(sd, f"{prefix}.pid_embed", params["pid_embed"])
    he = params.get("hubert_encoder")
    if he is not None and "conv1" in he:
        p = f"{prefix}.hubert_encoder"
        sd[f"{p}.0.weight"] = he["conv1"]["kernel"].transpose(2, 1, 0)
        sd[f"{p}.3.weight"] = he["conv2"]["kernel"].transpose(2, 1, 0)
        sd[f"{p}.1.weight"] = he["bn"]["scale"]
        sd[f"{p}.1.bias"] = he["bn"]["bias"]
        bn = stats["hubert_encoder"]["bn"]
        sd[f"{p}.1.running_mean"] = bn["mean"]
        sd[f"{p}.1.running_var"] = bn["var"]
    elif he is not None:
        _inv_linear(sd, f"{prefix}.hubert_encoder", he)
    for name in ("null_cond_emb", "sequence_embedding"):
        if name in params:
            sd[f"{prefix}.{name}"] = params[name]
    i = 0
    while f"layer_{i}" in params:
        _inv_layer(sd, f"{prefix}.temporal_decoder_blocks.{i}",
                   params[f"layer_{i}"])
        i += 1


def export_unidiffuser_state_dict(model: UniDiffuser) -> Dict[str, np.ndarray]:
    """The port's ``UniDiffuser`` -> reference state dict (float32 numpy
    values under the reference's module names).  Raises ValueError, as
    JAX's export does, for a model with no reference layout."""
    if not isinstance(model, UniDiffuser):
        raise ValueError(
            "cannot export: only the two-branch UniDiffuser "
            "(model.branch_mode='joint') maps onto the reference checkpoint "
            "layout; single-branch models have no upstream equivalent")
    tree = export_flax_tree(model)
    params, stats = tree["params"], tree["batch_stats"]
    unconvertible = sorted(
        f"{b}.{k}" for b in ("encoder_exp", "encoder_ges")
        for k in ("text_embed", "text_tcn", "emotion_embed", "emotion_tail")
        if k in params[b])
    if unconvertible:
        raise ValueError(
            f"cannot export: {unconvertible} have no reference layout — "
            "the upstream addTextCond/addEmoCond path references modules it "
            "never defines, so these weights would be silently dropped by "
            "a strict=False load")
    sd: Dict[str, np.ndarray] = {}
    _inv_time_mlp(sd, "time_embed", params["time_embed"])
    _inv_layer(sd, "encoder_aud", params["encoder_aud"])
    for name in ("encoder_exp", "encoder_ges"):
        _inv_branch(sd, name, params[name], stats.get(name, {}))
    return sd


def save_reference_checkpoint(model: UniDiffuser, path: str, epoch: int = 0,
                              total_it: int = 0) -> str:
    """Write a reference-format ``.tar`` (``torch.save``) that the upstream
    harness loads with its own checkpoint code."""
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in export_unidiffuser_state_dict(model).items()}
    torch.save({"encoder": sd, "ep": int(epoch), "total_it": int(total_it)},
               path)
    return path


def expected_reference_keys(cfg: ModelConfig, num_layers: int = None
                            ) -> Dict[str, Tuple[int, ...]]:
    """The reference state dict's keys and shapes for a UniDiffuser built
    with ``cfg`` (either ``model_base``, a learned-variance head too)."""
    L = cfg.latent_dim
    E = cfg.time_embed_dim
    A = cfg.audio_dim
    AL = cfg.aud_latent_dim
    num_layers = num_layers or cfg.num_layers
    keys: Dict[str, Tuple[int, ...]] = {}

    def linear(prefix, din, dout):
        keys[f"{prefix}.weight"] = (dout, din)
        keys[f"{prefix}.bias"] = (dout,)

    def ln(prefix, d):
        keys[f"{prefix}.weight"] = (d,)
        keys[f"{prefix}.bias"] = (d,)

    def styl(prefix, d):
        linear(f"{prefix}.emb_layers.1", E, 2 * d)
        ln(f"{prefix}.norm", d)
        linear(f"{prefix}.out_layers.2", d, d)

    def attention(prefix, d, memory=None):
        ln(f"{prefix}.norm", d)
        if memory is not None:
            ln(f"{prefix}.text_norm", memory)
        linear(f"{prefix}.query", d, d)
        for name in ("key", "value"):
            linear(f"{prefix}.{name}", memory or d, d)
        styl(f"{prefix}.proj_out", d)

    decoder = cfg.model_base == "transformer_decoder"

    def layer(prefix, d, pre_proj=None):
        if pre_proj is not None and not decoder:
            ln(f"{prefix}.feat_proj.0", pre_proj)
            linear(f"{prefix}.feat_proj.1", pre_proj, 2 * d)
            linear(f"{prefix}.feat_proj.3", 2 * d, d)
        attention(f"{prefix}.sa_block", d)
        if pre_proj is not None and decoder:
            attention(f"{prefix}.ca_block", d, memory=pre_proj - d)
        linear(f"{prefix}.ffn.linear1", d, cfg.ff_size)
        linear(f"{prefix}.ffn.linear2", cfg.ff_size, d)
        styl(f"{prefix}.ffn.proj_out", d)

    linear("time_embed.0", L, E)
    linear("time_embed.2", E, E)
    layer("encoder_aud", A)
    for p, feats, exp_cond in (("encoder_exp", cfg.expression_dim, 0),
                               ("encoder_ges", cfg.pose_dim,
                                cfg.expression_dim)):
        linear(f"{p}.joint_embed", feats, L)
        linear(f"{p}.audio_proj", 2 * A, AL)
        linear(f"{p}.time_embed.0", L, E)
        linear(f"{p}.time_embed.2", E, E)
        if not (cfg.expr_id_off and p == "encoder_exp"):
            linear(f"{p}.pid_embed.0", cfg.style_dim, E)
            linear(f"{p}.pid_embed.2", E, E)
        H, HL = cfg.hubert_dim, cfg.hubert_latent_dim
        if cfg.add_hubert and cfg.encode_hubert:
            if cfg.speech_encoder == "linear":
                linear(f"{p}.hubert_encoder", H, HL)
            else:
                keys[f"{p}.hubert_encoder.0.weight"] = (HL, H, 3)
                for stat in ("weight", "bias", "running_mean", "running_var"):
                    keys[f"{p}.hubert_encoder.1.{stat}"] = (HL,)
                keys[f"{p}.hubert_encoder.3.weight"] = (HL, HL, 3)
        pre_proj = L + AL + exp_cond
        if cfg.add_hubert:
            pre_proj += HL if cfg.encode_hubert else H
        if cfg.classifier_free:
            keys[f"{p}.null_cond_emb"] = (1, pre_proj)
        for i in range(num_layers):
            layer(f"{p}.temporal_decoder_blocks.{i}", L, pre_proj=pre_proj)
        linear(f"{p}.out", L, feats * (2 if cfg.learned_variance else 1))
    return keys
