"""Fused serving forward for the sampler ("fast path").

Counterpart of ``diffsheg_tpu/models/fast_forward.py``.  With the
timestep-level cache supplying every x-independent tensor, a denoiser
call is: joint embed + PE, the transformer layers, the output head and
the x0 bridge between the branches.  The layers run in the fused-layer
kernels (``ops/fused_layer.py``): one launch per layer
(``chain=False``, the per-layer kernel) or one per branch
(``chain=True``, the branch kernel).  Covers classifier-free batch
doubling with null-condition substitution, and weight-only int8 / int4
transformer stacks (``diffusion.quantize``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.nn import functional as F

from diffsheg_tpu_torch.config import ModelConfig
from diffsheg_tpu_torch.models.embeddings import positional_encoding
from diffsheg_tpu_torch.models.level_cache import (BranchCache, ModelCache,
                                                   supports_level_cache)
from diffsheg_tpu_torch.models.unidiffuser import (UniDiffuser,
                                                   branch_feats_dim)
from diffsheg_tpu_torch.ops.fused_layer import (LayerParams, LayerScales,
                                                extract_layer_params,
                                                fused_branch, fused_layer,
                                                layer_at,
                                                quantize_layer_params,
                                                stack_layer_params)

QUANT_BITS = {"int8": 8, "int4": 4}


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def supports_fast_forward(cfg: ModelConfig) -> bool:
    """The level cache's configurations (the cache supplies its inputs)."""
    return supports_level_cache(cfg)


class BranchFast(NamedTuple):
    """One branch's kernel-ready weights."""

    joint_k: torch.Tensor                 # (in, L)
    joint_b: torch.Tensor
    out_k: torch.Tensor                   # (L, out)
    out_b: torch.Tensor
    pe: torch.Tensor                      # (T, L)
    layers: LayerParams                   # stacked over layers
    null_cond_emb: Optional[torch.Tensor]  # (1, c_real)
    scales: Optional[LayerScales] = None  # quantized matrices' scales


class FastParams(NamedTuple):
    exp: BranchFast
    ges: BranchFast


@torch.no_grad()
def _extract_branch(cfg: ModelConfig, branch, T: int, c_real: int,
                    c_pad: int, dtype, quant: str = "none") -> BranchFast:
    dev = branch.joint_embed.weight.device
    if cfg.pe_type == "learnable":
        pe = branch.sequence_embedding[:T]
    else:
        pe = torch.from_numpy(positional_encoding(
            "ppe_sinu" if cfg.pe_type == "ppe_sinu_dropout" else cfg.pe_type,
            T, cfg.latent_dim, cfg.max_seq_len))
    layers = stack_layer_params([
        extract_layer_params(layer, c_real, c_pad, dtype)
        for layer in branch.layers])
    scales = None
    if quant != "none":
        # the nine matrices as int8 / packed int4 codes with f32 scales,
        # quantized in f32 from the model's weights (the JAX package's f32
        # copies of them: the generator has already cast the model to the
        # compute dtype, as the JAX generator casts its variables); the
        # small tensors (joint, out, pe, norms, biases) stay in ``dtype``
        layers, scales = quantize_layer_params(layers, QUANT_BITS[quant])
    return BranchFast(
        joint_k=branch.joint_embed.weight.t().to(dtype).contiguous(),
        joint_b=branch.joint_embed.bias.to(dtype),
        out_k=branch.out.weight.t().to(dtype).contiguous(),
        out_b=branch.out.bias.to(dtype),
        pe=pe.to(device=dev, dtype=dtype),
        layers=layers,
        null_cond_emb=(branch.null_cond_emb.detach().to(dtype)
                       if hasattr(branch, "null_cond_emb") else None),
        scales=scales,
    )


def extract_fast_params(cfg: ModelConfig, model: UniDiffuser, T: int,
                        quant: str = "none") -> FastParams:
    """Model -> kernel-ready weights for both branches (cast to the compute
    dtype, feats axis padded to a multiple of 128; ``quant`` 'int8' /
    'int4': the transformer stacks' matrices quantized).  Call once per
    stream."""
    if quant != "none" and quant not in QUANT_BITS:
        raise ValueError(f"quant={quant!r}: valid values are 'none', "
                         "'int8', 'int4'")
    dtype = model.time_embed.fc1.weight.dtype
    ce = branch_feats_dim(cfg, 0)
    cg = branch_feats_dim(cfg, cfg.expression_dim)
    return FastParams(
        exp=_extract_branch(cfg, model.encoder_exp, T, ce, _round128(ce),
                            dtype, quant),
        ges=_extract_branch(cfg, model.encoder_ges, T, cg, _round128(cg),
                            dtype, quant))


def _branch_forward(cfg: ModelConfig, bp: BranchFast, x: torch.Tensor,
                    cache: BranchCache, exp_cond: Optional[torch.Tensor],
                    cfg_inference: bool, chain: bool = False) -> torch.Tensor:
    """One branch on the cache path; returns the f32 epsilon."""
    compute = bp.joint_k.dtype
    B = x.shape[0]
    cond_parts = [cache.audio_lat]
    if cache.hubert_lat is not None:
        cond_parts.append(cache.hubert_lat)
    if exp_cond is not None:
        cond_parts.append(exp_cond.to(compute))
    cond = torch.cat(cond_parts, dim=-1)
    mods = cache.mods                                    # (n, 2, B, 2L)

    null_mask = null_emb = None
    do_cfg = cfg_inference and cfg.classifier_free and cfg.cond_scale != 1.0
    c_real = cond.shape[-1] + cfg.latent_dim
    c_pad = _round128(c_real)
    if do_cfg:
        x = torch.cat([x, x])
        cond = torch.cat([cond, cond])
        mods = torch.cat([mods, mods], dim=2)
        # first half unconditional
        null_mask = (torch.linspace(0.0, 1.0, 2 * B, device=x.device)
                     < 0.5).to(compute)
        null_emb = F.pad(bp.null_cond_emb.to(compute), (0, c_pad - c_real))

    h = torch.matmul(x.to(compute), bp.joint_k) + bp.joint_b
    h = h + bp.pe[None]

    if chain:
        cond_pad = F.pad(cond, (0, c_pad - c_real)).contiguous()
        h = fused_branch(h.to(compute).contiguous(), cond_pad,
                         mods.contiguous(), bp.layers, cfg.num_heads, c_real,
                         null_emb=null_emb, null_mask=null_mask,
                         ssc=bp.scales)
    else:
        null_rows = None if null_mask is None else null_mask[:, None, None] > 0
        for i in range(bp.layers.fp_fc1_k.shape[0]):
            feats = torch.cat([h.to(compute), cond], dim=-1)
            if null_rows is not None:
                null = null_emb[:, None, :c_real].to(feats.dtype).expand_as(feats)
                feats = torch.where(null_rows, null, feats)
            if c_pad != c_real:
                feats = F.pad(feats, (0, c_pad - c_real))
            h = fused_layer(h.to(compute).contiguous(), feats.contiguous(),
                            mods[i, 0].contiguous(), mods[i, 1].contiguous(),
                            layer_at(bp.layers, i), cfg.num_heads, c_real,
                            sc=None if bp.scales is None
                            else layer_at(bp.scales, i))

    out = (torch.matmul(h.to(compute), bp.out_k) + bp.out_b).float()
    if do_cfg:
        uncond, cond_out = out[:B], out[B:]
        out = uncond + cfg.cond_scale * (cond_out - uncond)
    return out


@torch.no_grad()
def fast_unidiffuser_step(cfg: ModelConfig, fp: FastParams, x: torch.Tensor,
                          sqrt_alphas: Tuple[float, float], cache: ModelCache,
                          cfg_inference: bool = False,
                          chain: bool = False) -> torch.Tensor:
    """Expression branch -> x0 bridge -> gesture branch; returns the
    (gesture ++ expression) epsilon, f32."""
    gesture, expression = x[..., :cfg.pose_dim], x[..., cfg.pose_dim:]
    exp_eps = _branch_forward(cfg, fp.exp, expression, cache.exp, None,
                              cfg_inference, chain)
    sr, srm1 = sqrt_alphas
    expr_x0 = sr * expression - srm1 * exp_eps           # x0 bridge
    ges_eps = _branch_forward(cfg, fp.ges, gesture, cache.ges, expr_x0,
                              cfg_inference, chain)
    return torch.cat([ges_eps, exp_eps], dim=-1)
