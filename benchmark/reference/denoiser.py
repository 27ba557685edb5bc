"""Plain reference of the DiffSHEG joint denoiser (UniDiffuser), float32.

A straightforward module forward with no kernel, no timestep-level cache
and no fused path: the reference's equations as the DiffSHEG repository
states them (``models/unidiffuser.py``, ``models/transformer.py``), with
the parameter names of the program's modules so that one state dict
loads into both.  Linear attention is the two-einsum composition: q
softmaxed over each head's features, k over time, ``ctx = k^T v``,
``y = q ctx``.  Training (``train=True``) uses BatchNorm's batch
statistics and the classifier-free null rows; dropout is 0 in every
configuration of the benchmark.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-5


def timestep_embedding(t, dim, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


@functools.lru_cache(maxsize=None)
def position_table(T, d, period):
    """Interleaved sin/cos table of ``period`` rows, tiled to ``T``."""
    pos = np.arange(period, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-np.log(10000.0) / d))
    tab = np.zeros((period, d))
    tab[:, 0::2] = np.sin(pos * div)
    tab[:, 1::2] = np.cos(pos * div[: tab[:, 1::2].shape[1]])
    return np.tile(tab.astype(np.float32), (T // period + 1, 1))[:T]


def linear_attention(q, k, v, heads):
    B, T, D = q.shape
    hd = D // heads
    q = q.reshape(B, T, heads, hd).softmax(-1)
    k = k.reshape(B, T, heads, hd).softmax(1)
    v = v.reshape(B, T, heads, hd)
    ctx = torch.einsum("bnhd,bnhl->bhdl", k, v)
    return torch.einsum("bnhd,bhdl->bnhl", q, ctx).reshape(B, T, D)


class Mlp2(nn.Module):
    """Dense -> SiLU -> Dense (time and speaker embeddings)."""

    def __init__(self, i, o):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(i, o), nn.Linear(o, o)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))


class Stylization(nn.Module):
    def __init__(self, L, E):
        super().__init__()
        self.emb_proj = nn.Linear(E, 2 * L)
        self.norm = nn.LayerNorm(L, eps=LN_EPS)
        self.out_proj = nn.Linear(L, L)

    def forward(self, h, emb):
        scale, shift = self.emb_proj(F.silu(emb))[:, None].chunk(2, dim=-1)
        return self.out_proj(F.silu(self.norm(h) * (1 + scale) + shift))


class SelfAttention(nn.Module):
    def __init__(self, L, heads, E):
        super().__init__()
        self.heads = heads
        self.norm = nn.LayerNorm(L, eps=LN_EPS)
        self.query, self.key, self.value = (nn.Linear(L, L) for _ in range(3))
        self.proj_out = Stylization(L, E)

    def forward(self, x, emb):
        xn = self.norm(x)
        y = linear_attention(self.query(xn), self.key(xn), self.value(xn),
                             self.heads)
        return x + self.proj_out(y, emb)


class Ffn(nn.Module):
    def __init__(self, L, F_, E):
        super().__init__()
        self.linear1, self.linear2 = nn.Linear(L, F_), nn.Linear(F_, L)
        self.proj_out = Stylization(L, E)

    def forward(self, x, emb):
        y = self.linear2(F.gelu(self.linear1(x)))
        return x + self.proj_out(y, emb)


class CondProjection(nn.Module):
    def __init__(self, C, L):
        super().__init__()
        self.norm = nn.LayerNorm(C, eps=LN_EPS)
        self.fc1, self.fc2 = nn.Linear(C, 2 * L), nn.Linear(2 * L, L)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(self.norm(x))))


class Layer(nn.Module):
    """Concat the condition, project it back to the latent (a residual),
    then linear self-attention and the FFN; without a condition (the
    audio encoder) the input is doubled instead, as in the reference."""

    def __init__(self, L, F_, heads, E, feats=None):
        super().__init__()
        if feats is not None:
            self.feat_proj = CondProjection(feats, L)
        self.sa_block = SelfAttention(L, heads, E)
        self.ffn = Ffn(L, F_, E)

    def forward(self, x, cond, emb, null_mask=None, null_emb=None):
        if cond is None:
            x = x + x
        else:
            feats = torch.cat([x, cond], dim=-1)
            if null_mask is not None:
                feats = torch.where(null_mask[:, None, None],
                                    null_emb[:, None].expand_as(feats), feats)
            x = self.feat_proj(feats) + x
        return self.ffn(self.sa_block(x, emb), emb)


class BatchNorm(nn.Module):
    def __init__(self, n, eps=1e-5, momentum=0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x, train):
        if not train:
            return ((x - self.running_mean)
                    * torch.rsqrt(self.running_var + self.eps)
                    * self.weight + self.bias)
        dims = tuple(range(x.ndim - 1))
        mean = x.mean(dims)
        var = x.var(dims, unbiased=False)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_((1 - m) * mean)
            self.running_var.mul_(m).add_((1 - m) * var)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class HubertConvEncoder(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.conv1 = nn.Conv1d(i, o, 3, padding=1, bias=False)
        self.bn = BatchNorm(o)
        self.conv2 = nn.Conv1d(o, o, 3, padding=1, bias=False)

    def forward(self, x, train):
        h = self.conv1(x.transpose(1, 2)).transpose(1, 2)
        h = F.gelu(self.bn(h, train))
        return self.conv2(h.transpose(1, 2)).transpose(1, 2)


class Branch(nn.Module):
    """One branch (expression, or gesture conditioned on the expression x0
    estimate)."""

    def __init__(self, m, n_out, feats, audio_in):
        super().__init__()
        L, E = m["latent_dim"], 4 * m["latent_dim"]
        self.m, self.n_layers = m, m["num_layers"]
        self.time_embed = Mlp2(L, E)
        self.pid_embed = Mlp2(m["style_dim"], E)
        self.hubert_encoder = HubertConvEncoder(m["hubert_dim"],
                                                m["hubert_latent_dim"])
        self.audio_proj = nn.Linear(audio_in, m["aud_latent_dim"])
        self.joint_embed = nn.Linear(n_out, L)
        for i in range(self.n_layers):
            self.add_module(f"layer_{i}", Layer(L, m["ff_size"],
                                                m["num_heads"], E, feats))
        self.out = nn.Linear(L, n_out)
        if m["classifier_free"]:
            self.null_cond_emb = nn.Parameter(torch.zeros(1, feats))

    def forward(self, x, t, audio, pid, hubert, exp_cond=None, cfg=False,
                train=False, remat=False):
        m = self.m
        B, T, _ = x.shape
        cond = [self.audio_proj(audio), self.hubert_encoder(hubert, train)]
        if exp_cond is not None:
            cond.append(exp_cond)
        cond = torch.cat(cond, dim=-1)
        guided = cfg and m["classifier_free"] and m["cond_scale"] != 1.0
        null_mask = None
        if m["classifier_free"] and train:
            # a deterministic first fraction of the batch is unconditional
            frac = np.arange(B, dtype=np.float32) / np.float32(max(B - 1, 1))
            null_mask = torch.from_numpy(frac < m["null_cond_prob"]).to(x.device)
        if guided:   # one unconditional and one conditional row each
            x, t, pid, cond = (torch.cat([a, a]) for a in (x, t, pid, cond))
            null_mask = torch.arange(2 * B, device=x.device) < B
        emb = (self.time_embed(timestep_embedding(t, m["latent_dim"]))
               + self.pid_embed(pid))
        h = self.joint_embed(x) + torch.from_numpy(position_table(
            T, m["latent_dim"], m["max_seq_len"])).to(x.device)
        null_emb = getattr(self, "null_cond_emb", None)
        for i in range(self.n_layers):
            layer = getattr(self, f"layer_{i}")
            args = (h, cond, emb, null_mask, null_emb)
            h = (checkpoint(layer, *args, use_reentrant=False) if remat
                 else layer(*args))
        out = self.out(h)
        if guided:
            out = out[:B] + m["cond_scale"] * (out[B:] - out[:B])
        return out


class UniDiffuser(nn.Module):
    """Expression branch, the x0 bridge, then the gesture branch; the
    output is (gesture ++ expression) epsilon.  ``m`` is the ``model``
    group of a configuration file."""

    def __init__(self, m):
        super().__init__()
        L = m["latent_dim"]
        self.m = m
        self.time_embed = Mlp2(L, 4 * L)
        self.encoder_aud = Layer(m["audio_dim"], m["ff_size"], m["num_heads"],
                                 4 * L)
        base = L + m["aud_latent_dim"] + m["hubert_latent_dim"]
        self.encoder_exp = Branch(m, m["expression_dim"], base,
                                  2 * m["audio_dim"])
        self.encoder_ges = Branch(m, m["pose_dim"], base + m["expression_dim"],
                                  2 * m["audio_dim"])

    def forward(self, x, t, sqrt_alphas, mel, pid, hubert, cfg=False,
                train=False, remat=False):
        emb = self.time_embed(timestep_embedding(t, self.m["latent_dim"]))
        audio = torch.cat([mel, self.encoder_aud(mel, None, emb)], dim=-1)
        P = self.m["pose_dim"]
        ges, expr = x[..., :P], x[..., P:]
        exp_eps = self.encoder_exp(expr, t, audio, pid, hubert, cfg=cfg,
                                   train=train, remat=remat)
        sr, srm1 = sqrt_alphas
        x0 = (sr * expr - srm1 * exp_eps).detach()
        ges_eps = self.encoder_ges(ges, t, audio, pid, hubert, exp_cond=x0,
                                   cfg=cfg, train=train, remat=remat)
        return torch.cat([ges_eps, exp_eps], dim=-1)
