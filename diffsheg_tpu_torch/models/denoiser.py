"""Per-branch denoiser modules (expression or gesture).

Counterpart of ``diffsheg_tpu/models/denoiser.py``: ``TimeEmbedMLP``,
``HubertConvEncoder`` and the branch ``MotionDenoiser``, whose module
forward runs uncached or fed by one level of the timestep-level cache
(``models/level_cache.py``), and in training (``train=True``: BatchNorm
on batch statistics, dropout, the classifier-free null rows, and with
``remat`` each transformer layer recomputed in the backward pass).  A branch may add text and emotion labels to
its condition, cross-attend to it (``model_base='transformer_decoder'``)
and emit a 2C learned-variance output.  The sampler's fast path
(``models/fast_forward.py``) runs the same weights through the fused
kernels instead.  Attribute names follow the Flax parameter tree
(``layer_0`` ...); a ``scan_layers`` tree loads into the same modules.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from diffsheg_tpu_torch.models.blocks import (DiffusionTransformerLayer,
                                              GlobalBatch, Train, batch_rows,
                                              dropout, gelu_exact)
from diffsheg_tpu_torch.models.embeddings import (positional_encoding,
                                                  timestep_embedding)


class BranchCache(NamedTuple):
    """Per-branch conditioning of the timestep-level cache.  Leveled (as
    built): ``mods`` and ``audio_lat`` carry a leading level axis;
    ``level_cache.gather_level`` drops it."""

    mods: torch.Tensor                   # (Lv, num_layers, 2, B, 2*latent)
    audio_lat: torch.Tensor              # (Lv, B, T, aud_latent)
    hubert_lat: Optional[torch.Tensor]   # (B, T, hubert_latent)


def null_rows(batch: int, prob: float) -> torch.Tensor:
    """The training null-condition rows, ``linspace(0, 1, batch) < prob``
    in f32 as JAX computes it: entry i < batch - 1 is i * f32(1 / (batch
    - 1)) (a product with the reciprocal, which rounds some entries one
    ulp off i / (batch - 1)), the last entry exactly 1.  A deterministic
    first fraction of the batch, not a Bernoulli draw."""
    recip = np.float32(1.0) / np.float32(max(batch - 1, 1))
    pos = np.arange(batch, dtype=np.float32) * recip
    pos[-1] = 1.0 if batch > 1 else 0.0
    return torch.from_numpy(pos < np.float32(prob))


def remat(layer: nn.Module, args: tuple) -> torch.Tensor:
    """``layer(*args)``, its activations recomputed in the backward pass
    instead of kept (dropout draws replayed).  The layer's parameters are
    bound now, so the recompute uses the same tensors even when they were
    swapped in by a ``functional_call`` (the bf16 training copies) that
    has returned by then."""
    params = dict(layer.named_parameters())
    return checkpoint(lambda *a: functional_call(layer, params, a), *args,
                      use_reentrant=False)


class TimeEmbedMLP(nn.Module):
    """Dense -> SiLU -> Dense."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, out_dim)
        self.fc2 = nn.Linear(out_dim, out_dim)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis, as Flax's
    ``BatchNorm(momentum=0.9)``.  Inference: ``(x - mean) * rsqrt(var +
    eps) * weight + bias`` on the running statistics.  Training: the same
    on the batch's statistics over every other axis, in f32, the variance
    the biased E[x^2] - E[x]^2; the running statistics move by
    ``momentum * running + (1 - momentum) * batch`` with that same biased
    variance (``nn.BatchNorm1d`` would store the unbiased one), in place,
    once per forward (the module sits outside the recomputed layers).
    Trained across processes, the statistics are the global batch's, as
    JAX computes them over a batch sharded across devices; one process
    keeps the local computation."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, train: Train = False):
        if not train:
            return ((x - self.running_mean)
                    * torch.rsqrt(self.running_var + self.eps)
                    * self.weight + self.bias)
        xf = x.float()
        axes = tuple(range(x.ndim - 1))
        mean = xf.mean(axes)
        meansq = (xf * xf).mean(axes)
        if isinstance(train, GlobalBatch) and train.processes > 1:
            # training across processes: the global batch's statistics
            # (each process holds an equal share of it), differentiable
            stats = (train.sum_across(torch.stack([mean, meansq]))
                     / train.processes)
            mean, meansq = stats[0], stats[1]
        var = torch.clamp(meansq - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean
                                    + (1.0 - m) * mean.detach())
            self.running_var.copy_(m * self.running_var
                                   + (1.0 - m) * var.detach())
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.float())
        return (y + self.bias.float()).to(x.dtype)


class HubertConvEncoder(nn.Module):
    """HuBERT features -> ``out_dim``: Conv(k3) + BN + GELU + Conv(k3),
    channel-last in and out."""

    def __init__(self, in_dim: int, out_dim: int = 128):
        super().__init__()
        self.conv1 = nn.Conv1d(in_dim, out_dim, 3, padding=1, bias=False)
        self.bn = BatchNorm(out_dim)
        self.conv2 = nn.Conv1d(out_dim, out_dim, 3, padding=1, bias=False)

    def forward(self, x, train: Train = False):    # (B, T, C)
        h = self.conv1(x.transpose(1, 2)).transpose(1, 2)
        h = gelu_exact(self.bn(h, train))
        return self.conv2(h.transpose(1, 2)).transpose(1, 2)


class MotionDenoiser(nn.Module):
    """One branch's parameters: time (+speaker) embedding, speech-feature
    encoder, text and emotion encoders, audio projection, joint embedding,
    ``num_layers`` transformer layers, output head (2 x ``input_feats``
    channels with ``learned_variance``), and the classifier-free null
    condition.

    ``feats_dim`` is the per-layer concat width: latent + audio latent
    (+ encoded HuBERT) (+ ``word_f`` with ``text``) (+ ``emotion_f`` with
    ``emotion``) (+ expression condition on the gesture branch).
    ``dropout`` is the blocks' dropout probability, ``null_cond_prob`` the
    share of classifier-free null rows in training, ``remat`` recomputes
    each transformer layer in the backward pass.
    """

    def __init__(self, input_feats: int, feats_dim: int, *, latent_dim: int,
                 ff_size: int, num_layers: int, num_heads: int,
                 style_dim: int, audio_dim: int, aud_latent_dim: int,
                 hubert_dim: int, hubert_latent_dim: int, speech_mode: str,
                 use_pid_embed: bool, classifier_free: bool, pe_type: str,
                 cond_scale: float = 1.0, max_seq_len: int = 600,
                 max_frames: int = 240,
                 model_base: str = "transformer_encoder",
                 learned_variance: bool = False, text: bool = False,
                 emotion: bool = False, word_f: int = 128,
                 emotion_f: int = 8, word_vocab: int = 2048,
                 num_emotions: int = 8, dropout: float = 0.0,
                 null_cond_prob: float = 0.2, remat: bool = False):
        super().__init__()
        E = 4 * latent_dim
        self.num_layers = num_layers
        self.latent_dim = latent_dim
        self.input_feats = input_feats
        self.pe_type = pe_type
        self.max_seq_len = max_seq_len
        self.classifier_free = classifier_free
        self.cond_scale = cond_scale
        self.learned_variance = learned_variance
        self.null_cond_prob = null_cond_prob
        self.remat = remat
        self._pe_cache = {}
        self.time_embed = TimeEmbedMLP(latent_dim, E)
        if use_pid_embed:
            self.pid_embed = TimeEmbedMLP(style_dim, E)
        if speech_mode == "conv":
            self.hubert_encoder = HubertConvEncoder(hubert_dim, hubert_latent_dim)
        elif speech_mode == "linear":
            self.hubert_encoder = nn.Linear(hubert_dim, hubert_latent_dim)
        if text:      # Embed (labels clamped at 0) -> k3 SAME conv
            self.text_embed = nn.Embedding(word_vocab, word_f)
            self.text_tcn = nn.Conv1d(word_f, word_f, 3, padding=1)
        if emotion:
            self.emotion_embed = nn.Embedding(num_emotions, emotion_f)
            self.emotion_tail = nn.Conv1d(emotion_f, emotion_f, 3, padding=1)
        self.audio_proj = nn.Linear(audio_dim, aud_latent_dim)
        self.joint_embed = nn.Linear(input_feats, latent_dim)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DiffusionTransformerLayer(
                latent_dim, ff_size, num_heads, E, feats_dim, model_base,
                dropout))
        self.out = nn.Linear(latent_dim,
                             input_feats * (2 if learned_variance else 1))
        if classifier_free:
            self.null_cond_emb = nn.Parameter(torch.zeros(1, feats_dim))
        if pe_type == "learnable":
            self.sequence_embedding = nn.Parameter(
                torch.zeros(max_frames, latent_dim))

    @property
    def layers(self) -> List[DiffusionTransformerLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def _pe_table(self, T: int, device, dtype) -> torch.Tensor:
        """The (T, latent) sinusoidal table on ``device``, built on the host
        once per (T, device, dtype): a constant of the call, as in the JAX
        trace (building it every call cost ~5 ms of host time)."""
        key = (T, device, dtype)
        if key not in self._pe_cache:
            self._pe_cache[key] = torch.from_numpy(positional_encoding(
                self.pe_type, T, self.latent_dim, self.max_seq_len)).to(
                    device=device, dtype=dtype)
        return self._pe_cache[key]

    @staticmethod
    def _labels(embed, conv, labels, dtype):
        """(B, T) int labels -> embedded, then the k3 SAME conv."""
        e = embed(labels.clamp(min=0).long()).to(dtype)
        return conv(e.transpose(1, 2)).transpose(1, 2)

    def forward(self, x, t, audio, person_id, hubert=None, exp_cond=None,
                word=None, emo=None, src_mask=None,
                cfg_inference: bool = False,
                cache: Optional[BranchCache] = None,
                train: Train = False) -> torch.Tensor:
        """The branch's module forward (JAX ``MotionDenoiser.__call__``):
        x (B, T, input_feats) noisy channels, t (B,)
        original-process timesteps, audio (B, T, audio_dim) the audio
        features (unused with ``cache``), person_id (B, style), hubert (B,
        T, hubert_dim) or None, exp_cond (B, T, E) or None, word / emo (B,
        T) int labels or None, src_mask (B, T, 1) or None for all frames
        valid.  ``cache`` (one level of the timestep-level cache) supplies
        the audio latent, the encoded HuBERT features and every
        stylization modulation.  Returns the f32 output, classifier-free
        guided when ``cfg_inference`` (with a learned-variance head, the
        mean half only; the variance half is the conditional pass's).
        ``train``: the training forward (see the module docstring)."""
        B, T, _ = x.shape
        compute = self.joint_embed.weight.dtype

        # concat order: HuBERT features, text, emotion, then the expression
        # condition
        cond_parts = []
        if cache is not None:
            if cache.hubert_lat is not None:
                cond_parts.append(cache.hubert_lat)
        elif hubert is not None:
            h = hubert.to(compute)
            enc = getattr(self, "hubert_encoder", None)
            if isinstance(enc, HubertConvEncoder):
                h = enc(h, train)
            elif enc is not None:
                h = enc(h)
            cond_parts.append(h)
        if word is not None:
            cond_parts.append(self._labels(self.text_embed, self.text_tcn,
                                           word, compute))
        if emo is not None:
            cond_parts.append(self._labels(self.emotion_embed,
                                           self.emotion_tail, emo, compute))
        if exp_cond is not None:
            cond_parts.append(exp_cond.to(compute))

        do_cfg = (cfg_inference and self.classifier_free
                  and self.cond_scale != 1.0)
        null_cond_mask = None
        if self.classifier_free and train:
            # this process's rows of the global batch's null rows
            first, total = batch_rows(train, B)
            null_cond_mask = null_rows(total, self.null_cond_prob)[
                first:first + B].to(x.device)
        if do_cfg:
            x, t = torch.cat([x, x]), torch.cat([t, t])
            if cache is None:
                audio = torch.cat([audio, audio])
            person_id = torch.cat([person_id, person_id])
            if src_mask is not None:
                src_mask = torch.cat([src_mask, src_mask])
            cond_parts = [torch.cat([c, c]) for c in cond_parts]
            # first half unconditional
            null_cond_mask = torch.linspace(0.0, 1.0, 2 * B,
                                            device=x.device) < 0.5

        emb = None   # with the cache every modulation comes precomputed
        if cache is None:
            emb = self.time_embed(
                timestep_embedding(t, self.latent_dim).to(compute))
            if hasattr(self, "pid_embed"):
                emb = emb + self.pid_embed(person_id.to(compute))

        h = self.joint_embed(x.to(compute))
        if self.pe_type == "learnable":
            h = h + self.sequence_embedding[None, :T].to(compute)
        else:
            h = h + self._pe_table(T, h.device, compute)[None]
            if self.pe_type == "ppe_sinu_dropout":
                # the reference PPE's own dropout, 0.1 whatever ``dropout``
                h = dropout(h, 0.1, train)

        mods = None
        if cache is not None:
            audio_lat, mods = cache.audio_lat, cache.mods
            if do_cfg:
                audio_lat = torch.cat([audio_lat, audio_lat])
                mods = torch.cat([mods, mods], dim=2)          # batch axis
        else:
            audio_lat = self.audio_proj(audio.to(compute))
        cond = torch.cat([audio_lat] + cond_parts, dim=-1)

        null_emb = getattr(self, "null_cond_emb", None)
        for i, layer in enumerate(self.layers):
            args = (h, cond, emb, src_mask, null_cond_mask, null_emb,
                    None if mods is None else mods[i], train)
            h = remat(layer, args) if self.remat and train else layer(*args)
        out = self.out(h).float()
        if do_cfg:
            uncond, cond_out = out[:B], out[B:]
            if self.learned_variance:
                n = self.input_feats
                mean = uncond[..., :n] + self.cond_scale * (
                    cond_out[..., :n] - uncond[..., :n])
                out = torch.cat([mean, cond_out[..., n:]], dim=-1)
            else:
                out = uncond + self.cond_scale * (cond_out - uncond)
        return out
