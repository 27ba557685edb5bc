"""Plain reference of the speech frontend, float32: the mel spectrogram
(librosa 0.9.2's numerics: n_fft 2048, periodic Hann, centred frames
with reflect padding, power 2, Slaney mel filters, the last frame
dropped) and HuBERT-large (hubert-large-ls960-ft's layout: a 7-layer conv
feature extractor with per-layer LayerNorm, LN + projection, a grouped
positional conv, 24 pre-LN layers, a final LayerNorm) run over long audio
in chunks of 320,080 samples, the frames stitched, cut to
``(N - 80) // 320`` and resampled linearly to the motion frame rate.
Parameter names are the program's, so one state dict loads into both.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

LN_EPS = 1e-5
KERNEL, STRIDE, CLIP_FRAMES = 400, 320, 1000
CLIP = STRIDE * CLIP_FRAMES
CHUNK = CLIP - STRIDE + KERNEL


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_hz = 200.0 / 3, 1000.0
    step = np.log(6.4) / 27.0
    return np.where(f >= min_hz,
                    min_hz / f_sp + np.log(np.maximum(f, min_hz) / min_hz) / step,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_hz = 200.0 / 3, 1000.0
    step = np.log(6.4) / 27.0
    return np.where(m >= min_hz / f_sp,
                    min_hz * np.exp(step * (m - min_hz / f_sp)), f_sp * m)


def mel_filters(sr, n_fft, n_mels):
    """(n_mels, 1 + n_fft // 2) Slaney-normalised triangles up to sr / 2."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    lo, hi = _hz_to_mel(np.array([0.0, sr / 2.0]))
    pts = _mel_to_hz(np.linspace(lo, hi, n_mels + 2))
    ramps = pts[:, None] - freqs[None]
    diff = np.diff(pts)
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / diff[:-1, None],
                                   ramps[2:] / diff[1:, None]))
    return w * (2.0 / (pts[2:] - pts[:-2]))[:, None]


def mel_spectrogram(y, sr, hop, n_mels, n_fft=2048):
    """y (1, N) -> (1, N // hop, n_mels)."""
    win = torch.from_numpy(0.5 - 0.5 * np.cos(
        2 * np.pi * np.arange(n_fft) / n_fft)).float().to(y.device)
    yp = F.pad(y[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = yp.unfold(-1, n_fft, hop) * win
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1).abs() ** 2
    fb = torch.from_numpy(mel_filters(sr, n_fft, n_mels).T).float().to(y.device)
    return (spec @ fb)[:, :-1]


class HubertAttention(nn.Module):
    def __init__(self, H, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(H, H) for _ in range(4))

    def forward(self, x, mask):
        B, T, H = x.shape
        nh, hd = self.heads, H // self.heads
        q = self.q_proj(x).reshape(B, T, nh, hd).transpose(1, 2)
        k = self.k_proj(x).reshape(B, T, nh, hd).transpose(1, 2)
        v = self.v_proj(x).reshape(B, T, nh, hd).transpose(1, 2)
        logits = (q @ k.transpose(-1, -2)) * hd ** -0.5
        logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
        y = (logits.softmax(-1) @ v).transpose(1, 2).reshape(B, T, H)
        return self.out_proj(y)


class HubertLayer(nn.Module):
    def __init__(self, c):
        super().__init__()
        H = c["hidden_size"]
        self.attn = HubertAttention(H, c["num_heads"])
        self.attn_ln = nn.LayerNorm(H, eps=LN_EPS)
        self.ffn_ln = nn.LayerNorm(H, eps=LN_EPS)
        self.fc1 = nn.Linear(H, c["intermediate_size"])
        self.fc2 = nn.Linear(c["intermediate_size"], H)

    def forward(self, x, mask):
        x = x + self.attn(self.attn_ln(x), mask)
        return x + self.fc2(F.gelu(self.fc1(self.ffn_ln(x))))


class ConvExtractor(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.n = len(c["conv_dim"])
        c_in = 1
        for i, (o, k, s) in enumerate(zip(c["conv_dim"], c["conv_kernel"],
                                          c["conv_stride"])):
            self.add_module(f"conv_{i}", nn.Conv1d(c_in, o, k, stride=s))
            self.add_module(f"ln_{i}", nn.LayerNorm(o, eps=LN_EPS))
            c_in = o

    def forward(self, x):
        h = x[:, None]
        for i in range(self.n):
            h = getattr(self, f"conv_{i}")(h)
            h = getattr(self, f"ln_{i}")(h.transpose(1, 2)).transpose(1, 2)
            h = F.gelu(h)
        return h.transpose(1, 2)


class PosConv(nn.Module):
    def __init__(self, c):
        super().__init__()
        k = c["num_conv_pos_embeddings"]
        self.conv = nn.Conv1d(c["hidden_size"], c["hidden_size"], k,
                              padding=k // 2,
                              groups=c["num_conv_pos_embedding_groups"])
        self.trim = k % 2 == 0

    def forward(self, x):
        h = self.conv(x.transpose(1, 2)).transpose(1, 2)
        return F.gelu(h[:, :-1] if self.trim else h)


class Hubert(nn.Module):
    """``c`` is the ``hubert`` group of a configuration file (pre-LN)."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        self.feature_extractor = ConvExtractor(c)
        self.feat_proj_ln = nn.LayerNorm(c["conv_dim"][-1], eps=LN_EPS)
        self.feat_proj = nn.Linear(c["conv_dim"][-1], c["hidden_size"])
        self.pos_conv = PosConv(c)
        for i in range(c["num_layers"]):
            self.add_module(f"layer_{i}", HubertLayer(c))
        self.final_ln = nn.LayerNorm(c["hidden_size"], eps=LN_EPS)

    def forward(self, x, mask):
        h = self.feat_proj(self.feat_proj_ln(self.feature_extractor(x)))
        h = h * mask[..., None]
        h = h + self.pos_conv(h)
        for i in range(self.c["num_layers"]):
            h = getattr(self, f"layer_{i}")(h, mask)
        return self.final_ln(h)


def hubert_features(model, audio, target_frames):
    """audio (1, N) at 16 kHz -> (1, target_frames, hidden)."""
    n = audio.shape[1]
    want = (n - (KERNEL - STRIDE)) // STRIDE
    spans = [(CLIP * i, min(CHUNK, n - CLIP * i)) for i in range(n // CLIP)]
    if n - CLIP * (n // CLIP) >= KERNEL:
        spans.append((CLIP * (n // CLIP), n - CLIP * (n // CLIP)))
    a = audio - audio.mean(-1, keepdim=True)
    a = a / torch.sqrt(a.pow(2).mean(-1, keepdim=True) + 1e-7)
    batch = torch.cat([F.pad(a[:, s:s + m], (0, CHUNK - m)) for s, m in spans])
    valid = [(m - KERNEL) // STRIDE + 1 for _, m in spans]
    full = (CHUNK - KERNEL) // STRIDE + 1
    mask = torch.arange(full, device=a.device)[None] < torch.tensor(
        valid, device=a.device)[:, None]
    feats = model(batch, mask)
    seq = torch.cat([feats[i, :v] for i, v in enumerate(valid)])[None]
    seq = F.pad(seq, (0, 0, 0, max(want - seq.shape[1], 0)))[:, :want]
    T = seq.shape[1]
    pos = torch.linspace(0.0, T - 1.0, target_frames, device=a.device)
    lo = pos.floor().long()
    hi = (lo + 1).clamp(max=T - 1)
    w = (pos - lo)[None, :, None]
    return seq[:, lo] * (1 - w) + seq[:, hi] * w
