"""Plain reference of the speech frontend with WavLM-Large, float32.

WavLM-Large (Chen et al., arXiv:2110.13900; microsoft/wavlm-large's
config.json; HuggingFace's ``WavLMAttention``): a 7-layer conv feature
extractor without conv biases, each conv followed by a LayerNorm over its
channels and a GELU; LN + projection to 1024; a grouped positional conv
(128 wide, 16 groups, one frame trimmed); 24 pre-LN layers of 16 heads
and FFN 4096; a final LayerNorm.  Its attention adds to each logit
``q.k / sqrt(64)`` a relative-position bias ``gate * B[h, i, j]``:

- ``B`` is layer 0's embedding of 320 buckets x 16 heads at the bucket of
  r = j - i (:func:`bucket`), made once a forward and used by every layer;
- ``gate`` (per window, head and query) comes from the layer's own
  attention input x (after its LayerNorm) cut into heads of 64: the 8
  outputs of ``x_h W + b`` summed in two groups of four, through a
  sigmoid, give (a, b) and ``gate = a * (b * c_h - 1) + 2``, ``c_h`` the
  layer's per-head constant.

The frontend of a training step (a BEAT window of S samples of 16 kHz
speech, int16 on the way): the audio resampled to 18 kHz and its mel
spectrogram (``speech.py::mel_spectrogram``), T frames; the audio
normalised to zero mean and unit variance, encoded, cut or padded to
``(S - 80) // 320`` frames and resampled linearly to T.  Windows are
encoded in plain blocks of :data:`BLOCK` only so that they fit; each is
encoded on its own.  Parameter names are the program's, so one state
dict loads into both.

Departures from the published description, each on purpose:
- padded keys are left out of the softmax with ``-inf`` (HuggingFace
  masks them the same way); the benchmark's windows have no padding;
- no dropout, no layer drop, no masked time steps: the encoder is
  frozen and evaluated;
- the weights are the benchmark's seeded random ones, not the published
  checkpoint (the configuration's ``assumed``);
- the resampler is scipy's ``resample_poly`` written out in its
  zero-stuffed form (one Kaiser-5 FIR designed by scipy, a convolution
  at stride 8 over the 9-fold zero-stuffed input), the form the
  published pipeline's librosa / scipy calls compute.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from benchmark.reference.speech import mel_spectrogram

LN_EPS = 1e-5
KERNEL, STRIDE = 400, 320
BLOCK = 64
# microsoft/wavlm-large's max_bucket_distance: past it a bucket stops growing
MAX_DISTANCE = 800


def precise() -> None:
    """f32 products in f32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def bucket(r: int, n_buckets: int, max_distance: int) -> int:
    """The bucket of a key ``r`` frames after (r > 0) or before its query:
    half of the buckets for each sign, r > 0 the upper half; distances
    under a quarter of the buckets exact, longer ones on a log scale up
    to ``max_distance``, capped at the half's last bucket."""
    half = n_buckets // 2
    exact = half // 2
    a = abs(r)
    if a < exact:
        b = a
    else:
        b = min(half - 1, exact + int(math.log(a / exact)
                                      / math.log(max_distance / exact)
                                      * (half - exact)))
    return b + (half if r > 0 else 0)


def bucket_table(T, n_buckets, max_distance, device):
    """(T, T) long, entry (i, j) the bucket of r = j - i."""
    by_r = torch.tensor([bucket(r, n_buckets, max_distance)
                         for r in range(-(T - 1), T)], device=device)
    i = torch.arange(T, device=device)
    return by_r[i[None, :] - i[:, None] + T - 1]


class Attention(nn.Module):
    def __init__(self, c, first):
        super().__init__()
        H, nh = c["hidden_size"], c["num_heads"]
        self.c, self.heads = c, nh
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(H, H) for _ in range(4))
        if first:
            self.rel_attn_embed = nn.Embedding(c["rel_pos_buckets"], nh)
        self.gru_rel_pos_linear = nn.Linear(H // nh, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(nh))

    def bias(self, T):
        """(heads, T, T): the embedding at each pair's bucket."""
        b = bucket_table(T, self.c["rel_pos_buckets"], MAX_DISTANCE,
                         self.rel_attn_embed.weight.device)
        return self.rel_attn_embed(b).permute(2, 0, 1)

    def forward(self, x, mask, bias):
        B, T, H = x.shape
        nh, hd = self.heads, H // self.heads

        def heads(y):
            return y.reshape(B, T, nh, hd).transpose(1, 2)     # (B, nh, T, hd)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        g = self.gru_rel_pos_linear(heads(x))                   # (B, nh, T, 8)
        a = torch.sigmoid(g[..., :4].sum(-1))
        b = torch.sigmoid(g[..., 4:].sum(-1))
        gate = a * (b * self.gru_rel_pos_const[None, :, None] - 1.0) + 2.0
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd) \
            + gate[..., None] * bias[None]
        logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
        y = (logits.softmax(-1) @ v).transpose(1, 2).reshape(B, T, H)
        return self.out_proj(y)


class Layer(nn.Module):
    def __init__(self, c, first):
        super().__init__()
        H = c["hidden_size"]
        self.attn = Attention(c, first)
        self.attn_ln = nn.LayerNorm(H, eps=LN_EPS)
        self.ffn_ln = nn.LayerNorm(H, eps=LN_EPS)
        self.fc1 = nn.Linear(H, c["intermediate_size"])
        self.fc2 = nn.Linear(c["intermediate_size"], H)

    def forward(self, x, mask, bias):
        x = x + self.attn(self.attn_ln(x), mask, bias)
        return x + self.fc2(F.gelu(self.fc1(self.ffn_ln(x))))


class WavLM(nn.Module):
    """``c`` is the ``hubert`` group of a configuration file with WavLM's
    key ``rel_pos_buckets``."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        fe = nn.Module()
        c_in = 1
        for i, (o, k, s) in enumerate(zip(c["conv_dim"], c["conv_kernel"],
                                          c["conv_stride"])):
            fe.add_module(f"conv_{i}", nn.Conv1d(c_in, o, k, stride=s,
                                                 bias=c["conv_bias"]))
            fe.add_module(f"ln_{i}", nn.LayerNorm(o, eps=LN_EPS))
            c_in = o
        self.feature_extractor = fe
        self.feat_proj_ln = nn.LayerNorm(c_in, eps=LN_EPS)
        self.feat_proj = nn.Linear(c_in, c["hidden_size"])
        pos = nn.Module()
        k = c["num_conv_pos_embeddings"]
        pos.conv = nn.Conv1d(c["hidden_size"], c["hidden_size"], k,
                             padding=k // 2,
                             groups=c["num_conv_pos_embedding_groups"])
        self.pos_conv = pos
        for i in range(c["num_layers"]):
            self.add_module(f"layer_{i}", Layer(c, i == 0))
        self.final_ln = nn.LayerNorm(c["hidden_size"], eps=LN_EPS)

    def forward(self, wave, mask):
        """wave (B, N), mask (B, T) of valid frames -> (B, T, hidden)."""
        fe = self.feature_extractor
        h = wave[:, None]
        for i in range(len(self.c["conv_dim"])):
            h = getattr(fe, f"conv_{i}")(h)
            h = F.gelu(getattr(fe, f"ln_{i}")(h.transpose(1, 2)).transpose(1, 2))
        h = self.feat_proj(self.feat_proj_ln(h.transpose(1, 2)))
        h = h * mask[..., None]
        p = self.pos_conv.conv(h.transpose(1, 2)).transpose(1, 2)
        if self.c["num_conv_pos_embeddings"] % 2 == 0:
            p = p[:, :-1]
        h = h + F.gelu(p)
        bias = self.layer_0.attn.bias(h.shape[1])
        for i in range(self.c["num_layers"]):
            h = getattr(self, f"layer_{i}")(h, mask, bias)
        return self.final_ln(h)


def resample_9_8(y):
    """(B, N) at 16 kHz -> (B, ceil(9 N / 8)) at 18 kHz: scipy's
    ``resample_poly(y, 9, 8)``, zero-stuffed: the input spread 9 apart,
    the 181-tap FIR (``firwin(181, 1/9, window=('kaiser', 5.0)) * 9``)
    centred on each output, every 8th output kept."""
    from scipy.signal import firwin
    up, down, half = 9, 8, 90
    h = torch.tensor(firwin(2 * half + 1, 1.0 / up, window=("kaiser", 5.0))
                     * up, dtype=torch.float32, device=y.device)
    B, n = y.shape
    n_out = -(-n * up // down)
    stuffed = torch.zeros((B, n * up), device=y.device)
    stuffed[:, ::up] = y
    need = (n_out - 1) * down + 2 * half + 1
    xp = F.pad(stuffed, (half, max(0, need - half - n * up)))
    # h is symmetric: correlating with it is convolving with it
    return F.conv1d(xp[:, None], h.flip(0)[None, None], stride=down)[:, 0, :n_out]


def linear_to(x, n):
    """(B, T, C) -> (B, n, C), linear, both ends kept."""
    T = x.shape[1]
    if T == n:
        return x
    pos = torch.linspace(0.0, T - 1.0, n, device=x.device)
    lo = pos.floor().long()
    hi = (lo + 1).clamp(max=T - 1)
    w = (pos - lo)[None, :, None]
    return x[:, lo] * (1 - w) + x[:, hi] * w


@torch.no_grad()
def frontend(model, wave16, frames, data):
    """int16 windows (B, S) -> (mel (B, frames, n_mels), encoder features
    (B, frames, hidden)), both f32, in blocks of ``BLOCK`` windows."""
    mels, feats = [], []
    S = wave16.shape[1]
    want = (S - (KERNEL - STRIDE)) // STRIDE
    for i in range(0, wave16.shape[0], BLOCK):
        y = wave16[i:i + BLOCK].float() / 32768.0
        mel = mel_spectrogram(resample_9_8(y), data["mel_sr"], data["mel_hop"],
                              data["n_mels"])
        mels.append(mel[:, :frames])
        a = y - y.mean(-1, keepdim=True)
        a = a / torch.sqrt(a.pow(2).mean(-1, keepdim=True) + 1e-7)
        T = (S - KERNEL) // STRIDE + 1
        mask = torch.ones((a.shape[0], T), dtype=torch.bool, device=a.device)
        f = model(a, mask)
        f = F.pad(f, (0, 0, 0, max(want - T, 0)))[:, :want]
        feats.append(linear_to(f, frames))
    return torch.cat(mels), torch.cat(feats)


def window_rel_rms(x, ref):
    """The worst window's ||x - ref|| / ||ref|| over (B, ...) rows."""
    x, ref = x.double().flatten(1), ref.double().flatten(1)
    return float(((x - ref).norm(dim=1) / ref.norm(dim=1)).max())
