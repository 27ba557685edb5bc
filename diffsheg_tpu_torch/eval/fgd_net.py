"""Frozen FGD feature extractor.

Counterpart of ``diffsheg_tpu/eval/fgd_net.py``, the reference's
evaluation autoencoder (reference models/motion_autoencoder.py:38-203,
``vae_length=300``): a 1-D convolution tower over time and an MLP head;
the 300-d ``mu`` latent feeds the Frechet Gesture Distance.

The modules carry the Flax names (``pose_encoder/conv0``, ``bn0/
BatchNorm_0``, ..., ``fc_mu``), so ``compat/from_jax.py::load_flax_tree``
fills them from JAX's variables and ``compat/fgd_ckpt.py`` from the
reference's state dict.  The input is (B, T, C), time-major as in Flax;
the convolutions run on (B, C, T) (``VALID``, no padding), and the
flatten before the head is channel-major, torch's ``(B, C, T).flatten(1)``.

The head follows the window length: 34 frames give ``fc1`` alone, 64
frames and up (SHOW's 88) ``fc0`` + ``fcbn0`` + ``fc1``.  The reference
builds the head's activations as ``nn.LeakyReLU(True)`` — a negative
slope of 1.0, the identity — so only the convolution tower has real
(slope 0.2) nonlinearities, and nothing follows ``fcbn1`` / ``fcbn2``.
BatchNorm runs in inference mode on the running statistics, eps 1e-5
(the net is only used frozen).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from diffsheg_tpu_torch.device import DeviceLike, resolve_device
from diffsheg_tpu_torch.models.denoiser import BatchNorm


@dataclasses.dataclass(frozen=True)
class FgdNetConfig:
    n_frames: int = 34        # training window (34 BEAT / 88 SHOW)
    pose_dim: int = 192       # channels scored (gesture + expression, BEAT)
    feature_length: int = 300 # latent width (reference vae_length)

    @property
    def conv_out_frames(self) -> int:
        # k3s1, k3s1, k4s2, k3s1 over n_frames
        t = self.n_frames - 2
        t = t - 2
        t = (t - 4) // 2 + 1
        return t - 2


class _BN(nn.Module):
    """Inference BatchNorm over the channel (last) axis, under Flax's
    inner-module name."""

    def __init__(self, features: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(features, eps=1e-5)

    def forward(self, x):
        return self.BatchNorm_0(x)


class PoseEncoder(nn.Module):
    """Convolution tower + MLP head -> mu (B, feature_length)."""

    def __init__(self, cfg: FgdNetConfig):
        super().__init__()
        self.cfg = cfg
        base = cfg.feature_length
        self.conv0 = nn.Conv1d(cfg.pose_dim, base, 3)
        self.bn0 = _BN(base)
        self.conv1 = nn.Conv1d(base, base * 2, 3)
        self.bn1 = _BN(base * 2)
        self.conv2 = nn.Conv1d(base * 2, base * 2, 4, stride=2)
        self.bn2 = _BN(base * 2)
        self.conv3 = nn.Conv1d(base * 2, base, 3)
        flat = base * cfg.conv_out_frames
        if cfg.n_frames >= 64:
            self.fc0 = nn.Linear(flat, base * 12)
            self.fcbn0 = _BN(base * 12)
            self.fc1 = nn.Linear(base * 12, base * 4)
        else:
            self.fc1 = nn.Linear(flat, base * 4)
        self.fcbn1 = _BN(base * 4)
        self.fc2 = nn.Linear(base * 4, base * 2)
        self.fcbn2 = _BN(base * 2)
        self.fc3 = nn.Linear(base * 2, base)
        self.fc_mu = nn.Linear(base, base)

    def forward(self, poses: torch.Tensor) -> torch.Tensor:
        def conv_bn(x, conv, bn):     # (B, C, T) through a channels-last BN
            return bn(conv(x).transpose(1, 2)).transpose(1, 2)

        x = poses.transpose(1, 2)                       # (B, C, T)
        x = F.leaky_relu(conv_bn(x, self.conv0, self.bn0), 0.2)
        x = F.leaky_relu(conv_bn(x, self.conv1, self.bn1), 0.2)
        x = F.leaky_relu(conv_bn(x, self.conv2, self.bn2), 0.2)
        x = self.conv3(x).flatten(1)                    # channel-major
        if self.cfg.n_frames >= 64:
            x = self.fc1(self.fcbn0(self.fc0(x)))
        else:
            x = self.fc1(x)
        # LeakyReLU(True) == identity in the reference: no activation
        x = self.fc2(self.fcbn1(x))
        x = self.fc3(self.fcbn2(x))
        return self.fc_mu(x)


class FgdFeatureNet(nn.Module):
    """HalfEmbeddingNet equivalent: the encoder alone, returning the mu
    latent of (B, n_frames, pose_dim) windows."""

    def __init__(self, cfg: FgdNetConfig):
        super().__init__()
        self.cfg = cfg
        self.pose_encoder = PoseEncoder(cfg)

    def forward(self, poses: torch.Tensor) -> torch.Tensor:
        return self.pose_encoder(poses)


def init_fgd_net(cfg: FgdNetConfig, seed: int = 0,
                 device: DeviceLike = None) -> FgdFeatureNet:
    """A seeded random net in inference mode on ``device`` (default: the
    GPU; raises without one): LeCun-normal kernels and zero biases, as
    Flax initialises them, BatchNorm at identity statistics."""
    dev = resolve_device(device)
    net = FgdFeatureNet(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / fan_in ** 0.5)
                m.bias.zero_()
    return net.to(dev).eval()
