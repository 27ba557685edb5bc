"""The reference computed in a lower precision, for the control of
``correct``: every product's operands (activations and weights of each
linear and convolution layer) rounded to float8 e4m3 with one scale per
tensor (its largest magnitude at e4m3's 448), accumulated in f32."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Fp8Linear(nn.Linear):
    def forward(self, x):
        return F.linear(fp8_round(x), fp8_round(self.weight), self.bias)


class _Fp8Conv1d(nn.Conv1d):
    def forward(self, x):
        return self._conv_forward(fp8_round(x), fp8_round(self.weight),
                                  self.bias)


def to_fp8_(module: nn.Module) -> nn.Module:
    """Every linear and 1-D convolution of ``module`` computes on e4m3
    operands from now on (in place; the weights themselves are kept)."""
    for m in module.modules():
        if type(m) is nn.Linear:
            m.__class__ = _Fp8Linear
        elif type(m) is nn.Conv1d:
            m.__class__ = _Fp8Conv1d
    return module
