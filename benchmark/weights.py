"""Seeded weights, made on the device in two large draws.

The benchmark makes every weight itself and hands the same state dict to
the program and to the reference.  Names and shapes come from the
reference's modules (built on the meta device, so nothing is allocated
for them); the values follow the Flax initialiser's distributions, the
ones the DiffSHEG port starts from: matrices and kernels N(0, 1/fan_in),
norm scales and running variances 1, biases and running means 0, the
stylization output projections and the FFN's second linear 0, other free
tensors N(0, 1); then 0.02 N(0, 1) on every leaf, so that no projection is
zero and no norm the identity.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import torch

ZERO_INIT = ("proj_out.out_proj.weight", "proj_out.out_proj.bias",
             "ffn.linear2.weight", "ffn.linear2.bias")
PERTURB = 0.02


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _base(name: str, shape: torch.Size, draw: torch.Tensor) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith(ZERO_INIT):
        return torch.zeros_like(draw)
    if leaf == "weight" and len(shape) >= 2:
        return draw / shape[1:].numel() ** 0.5
    if leaf in ("weight", "running_var"):
        return torch.ones_like(draw)
    if leaf in ("bias", "running_mean"):
        return torch.zeros_like(draw)
    return draw


@torch.no_grad()
def make_state(meta_module: torch.nn.Module, seed: int, tag: str,
               device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every parameter and buffer
    of ``meta_module`` (a module built on the meta device)."""
    entries = list(meta_module.state_dict().items())
    total = sum(t.numel() for _, t in entries)
    gen = generator(seed, tag, device)
    base = torch.randn(total, generator=gen, device=device)
    noise = torch.randn(total, generator=gen, device=device)
    state, offset = {}, 0
    for name, t in entries:
        n = t.numel()
        b = _base(name, t.shape, base[offset:offset + n].view(t.shape))
        e = noise[offset:offset + n].view(t.shape) * PERTURB
        if name.endswith("running_var"):
            e = e.abs()
        state[name] = b + e
        offset += n
    return state


def build(cls, *args, state=None, device=None):
    """``cls(*args)`` allocated on ``device`` without initialising, then
    filled from ``state`` (strict: every name must match)."""
    with torch.device("meta"):
        module = cls(*args)
    if state is None:
        return module
    module = module.to_empty(device=device)
    module.load_state_dict(state, strict=True)
    return module
