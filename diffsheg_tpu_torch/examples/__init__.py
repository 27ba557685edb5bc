"""The JAX repository's examples (``examples/*.py``) on the port.

One module per JAX script, with the same file name, function names and
output; each runs as ``python -m diffsheg_tpu_torch.examples.<name>``, on
the GPU unless it is given ``--device cpu`` (which replaces the JAX
scripts' ``--platform`` / ``JAX_PLATFORMS=cpu`` / ``*_ALLOW_CPU``).  With
no card and no ``--device cpu`` a script exits non-zero with a message.
The scripts make their own seeded random weights and synthetic audio and
data; nothing is downloaded.  ``README.md`` beside this file lists them.
"""

from __future__ import annotations

import argparse
import sys

import torch

from diffsheg_tpu_torch.device import resolve_device


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU (the kernels' plain "
                         "versions); default: the GPU")


def script_device(name) -> torch.device:
    """The script's device: the GPU unless ``name`` (a name or a
    ``torch.device``) asks for another; with no card the script exits
    non-zero with the reason."""
    try:
        return resolve_device(name)
    except RuntimeError as e:
        sys.exit(f"{sys.argv[0]}: {e}")


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
