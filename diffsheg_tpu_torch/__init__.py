"""diffsheg_tpu_torch — the DiffSHEG serving pipeline in PyTorch + CUDA.

A port of ``diffsheg_tpu`` (JAX/Pallas, TPU) to PyTorch on NVIDIA Hopper.
Module paths mirror the JAX package so each counterpart is easy to find;
the JAX package stays the numerical reference the port is tested against.

This package imports ``torch``, numpy and scipy only — never JAX, Flax or
any module of ``diffsheg_tpu``.

Subpackages
-----------
- ``config``     frozen dataclass configuration (own copy)
- ``diffusion``  schedules, respacing, RePaint step programs, DDIM sampler
- ``models``     denoiser modules, timestep-level cache, fast-path forward,
                 HuBERT encoder
- ``ops``        hand-written CUDA kernels (``csrc/``) and their plain
                 PyTorch versions
- ``audio``      mel frontend, chunked HuBERT runner
- ``sampling``   window generator, streamer, single-call pipeline, live
                 session
- ``serving``    the TCP serving daemon around live sessions, its client
                 and wire protocol
- ``compat``     weights from a JAX variables tree, a reference DiffSHEG
                 ``.tar`` (and back), a HuggingFace HuBERT-large
- ``cli``        ``python -m diffsheg_tpu_torch.cli serve``
"""

__version__ = "0.1.0"
