"""diffsheg_tpu_torch — DiffSHEG serving and training in PyTorch + CUDA.

A port of ``diffsheg_tpu`` (JAX/Pallas, TPU) to PyTorch on NVIDIA Hopper.
Module paths mirror the JAX package so each counterpart is easy to find;
the JAX package stays the numerical reference the port is tested against.

This package imports ``torch``, numpy and scipy only — never JAX, Flax or
any module of ``diffsheg_tpu``.

Subpackages
-----------
- ``config``     frozen dataclass configuration (own copy)
- ``diffusion``  schedules, respacing, RePaint step programs, DDIM and
                 ancestral samplers, training losses, timestep samplers
- ``models``     denoiser modules, timestep-level cache, fast-path forward,
                 HuBERT encoder
- ``ops``        hand-written CUDA kernels (``csrc/``) and their plain
                 PyTorch versions
- ``audio``      wav IO, mel and MFCC frontends, chunked HuBERT runner,
                 onset detection
- ``sampling``   window generator, streamer, single-call pipeline, live
                 session, motion export (npy / BVH / face JSON), the
                 test-set stream
- ``serving``    the TCP serving daemon around live sessions, its client
                 and wire protocol
- ``geometry``   rotation conversions (torch), BVH IO and forward
                 kinematics, joint tables, face JSON
- ``data``       array caches and their builders from raw BEAT / SHOW
                 splits, the window datasets and their statistics, the
                 sharded batch loader, raw BVH preprocessing
- ``runtime``    the frame-file parser and row gather (numpy)
- ``train``      the training step, the trainer loop, checkpoints
- ``eval``       the FGD feature net, Frechet distance, MSE, PCK, SRGR,
                 diversity, beat alignment
- ``viz``        the self-contained HTML motion player
- ``utils``      metric logging, stage timing, device traces, smoothing
                 filters
- ``compat``     weights (or a whole train state) from JAX, a reference
                 DiffSHEG ``.tar`` (and back), a HuggingFace HuBERT (large
                 or base), the reference's FGD autoencoder
- ``cli``        ``python -m diffsheg_tpu_torch.cli build-cache | train |
                 eval | test-stream | generate | serve | export-ckpt |
                 view``
"""

__version__ = "0.1.0"
