"""DDIM + RePaint reverse process for one window.

Counterpart of ``ddim_sample_program`` in ``diffsheg_tpu/diffusion/sampler.py``
for the serving configuration: epsilon prediction, no clipping, eta = 0,
with the streamlined step of ``diffsheg_tpu/ops/step_math.py``
(``ddim_repaint_step_reference``), the RePaint overlap projection with the
low-noise linear blend, and optional saved noisy tails
(``same_overlap_noisy``).  The step program runs as a host loop.

Noise comes from an injectable :class:`NoiseSource`.  PyTorch cannot
replay JAX's threefry draws, so the tests hand the sampler a
:class:`TableNoise` built in JAX by replaying the key chain; on the card
the default is :class:`GeneratorNoise`, a seeded ``torch.Generator``.
Draws are addressed by (window, step, kind) where the JAX chain is: per
window ``rng, k = split(window_key)``, ``noise = normal(k)``; per step
``key, k_model, k_gt, k_undo = split(key, 4)``, the RePaint GT noise
``normal(k_gt)`` and the undo noise ``normal(k_undo)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from diffsheg_tpu_torch.diffusion.jump import StepProgram
from diffsheg_tpu_torch.diffusion.schedule import DiffusionSchedule

# denoise_fn(x, t) -> model epsilon; t is the respaced level (python int)
DenoiseFn = Callable[[torch.Tensor, int], torch.Tensor]


class NoiseSource:
    """Gaussian draws for the sampler, addressed by window and step."""

    def initial(self, window: int, shape, device) -> torch.Tensor:
        """The window's starting noise x_T."""
        raise NotImplementedError

    def step(self, window: int, step: int, kind: str, shape,
             device) -> torch.Tensor:
        """``kind`` 'gt' (RePaint GT noise of a denoise step) or 'undo'
        (re-noising of an undo step)."""
        raise NotImplementedError


class GeneratorNoise(NoiseSource):
    """Draws from one seeded ``torch.Generator`` on the sampling device, in
    call order."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def initial(self, window, shape, device):
        return torch.randn(shape, generator=self.gen, device=device)

    def step(self, window, step, kind, shape, device):
        return torch.randn(shape, generator=self.gen, device=device)


class TableNoise(NoiseSource):
    """Precomputed draws: ``initial[w]`` and ``steps[(w, s, kind)]`` as
    numpy arrays (e.g. replayed from a JAX key chain)."""

    def __init__(self, initial: Dict[int, np.ndarray],
                 steps: Dict[Tuple[int, int, str], np.ndarray]):
        self.initial_tab, self.steps = initial, steps

    def initial(self, window, shape, device):
        return self._get(self.initial_tab[window], shape, device)

    def step(self, window, step, kind, shape, device):
        return self._get(self.steps[(window, step, kind)], shape, device)

    @staticmethod
    def _get(a, shape, device):
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"noise table entry {a.shape} != {tuple(shape)}")
        return torch.tensor(np.array(a, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class RepaintSpec:
    """Outpainting of one window: ``overlap_len`` head frames projected
    toward noised GT each denoise step, cross-faded once the noise level
    drops below 0.2 (``add_blend``)."""

    overlap_len: int
    add_blend: bool = True
    same_overlap_noisy: bool = False


def ddim_repaint_step(x, eps_out, ab_prev: float, r: float, rm1: float,
                      gt, gt_noise, prev_tail, prev_valid: bool,
                      overlap_len: int, add_blend: bool) -> torch.Tensor:
    """The eta=0 DDIM step from (x, eps) plus the RePaint head:

        x0   = r x - rm1 eps;  mean = sqrt(ab_prev) x0 + sqrt(1-ab_prev) eps
        head = saved tail if valid else sqrt(ab_prev) gt + sqrt(1-ab_prev) n
        head = linear blend toward mean when sqrt(1-ab_prev) < 0.2
    """
    f32 = np.float32
    sqrt_ab_prev = float(np.sqrt(f32(ab_prev)))
    noise_w = np.sqrt(f32(1.0) - f32(ab_prev))
    x0 = r * x - rm1 * eps_out
    mean = sqrt_ab_prev * x0 + float(noise_w) * eps_out
    if gt is None:
        return mean
    ov = overlap_len
    head = (sqrt_ab_prev * gt + float(noise_w) * gt_noise)[:, :ov]
    if prev_tail is not None and prev_valid:
        head = prev_tail
    if add_blend and noise_w < f32(0.2):
        w = torch.linspace(0.0, 1.0, ov, device=x.device).reshape(1, ov, 1)
        head = head * (1.0 - w) + mean[:, :ov] * w
    return torch.cat([head, mean[:, ov:]], dim=1)


def ddim_sample_program(
    sched: DiffusionSchedule,
    denoise_fn: DenoiseFn,
    program: StepProgram,
    noise: NoiseSource,
    window: int,
    shape: Tuple[int, int, int],
    device,
    repaint: Optional[RepaintSpec] = None,
    gt: Optional[torch.Tensor] = None,
    prev_saved_tails: Optional[torch.Tensor] = None,
    prev_tails_valid: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a reverse program from the window's initial noise; returns
    ``(sample, saved_tails)``, the tails (levels, B, overlap, C) being
    meaningful only under ``same_overlap_noisy``.  ``prev_tails_valid``
    False makes a window ignore ``prev_saved_tails`` (the first
    continuation window has none yet)."""
    B, _, C = shape
    do_repaint = repaint is not None and repaint.overlap_len > 0 and gt is not None
    track_tails = do_repaint and repaint.same_overlap_noisy
    ov = repaint.overlap_len if do_repaint else 1
    tails = torch.zeros((sched.num_steps + 1, B, ov, C), device=device)
    use_prev = track_tails and prev_saved_tails is not None

    x = noise.initial(window, shape, device)
    for s, (t, is_denoise) in enumerate(zip(program.t.tolist(),
                                            program.denoise.tolist())):
        if not is_denoise:
            x = sched.undo(x, t, noise.step(window, s, "undo", shape, device))
            continue
        eps = denoise_fn(x, t)
        x = ddim_repaint_step(
            x, eps, sched.alphas_cumprod_prev[t],
            float(sched.sqrt_recip_alphas_cumprod[t]),
            float(sched.sqrt_recipm1_alphas_cumprod[t]),
            gt if do_repaint else None,
            noise.step(window, s, "gt", shape, device) if do_repaint else None,
            prev_saved_tails[t] if use_prev else None,
            prev_tails_valid is None or bool(prev_tails_valid),
            ov if do_repaint else 0, do_repaint and repaint.add_blend)
        if track_tails:
            tails[t] = x[:, -ov:]
    return x, tails
