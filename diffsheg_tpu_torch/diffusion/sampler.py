"""DDIM + RePaint and ancestral reverse processes for one window.

Counterpart of ``diffsheg_tpu/diffusion/sampler.py``.
:func:`ddim_sample_program`: the general DDIM step (``mean_type`` epsilon / start_x / previous_x,
``clip_denoised``, ``eta``) with the RePaint overlap projection and its
low-noise linear blend, or, for the serving configuration (epsilon, no
clipping, eta = 0), the streamlined step of ``ops/step_math.py`` as its
plain version or its CUDA kernel; optional saved noisy tails
(``same_overlap_noisy``).  :func:`ancestral_sample_program`: the
ancestral ``p_sample`` step with every ``var_type``
(:func:`model_log_variance`) and the RePaint projection before the model
call.  A step program runs as a host loop: each model call in a
``sampler.call`` span, each step's other work (noise draws, step math,
projection, tails; an undo step) in a ``sampler.update`` span
(``utils/profiling.py``).

Noise comes from an injectable :class:`NoiseSource`.  PyTorch cannot
replay JAX's threefry draws, so the tests hand the sampler a
:class:`TableNoise` built in JAX by replaying the key chain; on the card
the default is :class:`GeneratorNoise`, a seeded ``torch.Generator``.
Draws are addressed by (window, step, kind) where the JAX chain is: per
window ``rng, k = split(window_key)``, ``noise = normal(k)``; per step
``key, k_model, k_gt, k_undo = split(key, 4)``, the DDIM noise
``normal(k_model)`` (drawn only where eta > 0 adds it), the RePaint GT
noise ``normal(k_gt)`` and the undo noise ``normal(k_undo)``.  The
ancestral chain splits ``key, k_gt, k_trans, k_undo = split(key, 4)``: on
each denoise step the GT noise (under RePaint, the first step too, where
it goes unused) and the transition noise ``normal(k_trans)`` (at t = 0
too, where it is scaled by 0), on each undo step the undo noise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from diffsheg_tpu_torch.diffusion.jump import StepProgram, plain_program
from diffsheg_tpu_torch.diffusion.schedule import DiffusionSchedule
from diffsheg_tpu_torch.diffusion.vlb import learned_range_logvar
from diffsheg_tpu_torch.ops.step_math import (blend_weights,
                                              ddim_repaint_step_reference,
                                              fused_ddim_repaint_step)
from diffsheg_tpu_torch.utils.profiling import span

# denoise_fn(x, t) -> model epsilon; t is the respaced level (python int)
DenoiseFn = Callable[[torch.Tensor, int], torch.Tensor]


class NoiseSource:
    """Gaussian draws for the sampler, addressed by window and step."""

    def initial(self, window: int, shape, device) -> torch.Tensor:
        """The window's starting noise x_T."""
        raise NotImplementedError

    def step(self, window: int, step: int, kind: str, shape,
             device) -> torch.Tensor:
        """``kind`` 'model' (DDIM noise of a denoise step at eta > 0), 'gt'
        (RePaint GT noise of a denoise step), 'trans' (transition noise of
        an ancestral denoise step) or 'undo' (re-noising of an undo
        step)."""
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


def split_model_output(model_out: torch.Tensor, var_type: str):
    """(mean part, raw variance): a learned-variance output carries 2C
    channels; the fixed variances pass through."""
    if var_type in ("learned", "learned_range"):
        C = model_out.shape[-1] // 2
        return model_out[..., :C], model_out[..., C:]
    return model_out, None


def model_log_variance(sched: DiffusionSchedule, var_type: str,
                       var_raw: Optional[torch.Tensor], t: int):
    """The log-variance of p(x_{t-1} | x_t) at level ``t``: the model's
    raw variance ('learned'), its interpolation ('learned_range'), or the
    schedule's posterior ('fixed_small') or beta ('fixed_large') value as
    a python float."""
    if var_type == "learned":
        return var_raw
    if var_type == "learned_range":
        return learned_range_logvar(sched, var_raw, t)
    if var_type == "fixed_small":
        return float(sched.posterior_log_variance_clipped[t])
    if var_type == "fixed_large":
        return float(sched.log_large_variance[t])
    raise ValueError(var_type)


def _pred_xstart(sched: DiffusionSchedule, mean_type: str, x, t: int,
                 model_out, clip_denoised: bool) -> torch.Tensor:
    if mean_type == "epsilon":
        x0 = sched.predict_xstart_from_eps(x, t, model_out)
    elif mean_type == "start_x":
        x0 = model_out
    elif mean_type == "previous_x":
        x0 = sched.predict_xstart_from_xprev(x, t, model_out)
    else:
        raise ValueError(mean_type)
    if clip_denoised:
        x0 = x0.clamp(-1.0, 1.0)
    return x0


def ddim_update(sched: DiffusionSchedule, x, t: int, x0,
                noise: Optional[torch.Tensor], eta: float = 0.0):
    """DDIM eq. 12 step t -> t-1, scalars in float32 as the JAX tables
    are gathered; ``noise`` may be None where it adds nothing (eta = 0 or
    t = 0)."""
    f32, one = np.float32, np.float32(1.0)
    ab, ab_prev = f32(sched.alphas_cumprod[t]), f32(sched.alphas_cumprod_prev[t])
    eps = ((float(np.sqrt(one / ab)) * x - x0)
           / float(np.sqrt(one / ab - one)))
    sigma = (f32(eta) * np.sqrt((one - ab_prev) / (one - ab))
             * np.sqrt(one - ab / ab_prev))
    mean = (x0 * float(np.sqrt(ab_prev))
            + float(np.sqrt(one - ab_prev - sigma ** 2)) * eps)
    if t != 0 and sigma != 0:
        mean = mean + float(sigma) * noise
    return mean


def repaint_project(sched: DiffusionSchedule, spec: RepaintSpec, x, t: int,
                    gt, noise, prev_tail=None,
                    prev_tail_valid: Optional[bool] = None) -> torch.Tensor:
    """Project the overlap head of the updated sample ``x`` toward noised
    ``gt`` (or the saved tail, when ``prev_tail_valid`` is None or true),
    cross-faded toward ``x`` once sqrt(1 - ab_prev) < 0.2."""
    ov = spec.overlap_len
    f32 = np.float32
    ab_prev = f32(sched.alphas_cumprod_prev[t])
    noise_w = np.sqrt(f32(1.0) - ab_prev)
    head = (float(np.sqrt(ab_prev)) * gt[:, :ov]
            + float(noise_w) * noise[:, :ov])
    if prev_tail is not None and (prev_tail_valid is None
                                  or bool(prev_tail_valid)):
        head = prev_tail
    if spec.add_blend and noise_w < f32(0.2):
        w = blend_weights(ov, x.device)
        head = head * (1.0 - w) + x[:, :ov] * w
    return torch.cat([head, x[:, ov:]], dim=1)


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
    mean_type: str = "epsilon",
    var_type: str = "fixed_small",
    clip_denoised: bool = False,
    eta: float = 0.0,
    fused_step: str = "jnp",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a reverse program from the window's initial noise; returns
    ``(sample, saved_tails)``, the tails (levels, B, overlap, C) being
    meaningful only under ``same_overlap_noisy``.  ``prev_tails_valid``
    False makes a window ignore ``prev_saved_tails`` (the first
    continuation window has none yet).

    ``fused_step``: 'none' runs the general step (pred-xstart, DDIM update
    with ``eta``, RePaint projection); 'jnp' the streamlined step's plain
    version and 'kernel' its CUDA kernel (``ops/step_math.py``), which
    apply to epsilon prediction without clipping at eta = 0 — other
    settings take the general step."""
    B, _, C = shape
    do_repaint = repaint is not None and repaint.overlap_len > 0 and gt is not None
    track_tails = do_repaint and repaint.same_overlap_noisy
    ov = repaint.overlap_len if do_repaint else 1
    tails = torch.zeros((sched.num_steps + 1, B, ov, C), device=device)
    use_prev = track_tails and prev_saved_tails is not None
    valid = use_prev and (prev_tails_valid is None or bool(prev_tails_valid))
    use_fast = (fused_step != "none" and mean_type == "epsilon"
                and not clip_denoised and eta == 0.0)
    step_fn = (fused_ddim_repaint_step if fused_step == "kernel"
               else ddim_repaint_step_reference)

    x = noise.initial(window, shape, device)
    for s, (t, is_denoise) in enumerate(zip(program.t.tolist(),
                                            program.denoise.tolist())):
        if not is_denoise:
            with span("sampler.update"):
                x = sched.undo(x, t, noise.step(window, s, "undo", shape,
                                                device))
            continue
        with span("sampler.call"):
            out, _ = split_model_output(denoise_fn(x, t), var_type)
        with span("sampler.update"):
            prev_tail = prev_saved_tails[t] if use_prev else None
            if use_fast:
                # a learned-variance output's mean half is a strided view;
                # the kernel takes contiguous operands
                x = step_fn(
                    x, out.contiguous(),
                    (sched.alphas_cumprod_prev[t],
                     sched.sqrt_recip_alphas_cumprod[t],
                     sched.sqrt_recipm1_alphas_cumprod[t], float(valid)),
                    gt if do_repaint else None,
                    noise.step(window, s, "gt", shape, device)
                    if do_repaint else None,
                    prev_tail, ov if do_repaint else 0,
                    do_repaint and repaint.add_blend)
            else:
                x0 = _pred_xstart(sched, mean_type, x, t, out, clip_denoised)
                x = ddim_update(sched, x, t, x0,
                                noise.step(window, s, "model", shape, device)
                                if eta > 0 and t != 0 else None, eta)
                if do_repaint:
                    x = repaint_project(
                        sched, repaint, x, t, gt,
                        noise.step(window, s, "gt", shape, device), prev_tail,
                        prev_tails_valid if use_prev else None)
            if track_tails:
                tails[t] = x[:, -ov:]
    return x, tails


def ancestral_sample_program(
    sched: DiffusionSchedule,
    denoise_fn: DenoiseFn,
    program: Optional[StepProgram],
    noise: NoiseSource,
    window: int,
    shape: Tuple[int, int, int],
    device,
    repaint: Optional[RepaintSpec] = None,
    gt: Optional[torch.Tensor] = None,
    mean_type: str = "epsilon",
    var_type: str = "fixed_small",
    clip_denoised: bool = False,
) -> torch.Tensor:
    """Ancestral sampling from the window's initial noise (JAX
    ``ancestral_sample_program``): ``program`` None walks every level
    descending; a jump program re-noises its undo steps at ``t + 1``
    (which the jump programs keep below ``num_steps``).  Each denoise step
    is ``mean + exp(log_var / 2) * noise`` (the noise term scaled by 0 at
    t = 0), the mean the posterior mean of the predicted x0 or, for
    'previous_x', the model output.  With ``repaint`` and ``gt`` the
    overlap head of ``x`` is replaced by noised GT *before* the model
    call, from the second denoise step on."""
    if program is None:
        program = plain_program(sched.num_steps)
    do_repaint = repaint is not None and repaint.overlap_len > 0 and gt is not None
    x = noise.initial(window, shape, device)
    started = False
    f32 = np.float32
    for s, (t, is_denoise) in enumerate(zip(program.t.tolist(),
                                            program.denoise.tolist())):
        if not is_denoise:
            with span("sampler.update"):
                x = sched.undo(x, t + 1, noise.step(window, s, "undo", shape,
                                                    device))
            continue
        if do_repaint:
            with span("sampler.update"):
                gt_noise = noise.step(window, s, "gt", shape, device)
                if started:
                    ov = repaint.overlap_len
                    ab = f32(sched.alphas_cumprod[t])
                    head = (float(np.sqrt(ab)) * gt[:, :ov]
                            + float(np.sqrt(f32(1.0) - ab)) * gt_noise[:, :ov])
                    x = torch.cat([head, x[:, ov:]], dim=1)
        with span("sampler.call"):
            out, var_raw = split_model_output(denoise_fn(x, t), var_type)
        with span("sampler.update"):
            x0 = _pred_xstart(sched, mean_type, x, t, out, clip_denoised)
            mean = (out if mean_type == "previous_x"
                    else sched.q_posterior_mean(x0, x, t))
            log_var = model_log_variance(sched, var_type, var_raw, t)
            if isinstance(log_var, float):
                std = float(np.exp(f32(0.5) * f32(log_var)))
            else:
                std = torch.exp(0.5 * log_var)
            trans = noise.step(window, s, "trans", shape, device)
            x = mean + float(t != 0) * std * trans
        started = True
    return x
