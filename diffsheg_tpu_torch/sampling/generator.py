"""Single-window generation: model + schedule + step programs.

Counterpart of ``diffsheg_tpu/sampling/generator.py``.  A window runs
either the *plain* program (every respaced step, the first window) or the
*harmonize* program (RePaint jump schedule from 60% depth, continuation
windows, with the overlap projection).  The model is any that
``models/factory.py::build_denoiser`` builds.  The selection logic is the
JAX generator's, with "on TPU" read as "on CUDA":

- ``diffusion.sampler`` 'ddim' (the DDIM step) or 'ancestral' (the
  ancestral ``p_sample`` step, every ``var_type``; no
  ``stream.same_overlap_noisy``);
- ``diffusion.level_cache`` with at most 64 respaced steps, for a
  UniDiffuser the cache covers (``level_cache.supports_level_cache``):
  the timestep-level cache (``models/level_cache.py``); longer schedules,
  other models and ``level_cache=False`` run the uncached forward;
- ``diffusion.fused_layer`` 'auto' / 'on' (the per-layer kernel) or
  'chain' (the branch kernel): the fused fast path, which consumes the
  cache; 'off': the module forward, fed by the cache when there is one;
- ``diffusion.fused_step`` 'off': the general DDIM step; 'auto' / 'jnp':
  the streamlined step's plain version; 'on': its CUDA kernel (for a
  learned-variance model on the mean half of its output);
- ``diffusion.quantize`` 'int8' / 'int4': weight-only quantized
  transformer stacks on the fast path (the quantized variants of the
  fused-layer kernels); a ValueError without the fast path, as in JAX.

A model conditioned on text or emotion labels samples with zero labels.
"""

from __future__ import annotations

import copy
import threading
from typing import Optional

import numpy as np
import torch

from diffsheg_tpu_torch.config import Config, check_variance_coupling
from diffsheg_tpu_torch.device import DeviceLike, resolve_device, torch_dtype
from diffsheg_tpu_torch.diffusion.jump import (jump_schedule_ddim,
                                               make_step_program,
                                               plain_program)
from diffsheg_tpu_torch.diffusion.respace import (make_respaced_schedule,
                                                  space_timesteps)
from diffsheg_tpu_torch.diffusion.sampler import (NoiseSource, RepaintSpec,
                                                  ancestral_sample_program,
                                                  ddim_sample_program)
from diffsheg_tpu_torch.diffusion.schedule import (get_named_beta_schedule,
                                                   make_schedule)
from diffsheg_tpu_torch.models.factory import ablate_inputs, denoised_channels
from diffsheg_tpu_torch.models.fast_forward import (extract_fast_params,
                                                    fast_unidiffuser_step,
                                                    supports_fast_forward)
from diffsheg_tpu_torch.models.level_cache import (AudioCache, ModelCache,
                                                   StaticCache,
                                                   build_audio_cache,
                                                   build_static_cache,
                                                   combine, gather_level,
                                                   supports_level_cache)
from diffsheg_tpu_torch.models.unidiffuser import UniDiffuser

# diffusion.fused_step -> the sampler's step mode
STEP_MODES = {"off": "none", "auto": "jnp", "jnp": "jnp", "on": "kernel"}


class WindowGenerator:
    """Window-level sampling for a model of ``build_denoiser``.

    The model is copied, cast to ``cfg.model.compute_dtype`` (weights stored
    in the compute dtype, as the JAX generator does) and moved to
    ``device`` (default: the GPU).
    """

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 device: DeviceLike = None):
        check_variance_coupling(cfg)
        d, stream = cfg.diffusion, cfg.stream
        if d.fused_layer not in ("auto", "on", "chain", "off"):
            raise ValueError(f"diffusion.fused_layer={d.fused_layer!r}")
        if d.fused_step not in STEP_MODES:
            raise ValueError(f"diffusion.fused_step={d.fused_step!r}")
        if d.quantize not in ("none", "int8", "int4"):
            raise ValueError(f"diffusion.quantize={d.quantize!r}: valid "
                             "values are 'none', 'int8', 'int4'")
        if d.sampler not in ("ddim", "ancestral"):
            raise ValueError(
                f"diffusion.sampler={d.sampler!r}: valid samplers are "
                "'ddim', 'ancestral'")
        self.ancestral = d.sampler == "ancestral"
        if self.ancestral and stream.same_overlap_noisy:
            raise ValueError(
                "diffusion.sampler='ancestral' does not support "
                "stream.same_overlap_noisy — the reference's p_sample "
                "inpaint (gaussian_diffusion.py:729-745) has no noisy-"
                "overlap reuse; it is a ddim_sample feature (:1034-1060)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.model.compute_dtype)
        self.model = copy.deepcopy(model).to(device=self.device,
                                             dtype=self.dtype).eval()
        self.chain = d.fused_layer == "chain"
        self.step_mode = STEP_MODES[d.fused_step]

        base_betas = get_named_beta_schedule(d.beta_schedule, d.num_steps)
        if d.respacing:
            self.schedule, self.timestep_map = make_respaced_schedule(
                base_betas, space_timesteps(d.num_steps, d.respacing))
        else:
            self.schedule = make_schedule(base_betas)
            self.timestep_map = np.arange(d.num_steps, dtype=np.int32)
        self.t_levels = torch.as_tensor(self.timestep_map, device=self.device)
        n = self.schedule.num_steps
        # the level cache covers the joint encoder model at sampling-
        # friendly step counts; the uncached forward is the general path
        mcfg = cfg.model
        self.use_cache = (d.level_cache and isinstance(self.model, UniDiffuser)
                          and supports_level_cache(mcfg) and n <= 64)
        self.use_fast = (self.use_cache and supports_fast_forward(mcfg)
                         and d.fused_layer in ("auto", "on", "chain"))
        if d.quantize != "none" and not self.use_fast:
            raise ValueError(
                "diffusion.quantize requires the fused-layer fast path "
                "(diffusion.level_cache=True, at most 64 respaced steps, "
                "fused_layer 'auto' / 'on' / 'chain'); the module forward "
                "has no quantized engine")
        self._plain = plain_program(n)
        jl, jns = (1, 1) if d.no_resample else (d.jump_length, d.jump_n_sample)
        self._harmonize = make_step_program(jump_schedule_ddim(n, jl, jns))
        self._repaint_prog = self._plain if stream.no_repaint else self._harmonize
        self.spec = RepaintSpec(overlap_len=stream.overlap_len,
                                add_blend=stream.add_blend,
                                same_overlap_noisy=stream.same_overlap_noisy)
        # make_fast's weights by window length; sessions on other threads
        # share the generator (serving/server.py)
        self._fast = {}
        self._fast_lock = threading.Lock()

    # -- cache and fast-path weights ---------------------------------------
    # Each returns None where it does not apply (no cache, no fast path).
    def cache_static(self, pid: torch.Tensor) -> Optional[StaticCache]:
        if not self.use_cache:
            return None
        _, pid = ablate_inputs(self.cfg.model, None, pid.to(self.device))
        return build_static_cache(self.model, self.t_levels, pid)

    def cache_audio(self, mel: torch.Tensor,
                    hubert: Optional[torch.Tensor]) -> Optional[AudioCache]:
        """``mel`` (N, T, A) may fold windows into N."""
        if not self.use_cache:
            return None
        mel, _ = ablate_inputs(self.cfg.model, mel.to(self.device), None)
        return build_audio_cache(self.model, self.t_levels, mel,
                                 None if hubert is None else hubert.to(self.device))

    def build_cache(self, mel, pid, hubert) -> Optional[ModelCache]:
        if not self.use_cache:
            return None
        return combine(self.cache_static(pid), self.cache_audio(mel, hubert))

    def load_weights(self, model: torch.nn.Module) -> None:
        """Take ``model``'s current weights and BatchNorm statistics into
        the generator's copy (cast to its dtype) and drop the fast-path
        weights built from the old ones: how a trainer evaluates each
        epoch's model on one generator."""
        self.model.load_state_dict(model.state_dict())
        with self._fast_lock:
            self._fast.clear()

    def make_fast(self, T: int):
        """The fast path's kernel-ready weights for windows of ``T``
        frames, built once per window length and kept until
        :meth:`load_weights`; None without the fast path."""
        if not self.use_fast:
            return None
        with self._fast_lock:
            if T not in self._fast:
                self._fast[T] = extract_fast_params(
                    self.cfg.model, self.model, T, self.cfg.diffusion.quantize)
            return self._fast[T]

    # -- sampling ------------------------------------------------------------
    def _denoise_fn(self, cache: Optional[ModelCache], fast, mel, pid,
                    hubert):
        """The fast path on the cache, or the module forward (fed by the
        cache when there is one) on the window's conditioning."""
        mcfg, sched = self.cfg.model, self.schedule
        mel, pid = ablate_inputs(mcfg, mel, pid)
        # a model conditioned on labels gets zero labels (the training
        # sentinel's clamp), as none come with the audio
        kw = {}
        for name, on in (("word", mcfg.add_text_cond),
                         ("emo", mcfg.add_emo_cond)):
            if on:
                kw[name] = torch.zeros(mel.shape[:2], dtype=torch.long,
                                       device=mel.device)

        @torch.no_grad()
        def fn(x: torch.Tensor, t: int) -> torch.Tensor:
            sqrt_alphas = (float(sched.sqrt_recip_alphas_cumprod[t]),
                           float(sched.sqrt_recipm1_alphas_cumprod[t]))
            level = None if cache is None else gather_level(cache, t)
            if fast is not None:
                return fast_unidiffuser_step(
                    mcfg, fast, x, sqrt_alphas, level,
                    cfg_inference=mcfg.uses_cfg_at_inference,
                    chain=self.chain)
            extra = kw if level is None else dict(kw, cache=level)
            return self.model(
                x, self.t_levels[t].expand(x.shape[0]), sqrt_alphas, mel,
                pid, hubert=hubert, cfg_inference=mcfg.uses_cfg_at_inference,
                **extra)
        return fn

    def _sample(self, program, mel, pid, hubert, noise, window, cache, fast,
                repaint=None, gt=None, **kw):
        """``(sample, saved_tails)``; the ancestral program keeps the
        (levels, B, overlap, C) tails carry, zero."""
        d = self.cfg.diffusion
        fn = self._denoise_fn(cache, fast, mel, pid, hubert)
        shape = self._shape(mel)
        common = dict(mean_type=d.mean_type, var_type=d.var_type,
                      clip_denoised=d.clip_denoised)
        if self.ancestral:
            x = ancestral_sample_program(
                self.schedule, fn, program, noise, window, shape,
                self.device, repaint=repaint, gt=gt, **common)
            ov = self.spec.overlap_len
            return x, torch.zeros((self.schedule.num_steps + 1, shape[0],
                                   ov, shape[2]), device=self.device)
        return ddim_sample_program(
            self.schedule, fn, program, noise, window, shape, self.device,
            repaint=repaint, gt=gt, fused_step=self.step_mode, **common,
            **kw)

    def _shape(self, mel):
        return (mel.shape[0], mel.shape[1], denoised_channels(self.cfg.model))

    def sample_plain(self, mel, pid, hubert, noise: NoiseSource,
                     window: int = 0, cache: Optional[ModelCache] = None,
                     fast=None) -> torch.Tensor:
        """The plain program (every respaced step)."""
        cache = cache if cache is not None else self.build_cache(mel, pid, hubert)
        fast = fast if fast is not None else self.make_fast(mel.shape[1])
        x, _ = self._sample(self._plain, mel, pid, hubert, noise, window,
                            cache, fast)
        return x

    def sample_repaint(self, mel, pid, hubert, gt, noise: NoiseSource,
                       window: int = 0, prev_tails=None,
                       prev_tails_valid=None,
                       cache: Optional[ModelCache] = None, fast=None):
        """The harmonize program with the overlap head pinned toward
        ``gt`` (B, T, C); returns ``(sample, saved_tails)``."""
        cache = cache if cache is not None else self.build_cache(mel, pid, hubert)
        fast = fast if fast is not None else self.make_fast(mel.shape[1])
        return self._sample(self._repaint_prog, mel, pid, hubert, noise,
                            window, cache, fast, repaint=self.spec,
                            gt=gt.to(self.device), prev_saved_tails=prev_tails,
                            prev_tails_valid=prev_tails_valid)

    def generate(self, mel, person_id, noise: NoiseSource, hubert=None,
                 gt_head=None, prev_saved_tails=None, window: int = 0):
        """One window: the plain program, or with ``gt_head`` (B, overlap,
        C) the harmonize program.  Returns the sample, plus the saved
        tails under ``same_overlap_noisy``."""
        if self.cfg.model.add_hubert and hubert is None:
            raise ValueError("model config requires hubert features")
        mel = mel.to(self.device)
        pid = person_id.to(self.device)
        hubert = None if hubert is None else hubert.to(self.device)
        if gt_head is None:
            return self.sample_plain(mel, pid, hubert, noise, window)
        B, T = mel.shape[0], mel.shape[1]
        gt = torch.zeros((B, T, denoised_channels(self.cfg.model)),
                         device=self.device)
        gt[:, :self.cfg.stream.overlap_len] = gt_head.to(self.device)
        x, tails = self.sample_repaint(mel, pid, hubert, gt, noise, window,
                                       prev_saved_tails)
        return (x, tails) if self.cfg.stream.same_overlap_noisy else x

    @property
    def num_model_calls_plain(self) -> int:
        return self._plain.num_model_calls

    @property
    def num_model_calls_repaint(self) -> int:
        return self._harmonize.num_model_calls
