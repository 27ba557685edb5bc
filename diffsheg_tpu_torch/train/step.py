"""The training step: loss, gradients, clip and Adam.

Counterpart of ``diffsheg_tpu/train/step.py``.  One step noises the batch
at sampled timesteps, runs the model's training forward (BatchNorm
statistics updated in place), takes the diffusion loss and its gradients,
clips them to a global norm (optax's rule: scaled by ``max / norm`` only
when ``norm >= max``), and applies Adam with the learning rate held in
the optimizer (so it is checkpointed and restored).  With the on-device
speech frontend (``audio/frontend.py``) the trainer applies it to the
batch and passes the result to the step, in one eager program: JAX's
separately compiled fused variant has no counterpart here.

Randomness per step comes from the train seed and the step number, not
from a carried generator: the timesteps and the noise from a
``torch.Generator`` seeded from (seed, step), dropout from torch's global
generator seeded from them too inside ``torch.random.fork_rng`` (which
``torch.utils.checkpoint`` replays in a recompute).  A resumed run draws
what the uninterrupted run drew.  ``inject_randoms`` takes the timesteps
and noise of the global batch from the caller instead, as the JAX step
does for parity runs.

Across processes (``parallel/``), each holds an equal share of the global
batch, as the reference's DDP does and as JAX's single-controller step
sees it:
  - the timesteps and noise are drawn for the global batch and each
    process takes its rows, so N processes draw what one process draws;
    the step hands its rows to the training forward as ``train`` (a
    ``models/blocks.py::GlobalBatch``), whose dropout masks, classifier-free
    null rows and BatchNorm statistics follow the global batch too;
  - the gradients are averaged across processes before the clip, so the
    clip sees the global norm: one ``all_reduce`` of the flattened
    gradients, or under ``fully_shard`` its reduce-scatter, the norm then
    summed over the shards;
  - the loss-aware sampler's history takes the gathered (t, loss) of the
    whole global batch, and the returned loss terms are global means.
One process keeps the one-process computation.

With ``model.compute_dtype='bfloat16'`` the step casts the f32 master
weights to bf16 inside the graph (``torch.func.functional_call``; under
``fully_shard`` its mixed-precision policy does), so autograd returns f32
gradients to them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from diffsheg_tpu_torch.config import Config, check_variance_coupling
from diffsheg_tpu_torch.device import torch_dtype
from diffsheg_tpu_torch.diffusion.losses import LossTerms, diffusion_loss
from diffsheg_tpu_torch.diffusion.sampler import split_model_output
from diffsheg_tpu_torch.diffusion.schedule import DiffusionSchedule, gather
from diffsheg_tpu_torch.diffusion.timestep_sampler import (
    LossAwareState, sample_loss_aware, sample_uniform, update_loss_history)
from diffsheg_tpu_torch.models.blocks import GlobalBatch
from diffsheg_tpu_torch.models.factory import ablate_inputs
from diffsheg_tpu_torch.parallel.collectives import (gather_rows, global_rows,
                                                     mean_across_processes_,
                                                     process_count,
                                                     sum_across_processes)
from diffsheg_tpu_torch.parallel.mesh import is_fsdp


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics), the Adam
    optimizer (moments, step counts, learning rate), the step count and
    the loss-aware sampler's history (None for the uniform sampler)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Adam
    t_state: Optional[LossAwareState] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    """Adam(lr = ``train.lr``, betas 0.9 / 0.999, eps 1e-8), optax's
    ``adam`` defaults; the global-norm clip is
    :func:`clip_grad_global_norm_`."""
    return torch.optim.Adam(params, lr=cfg.train.lr, betas=(0.9, 0.999),
                            eps=1e-8)


def clip_grad_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: every gradient scaled by ``max_norm
    / norm`` when the global L2 norm reaches ``max_norm``, untouched below
    it (``torch.nn.utils.clip_grad_norm_`` scales by ``max / (norm +
    1e-6)`` whenever it is below 1).  Returns the norm."""
    norm = torch.nn.utils.get_total_norm(grads, 2.0)
    sharded = hasattr(norm, "full_tensor")
    if sharded:     # fully_shard's gradients: the squares of every shard
        norm = norm.full_tensor()
    keep = norm < max_norm
    for g in grads:
        if sharded:
            g = g.to_local()
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def average_gradients_(grads) -> None:
    """Every process's gradients replaced by their mean over the
    processes: one ``all_reduce`` of the flattened gradients."""
    flat = mean_across_processes_(torch.cat([g.reshape(-1) for g in grads]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def reset_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Overwrite the restored learning rate (``train.reset_lr``)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def current_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def create_train_state(cfg: Config, model: nn.Module, device=None,
                       mesh=None) -> TrainState:
    """The model in f32 on ``device`` (its own device by default), a
    fresh optimizer, step 0, and an empty loss history for the
    'loss-second-moment' sampler.  With a ``mesh`` (``parallel/mesh.py``)
    the parameters, and so the Adam moments, are sharded over its ``fsdp``
    dimension (``fully_shard``)."""
    model = model.to(device=device, dtype=torch.float32)
    dev = next(model.parameters()).device
    t_state = None
    if cfg.train.timestep_sampler == "loss-second-moment":
        t_state = LossAwareState.create(cfg.diffusion.num_steps, device=dev)
    elif cfg.train.timestep_sampler != "uniform":
        raise ValueError(f"train.timestep_sampler="
                         f"{cfg.train.timestep_sampler!r}: valid samplers "
                         "are 'uniform', 'loss-second-moment'")
    if mesh is not None:
        from diffsheg_tpu_torch.parallel.mesh import shard_params_fsdp
        shard_params_fsdp(mesh, model, torch_dtype(cfg.model.compute_dtype))
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model.parameters()),
                      t_state=t_state)


def step_seeds(seed: int, step: int) -> Tuple[int, int]:
    """Two 64-bit seeds for step ``step`` of a run seeded ``seed``: the
    timesteps and noise, and dropout."""
    a, b = np.random.SeedSequence([seed, step]).generate_state(2, np.uint64)
    return int(a), int(b)


def make_train_step(cfg: Config, sched: DiffusionSchedule,
                    vel_loss_active: bool = True,
                    inject_randoms: bool = False):
    """The step ``step(state, batch) -> (state, terms)``, which updates
    ``state`` in place; with ``inject_randoms``, ``step(state, batch, t,
    noise)`` with the caller's timesteps (G,) and noise (G, T, C) of the
    global batch of G rows (this process's batch with one process).

    Batch fields (this process's rows, tensors on the state's device):
    ``motion`` (B, T, C), ``mel`` (B, T, A), ``pid`` (B, S), and as the
    config needs them ``hubert`` (B, T, hubert_dim), ``sem`` (B, T),
    ``exp_cond`` (B, T, expression_dim), ``word`` / ``emo`` (B, T) labels."""
    check_variance_coupling(cfg)
    mcfg = cfg.model
    compute = torch_dtype(mcfg.compute_dtype)
    use_loss_aware = cfg.train.timestep_sampler == "loss-second-moment"

    def forward(model, *args, **kw):
        if compute == torch.float32 or is_fsdp(model):
            return model(*args, **kw)
        params = {n: p.to(compute) for n, p in model.named_parameters()}
        return torch.func.functional_call(model, params, args, kw)

    def loss_fn(model, batch, t, noise, t_weights, rows):
        x_start = batch["motion"]
        x_t = sched.q_sample(x_start, t, noise)
        sqrt_alphas = (gather(sched.sqrt_recip_alphas_cumprod, t, x_start),
                       gather(sched.sqrt_recipm1_alphas_cumprod, t, x_start))
        mel, pid = ablate_inputs(mcfg, batch["mel"], batch["pid"])
        extra = {}
        if mcfg.branch_mode == "exp_condition_gesture":
            extra["exp_cond"] = batch["exp_cond"]
        if mcfg.add_text_cond:
            extra["word"] = batch["word"]
        if mcfg.add_emo_cond:
            extra["emo"] = batch["emo"]
        out = forward(model, x_t, t, sqrt_alphas, mel, pid,
                      hubert=batch.get("hubert"), train=rows, **extra)
        out, var_out = split_model_output(out, cfg.diffusion.var_type)
        terms = diffusion_loss(
            sched, out, x_start, x_t, t, noise, cfg.train,
            sem_score=batch.get("sem"), vel_loss_active=vel_loss_active,
            t_weights=t_weights if use_loss_aware else None,
            var_out=var_out, var_type=cfg.diffusion.var_type,
            mean_type=cfg.diffusion.mean_type)
        # the per-sample eps loss feeds the loss-aware sampler's history
        per_sample = ((out - noise) ** 2).mean(dim=(1, 2))
        return terms, per_sample

    def global_draw(x, total, rows, what):
        if x.shape[0] != total:
            raise ValueError(f"injected {what}: {x.shape[0]} rows, the "
                             f"global batch has {total}")
        return x[rows]

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                t_in: Optional[torch.Tensor] = None,
                noise_in: Optional[torch.Tensor] = None
                ) -> Tuple[TrainState, LossTerms]:
        model, dev = state.model, state.device
        motion = batch["motion"]
        B = motion.shape[0]
        first, total = global_rows(B)
        rows = slice(first, first + B)
        seed_tn, seed_drop = step_seeds(cfg.train.seed, state.step)
        gen = torch.Generator(device=dev).manual_seed(seed_tn)
        if t_in is not None:
            t = global_draw(t_in.to(dev), total, rows, "timesteps")
            t_weights = torch.ones(B, device=dev)
        else:
            if use_loss_aware:
                t, t_weights = sample_loss_aware(gen, total, state.t_state)
            else:
                t, t_weights = sample_uniform(gen, total, sched.num_steps,
                                              dev)
            t, t_weights = t[rows], t_weights[rows]
        noise = (global_draw(noise_in.to(dev), total, rows, "noise")
                 if noise_in is not None else
                 torch.randn((total,) + motion.shape[1:], generator=gen,
                             device=dev)[rows])

        params = list(model.parameters())
        for p in params:
            p.grad = None
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda"
                                   else []):
            torch.manual_seed(seed_drop)
            terms, per_sample = loss_fn(
                model, batch, t, noise, t_weights,
                GlobalBatch(first, total, process_count(),
                            sum_across_processes))
            terms.total.backward()
        # a parameter the loss does not reach (the null condition of a
        # decoder model) gets a zero gradient, and Adam still moves it
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        n = process_count()
        if n > 1 and not is_fsdp(model):
            average_gradients_(grads)
        clip_grad_global_norm_(grads, cfg.train.grad_clip)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        if use_loss_aware:
            state.t_state = update_loss_history(
                state.t_state, gather_rows(t), gather_rows(per_sample))
        state.step += 1
        terms = LossTerms(*(v.detach() for v in terms))
        if n > 1:
            terms = LossTerms(*mean_across_processes_(
                torch.stack(list(terms)).double()).float())
        return state, terms

    if inject_randoms:
        def injected(state, batch, t, noise):
            return step_fn(state, batch, t_in=t, noise_in=noise)
        return injected
    return step_fn
