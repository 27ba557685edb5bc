"""Timestep samplers for training.

Counterpart of ``diffsheg_tpu/diffusion/timestep_sampler.py``: uniform
sampling (the default) and loss-second-moment importance sampling, whose
state is a rolling per-timestep history of squared losses.  Draws come
from a caller's ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


def sample_uniform(gen: torch.Generator, batch: int, num_steps: int,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform timesteps and their importance weights (all ones)."""
    t = torch.randint(0, num_steps, (batch,), generator=gen, device=device)
    return t, torch.ones(batch, device=device)


class LossAwareState(NamedTuple):
    """Rolling per-timestep squared-loss history (T, K) float32 and fill
    counts (T,) int32."""

    history: torch.Tensor
    counts: torch.Tensor

    @staticmethod
    def create(num_steps: int, history_per_term: int = 10,
               device=None) -> "LossAwareState":
        return LossAwareState(
            history=torch.zeros(num_steps, history_per_term, device=device),
            counts=torch.zeros(num_steps, dtype=torch.int32, device=device))

    @property
    def warmed_up(self) -> torch.Tensor:
        return (self.counts == self.history.shape[1]).all()


def loss_aware_weights(state: LossAwareState,
                       uniform_prob: float = 0.001) -> torch.Tensor:
    """The sampling distribution over timesteps: p(t) proportional to
    sqrt(E[loss_t^2]), mixed with a uniform floor; uniform until every
    timestep's history is full."""
    T = state.history.shape[0]
    w = torch.sqrt(torch.mean(state.history ** 2, dim=-1))
    w = w / torch.clamp(w.sum(), min=1e-12)
    w = w * (1.0 - uniform_prob) + uniform_prob / T
    uniform = torch.full((T,), 1.0 / T, device=w.device)
    return torch.where(state.warmed_up, w, uniform)


def sample_loss_aware(gen: torch.Generator, batch: int, state: LossAwareState,
                      uniform_prob: float = 0.001
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Importance-sampled timesteps and their 1 / (T p(t)) weights."""
    p = loss_aware_weights(state, uniform_prob)
    t = torch.multinomial(p, batch, replacement=True, generator=gen)
    return t, 1.0 / (p.shape[0] * p[t])


def update_loss_history(state: LossAwareState, t: torch.Tensor,
                        losses: torch.Tensor) -> LossAwareState:
    """Shift each sample's loss into its timestep's history, in batch
    order: a row fills from the front, then runs as a FIFO, so a timestep
    drawn twice in one batch shifts twice.  Sequential over the batch on
    the host (a (T, K) table)."""
    history = state.history.detach().cpu().numpy().copy()
    counts = state.counts.detach().cpu().numpy().copy()
    K = history.shape[1]
    for ti, li in zip(t.detach().cpu().numpy().tolist(),
                      losses.detach().float().cpu().numpy()):
        cnt = counts[ti]
        if cnt == K:
            history[ti, :-1] = history[ti, 1:]
            history[ti, -1] = li
        else:
            history[ti, cnt] = li
        counts[ti] = min(cnt + 1, K)
    dev = state.history.device
    return LossAwareState(torch.from_numpy(history).to(dev),
                          torch.from_numpy(counts).to(dev))
