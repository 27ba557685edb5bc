"""Plain reference of one DiffSHEG training step, float32.

The DiffSHEG repository's objective (``trainers/ddpm_beat_trainer.py``,
``gaussian_diffusion.py``): noise the batch at the given timesteps of the
1000-step linear schedule, predict epsilon, and take

    1000 * MSE(eps) + 1 * MSE(velocity of the x0 estimate)
        + 100 * Huber_0.1(x0 estimate * (sem + 1), x0 * (sem + 1));

then clip the gradients to a global L2 norm of ``grad_clip`` (scaled only
when the norm reaches it, optax's rule) and take one Adam step (betas
0.9 / 0.999, eps 1e-8, bias-corrected), written out by hand.
"""

from __future__ import annotations

import numpy as np
import torch


class Tables:
    def __init__(self, num_steps, device):
        betas = np.linspace(1e-4 * 1000 / num_steps, 0.02 * 1000 / num_steps,
                            num_steps, dtype=np.float64)
        acp = np.cumprod(1.0 - betas)

        def t32(a):
            return torch.tensor(a.astype(np.float32), device=device)

        self.sqrt_ab = t32(np.sqrt(acp))
        self.sqrt_1mab = t32(np.sqrt(1.0 - acp))
        self.sqrt_recip = t32(np.sqrt(1.0 / acp))
        self.sqrt_recipm1 = t32(np.sqrt(1.0 / acp - 1.0))


def loss(model, tab, tcfg, batch, t, noise, remat=True):
    x0 = batch["motion"]

    def g(table):
        return table[t][:, None, None]

    xt = g(tab.sqrt_ab) * x0 + g(tab.sqrt_1mab) * noise
    sa = (g(tab.sqrt_recip), g(tab.sqrt_recipm1))
    out = model(xt, t, sa, batch["mel"], batch["pid"], batch["hubert"],
                train=True, remat=remat)
    eps = ((out - noise) ** 2).mean()
    px0 = sa[0] * xt - sa[1] * out
    vel = (((px0[:, :-1] - px0[:, 1:]) - (x0[:, :-1] - x0[:, 1:])) ** 2).mean()
    w = batch["sem"][..., None] + 1.0
    beta = tcfg["huber_beta"]
    d = (px0 * w - x0 * w).abs() / beta
    hub = (torch.where(d < 1.0, 0.5 * d * d, d - 0.5) * beta).mean()
    return (tcfg["eps_weight"] * eps + tcfg["vel_weight"] * vel
            + tcfg["x0_weight"] * hub)


class Adam:
    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.k = 0

    @torch.no_grad()
    def step(self, grads):
        self.k += 1
        c1, c2 = 1 - self.b1 ** self.k, 1 - self.b2 ** self.k
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(self.lr / c1 * m / (v.sqrt() / c2 ** 0.5 + self.eps))


def train_step(model, opt, tab, tcfg, batch, t, noise, remat=True):
    """One step in place; returns (loss, the clipped gradients)."""
    params = opt.params
    for p in params:
        p.grad = None
    total = loss(model, tab, tcfg, batch, t, noise, remat)
    total.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
    if norm >= tcfg["grad_clip"]:
        grads = [g * (tcfg["grad_clip"] / norm).float() for g in grads]
    opt.step(grads)
    return float(total.detach()), grads
