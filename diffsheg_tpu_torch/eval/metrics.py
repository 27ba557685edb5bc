"""Evaluation metrics: Frechet distance, MSE, PCK, diversity.

The port's own copy of the part of ``diffsheg_tpu/eval/metrics.py`` that
training's evaluation uses (numpy only): the Frechet distance between
Gaussians fitted to two sets of activations (through symmetric
eigendecompositions), MSE and PCK over joints of three channels, and the
diversity of groups of samples.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def activation_statistics(activations: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Mean + covariance of (N, D) latents ."""
    activations = np.asarray(activations, dtype=np.float64)
    mu = activations.mean(axis=0)
    cov = np.cov(activations, rowvar=False)
    return mu, cov


def _sqrtm_psd(a: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Matrix square root via symmetric eigendecomposition.

    ``a = s1 @ s2`` with both covariance factors PSD is similar to a PSD
    matrix, so we symmetrize the eigenproblem: sqrt(s1 s2) =
    s1^{1/2} (s1^{1/2} s2 s1^{1/2})^{1/2} s1^{-1/2} has the same trace as
    sqrt of the symmetrized product, and only the trace enters the distance.
    """
    a = (a + a.T) / 2.0
    vals, vecs = np.linalg.eigh(a)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians (reference utils/metrics.py:95-146
    and datasets/data_tools.py:417-475).

    Uses the trace identity Tr sqrt(S1 S2) = Tr sqrt(S1^{1/2} S2 S1^{1/2}),
    which keeps everything in real symmetric eigendecompositions (no complex
    drift, unlike generic ``sqrtm`` on the nonsymmetric product).
    """
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError("the two Gaussians have different dimensions")

    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1)
    inner = s1_half @ sigma2 @ s1_half
    tr_covmean = np.trace(_sqrtm_psd(inner))

    if not np.isfinite(tr_covmean):
        offset = np.eye(sigma1.shape[0]) * eps
        s1_half = _sqrtm_psd(sigma1 + offset)
        tr_covmean = np.trace(_sqrtm_psd(s1_half @ (sigma2 + offset) @ s1_half))

    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * tr_covmean)


def frechet_from_activations(gen: np.ndarray, real: np.ndarray) -> float:
    mu1, s1 = activation_statistics(gen)
    mu2, s2 = activation_statistics(real)
    return frechet_distance(mu1, s1, mu2, s2)


def mse_pck(outputs: np.ndarray, targets: np.ndarray,
            pck_threshold: float = 0.5) -> Tuple[float, float]:
    """Mean squared error + PCK over (B, T, J, 3) joint tensors
    (reference ddpm_beat_trainer.py:591-598): a 'joint' is a consecutive
    3-channel group; PCK counts joints whose L2 error is under threshold."""
    diff_sq = (outputs - targets) ** 2
    dist = np.sqrt(diff_sq.sum(axis=-1))
    return float(diff_sq.mean()), float((dist < pck_threshold).mean())


def mse_pck_channels(outputs: np.ndarray, targets: np.ndarray,
                     pck_threshold: float = 0.5) -> Tuple[float, float]:
    """(B, T, C) channel tensors: groups consecutive channel triplets as
    joints when C divides by 3; otherwise scores PCK per channel (needed for
    SHOW's 232-d motion, which mixes axis-angle with expression PCs)."""
    C = outputs.shape[-1]
    if C % 3 == 0:
        sh = outputs.shape[:-1] + (C // 3, 3)
        return mse_pck(outputs.reshape(sh), targets.reshape(sh),
                       pck_threshold)
    diff_sq = (outputs - targets) ** 2
    return (float(diff_sq.mean()),
            float((np.abs(outputs - targets) < pck_threshold).mean()))


def diversity(outputs: np.ndarray, batch: int = 50) -> float:
    """Mean absolute difference over all ordered pairs inside groups of
    ``batch`` samples (Ye et al. ECCV'22 protocol; reference
    ddpm_beat_trainer.py:600-614).  Vectorized: sum over the (b, b) pairwise
    table instead of the reference's O(b^2) Python loop."""
    B = outputs.shape[0]
    b = min(batch, B)
    total, count = 0.0, 0
    for start in range(0, B - b + 1, b):
        grp = outputs[start:start + b].reshape(b, -1)
        # pairwise mean-|diff| matrix via broadcasting, i<j pairs only
        d = np.abs(grp[:, None, :] - grp[None, :, :]).mean(axis=-1)
        pair_sum = np.triu(d, k=1).sum()
        total += pair_sum * 2.0 / (b * (b - 1))
        count += 1
    return float(total / max(count, 1))
