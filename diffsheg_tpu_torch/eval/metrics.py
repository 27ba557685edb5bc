"""Evaluation metrics: FGD / Frechet, MSE, PCK, SRGR, diversity,
multimodality, R-precision, beat alignment.

The port's own copy of ``diffsheg_tpu/eval/metrics.py`` (numpy and scipy,
host side): the Frechet distance between Gaussians fitted to two sets of
activations (through symmetric eigendecompositions; scipy's ``sqrtm``
path beside it), MSE and PCK over joints of three channels, SRGR, the
diversity of groups of samples, multimodality, pairwise distances and
R-precision, kinematic beats and their alignment with audio onsets.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
from scipy import linalg as _scipy_linalg


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


def frechet_distance_scipy(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """The reference's path through scipy.linalg.sqrtm (reference
    utils/metrics.py:95-146), with its singular-product retry on an
    ``eps`` diagonal offset, which small samples reach."""
    diff = np.atleast_1d(mu1) - np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    with warnings.catch_warnings():     # SciPy >= 1.16 deprecates disp
        warnings.simplefilter("ignore", DeprecationWarning)
        covmean, _ = _scipy_linalg.sqrtm(sigma1 @ sigma2, disp=False)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _scipy_linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


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


def srgr(outputs: np.ndarray, targets: np.ndarray,
         semantic: np.ndarray, threshold: float = 0.3,
         avg_weight: float | None = None) -> float:
    """SRGR, Semantic-Relevant Gesture Recall (the BEAT benchmark's third
    metric beside FGD and beat alignment): per-frame, per-joint recall —
    a joint is recalled when the L1 distance over its 3 rotation channels
    is under ``threshold`` — weighted by the frame's semantic score:

        SRGR = mean_{t,j} 1[ ||pred_{t,j} - gt_{t,j}||_1 < threshold ] * w_t

    with ``w_t = sem_t / avg_weight``.  The BEAT harness fixes
    ``avg_weight`` to its test split's mean weight, 0.165; ``None``
    normalizes by the mean of the given semantic track (plain recall on
    an unannotated clip).

    outputs / targets: (T, C) pose channels, C divisible by 3; semantic:
    (T,) per-frame scores (``data/beat.py::semantic_scores_per_frame``).
    """
    outputs = np.asarray(outputs, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.float64)
    semantic = np.asarray(semantic, dtype=np.float64).reshape(-1)
    T, C = outputs.shape
    if C % 3 or targets.shape != outputs.shape or semantic.shape[0] != T:
        raise ValueError(f"SRGR needs (T, 3J) outputs and targets of one "
                         f"shape and (T,) scores: {outputs.shape}, "
                         f"{targets.shape}, {semantic.shape}")
    diff = np.abs(outputs - targets).reshape(T, C // 3, 3).sum(axis=-1)
    recalled = (diff < threshold).astype(np.float64)
    if avg_weight is None:
        avg_weight = float(semantic.mean())
        if avg_weight <= 0.0:
            return float(recalled.mean())
    return float((recalled * (semantic / avg_weight)[:, None]).mean())


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


def multimodality(activation: np.ndarray, times: int, rng=None) -> float:
    """Mean distance between two random subsets of ``times`` rows
    (reference utils/metrics.py:84-92)."""
    rng = np.random.RandomState(0) if rng is None else rng
    n = activation.shape[0]
    i1 = rng.choice(n, times, replace=False)
    i2 = rng.choice(n, times, replace=False)
    return float(np.linalg.norm(activation[i1] - activation[i2], axis=1).mean())


def euclidean_distance_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, D), (M, D) -> (N, M) pairwise L2 through ||a||^2 - 2ab +
    ||b||^2 (reference utils/metrics.py:6-20)."""
    d2 = (np.sum(a * a, axis=1)[:, None] - 2.0 * a @ b.T
          + np.sum(b * b, axis=1)[None])
    return np.sqrt(np.clip(d2, 0.0, None))


def r_precision(embedding1: np.ndarray, embedding2: np.ndarray,
                top_k: int = 3) -> np.ndarray:
    """The share of rows whose matching column ranks within the top 1, 2,
    ..., k (reference utils/metrics.py:22-45)."""
    dist = euclidean_distance_matrix(embedding1, embedding2)
    ranks = np.argsort(dist, axis=1)[:, :top_k]
    hit = ranks == np.arange(len(embedding1))[:, None]
    return hit.cumsum(axis=1).astype(bool).mean(axis=0)


def kinematic_beats(motion: np.ndarray, order: int = 7) -> np.ndarray:
    """Kinematic-beat frame indices: the local minima of the joint speed,
    strictly below every neighbour within ``order`` frames (scipy's
    ``argrelextrema(vel, np.less, order)``, the BEAT harness's rule at
    order 7).  ``vel[i]`` is the speed between frames i and i + 1; the
    index returned is the velocity's."""
    from scipy.signal import argrelextrema

    vel = np.linalg.norm(np.diff(motion, axis=0), axis=1)
    return argrelextrema(vel, np.less, order=order)[0]


def beat_alignment(motion: np.ndarray, audio_beats: np.ndarray,
                   fps: float, sigma: float = 0.3, order: int = 7) -> float:
    """BeatAlign: the mean, over kinematic beats, of a Gaussian kernel
    (sigma 0.3 s) on the distance to the nearest audio beat (Li et al.
    2021, the BEAT protocol).  motion: (T, C) pose channels; audio_beats:
    onset times in seconds (``audio/onsets.py``)."""
    kin = kinematic_beats(motion, order=order)
    if len(kin) == 0 or len(audio_beats) == 0:
        return 0.0
    kin_times = kin / fps
    d = np.abs(kin_times[:, None] - np.asarray(audio_beats)[None, :]
               ).min(axis=1)
    return float(np.exp(-(d ** 2) / (2.0 * sigma ** 2)).mean())
