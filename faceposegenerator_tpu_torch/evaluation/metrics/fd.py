"""Fréchet distance between representation sets.

The port's own copy of `faceposegenerator_tpu/evaluation/metrics/fd.py`
(numpy only: the port imports nothing of the JAX package).

Behavioral rebuild of `Evaluation/dgm-eval/dgm_eval/metrics/fd.py:6-126`:
FD between Gaussians fitted to (N, D) representation arrays, the
eigenvalue-based evaluation (no scipy sqrtm — faster and jnp-friendly), and
FD-infinity (linear extrapolation of FD vs 1/N to the infinite-sample
limit).
"""

from __future__ import annotations

import numpy as np


def _stats(x: np.ndarray):
    mu = x.mean(axis=0)
    sigma = np.cov(x, rowvar=False)
    return mu, sigma


def frechet_distance(reps_a: np.ndarray, reps_b: np.ndarray, eps: float = 1e-6) -> float:
    """FD via the eigenvalue form: ||μa−μb||² + tr(Σa) + tr(Σb) − 2·Σᵢ√λᵢ
    where λᵢ are eigenvalues of Σa·Σb (the "efficient FD" variant)."""
    mu1, s1 = _stats(np.asarray(reps_a, np.float64))
    mu2, s2 = _stats(np.asarray(reps_b, np.float64))
    diff = mu1 - mu2
    # eigenvalues of s1 @ s2 — symmetrize via sqrt decomposition for stability
    try:
        # λ(Σa Σb) = λ(Aᵀ Σb A) for Σa = A Aᵀ
        w1, v1 = np.linalg.eigh(s1)
        w1 = np.clip(w1, 0, None)
        a = v1 * np.sqrt(w1)[None, :]
        m = a.T @ s2 @ a
        lam = np.linalg.eigvalsh((m + m.T) / 2)
        lam = np.clip(lam, 0, None)
        covmean_tr = float(np.sqrt(lam).sum())
    except np.linalg.LinAlgError:
        covmean_tr = 0.0
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2 * covmean_tr)


def frechet_distance_inf(
    reps_a: np.ndarray,
    reps_b: np.ndarray,
    num_points: int = 15,
    min_batch: int = 5000,
    seed: int = 0,
) -> float:
    """FD∞: fit FD(1/N) linearly over subsample sizes and report the
    intercept (reference `fd.py` FD-infinity path)."""
    rng = np.random.default_rng(seed)
    reps_b = np.asarray(reps_b)
    n = reps_b.shape[0]
    batches = np.linspace(min(min_batch, n // 2 or 1), n, num_points).astype(int)
    fds, invs = [], []
    for b in batches:
        idx = rng.choice(n, b, replace=False)
        fds.append(frechet_distance(reps_a, reps_b[idx]))
        invs.append(1.0 / b)
    coef = np.polyfit(invs, fds, 1)
    return float(coef[1])
