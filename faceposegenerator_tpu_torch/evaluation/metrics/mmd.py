"""Polynomial-kernel MMD² / Kernel Distance (KID).

The port's own copy of `faceposegenerator_tpu/evaluation/metrics/mmd.py`
(numpy only: the port imports nothing of the JAX package).

Behavioral rebuild of `Evaluation/dgm-eval/dgm_eval/metrics/mmd.py`: the
standard KID estimator — unbiased MMD² with kernel
k(x, y) = (xᵀy/D + 1)³ averaged over `n_subsets` random subsets of size
`subset_size` (reference operating point 100×1000, SURVEY.md §2.4).
"""

from __future__ import annotations

import numpy as np


def _poly_kernel(x: np.ndarray, y: np.ndarray, degree=3, gamma=None, coef0=1.0):
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (x @ y.T * gamma + coef0) ** degree


def mmd2_polynomial(x: np.ndarray, y: np.ndarray) -> float:
    """Unbiased MMD² with the cubic polynomial kernel."""
    m, n = x.shape[0], y.shape[0]
    kxx = _poly_kernel(x, x)
    kyy = _poly_kernel(y, y)
    kxy = _poly_kernel(x, y)
    sum_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
    sum_xy = kxy.mean()
    return float(sum_xx + sum_yy - 2 * sum_xy)


def kernel_distance(
    reps_real: np.ndarray,
    reps_gen: np.ndarray,
    n_subsets: int = 100,
    subset_size: int = 1000,
    seed: int = 0,
):
    """KID mean±std over random subsets (reference 100 subsets of ≤1000)."""
    rng = np.random.default_rng(seed)
    x, y = np.asarray(reps_real, np.float64), np.asarray(reps_gen, np.float64)
    m = min(subset_size, x.shape[0], y.shape[0])
    vals = []
    for _ in range(n_subsets):
        xi = x[rng.choice(x.shape[0], m, replace=False)]
        yi = y[rng.choice(y.shape[0], m, replace=False)]
        vals.append(mmd2_polynomial(xi, yi))
    return float(np.mean(vals)), float(np.std(vals))
