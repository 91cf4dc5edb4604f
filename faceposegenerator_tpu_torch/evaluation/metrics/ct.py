"""C_T data-copying score (Meehan et al. three-sample test).

The port's own copy of `faceposegenerator_tpu/evaluation/metrics/ct.py`
(numpy, and `prdc.pairwise_distances` on a device; the port imports nothing
of the JAX package).

Behavioral rebuild of `Evaluation/dgm-eval/dgm_eval/metrics/ct.py` (the
layer6ai variant of the data-copying statistic): within each cell of an
instance-space partition (k-means over train features), compare the
distances gen→train against test→train with a Mann-Whitney U statistic;
aggregate the per-cell z-scores weighted by cell mass. Negative C_T ⇒ the
generator copies training data; ≈0 ⇒ calibrated; positive ⇒ underfitting.
Also exposes the "mem" (fraction of strongly-copying cells) and "mode"
(cells where the generator places too little mass) variants.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _mannwhitney_z(x: np.ndarray, y: np.ndarray) -> float:
    """z-scored U statistic for H0: P(x < y) = 0.5 (normal approximation)."""
    n, m = len(x), len(y)
    if n == 0 or m == 0:
        return 0.0
    ranks = np.argsort(np.argsort(np.concatenate([x, y]))) + 1
    u = ranks[:n].sum() - n * (n + 1) / 2
    mean_u = n * m / 2
    std_u = np.sqrt(n * m * (n + m + 1) / 12.0)
    return float((u - mean_u) / max(std_u, 1e-12))


def _kmeans(x: np.ndarray, k: int, iters: int = 25, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), min(k, len(x)), replace=False)]
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for j in range(len(centers)):
            pts = x[assign == j]
            if len(pts):
                centers[j] = pts.mean(0)
    return centers


def _nn_dist(a: np.ndarray, b: np.ndarray, device=None) -> np.ndarray:
    """distance from each row of `a` to its nearest neighbour in `b`."""
    from .prdc import pairwise_distances

    return pairwise_distances(a, b, device=device).min(axis=1)


def ct_score(
    train: np.ndarray,
    test: np.ndarray,
    gen: np.ndarray,
    num_cells: int = 3,
    tau: float = 20 / 1000,
    seed: int = 0,
    device=None,
) -> Dict[str, float]:
    """Returns {"ct": weighted z, "ct_mem": copying-cell fraction,
    "ct_mode": over/under-represented cell count}. The nearest-neighbour
    distances run on `device` (`prdc.pairwise_distances`)."""
    train = np.asarray(train, np.float64)
    test = np.asarray(test, np.float64)
    gen = np.asarray(gen, np.float64)
    centers = _kmeans(train, num_cells, seed=seed)

    def assign(x):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        return d.argmin(1)

    a_test, a_gen = assign(test), assign(gen)
    zs, weights = [], []
    n_copy_cells, n_mode_cells = 0, 0
    for c in range(len(centers)):
        in_test = test[a_test == c]
        in_gen = gen[a_gen == c]
        pi_test = len(in_test) / max(len(test), 1)
        pi_gen = len(in_gen) / max(len(gen), 1)
        if pi_gen < tau or len(in_test) == 0 or len(in_gen) == 0:
            if pi_test >= tau:
                n_mode_cells += 1  # generator under-covers this cell
            continue
        d_gen = _nn_dist(in_gen, train, device)
        d_test = _nn_dist(in_test, train, device)
        z = _mannwhitney_z(d_gen, d_test)
        zs.append(z)
        weights.append(pi_test)
        if z < -3.0:
            n_copy_cells += 1
    if not zs:
        return {"ct": 0.0, "ct_mem": 0.0, "ct_mode": float(n_mode_cells)}
    zs, weights = np.asarray(zs), np.asarray(weights)
    ct = float((zs * weights).sum() / weights.sum())
    return {
        "ct": ct,
        "ct_mem": float(n_copy_cells / len(zs)),
        "ct_mode": float(n_mode_cells),
    }
