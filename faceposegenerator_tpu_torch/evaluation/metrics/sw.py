"""Sliced-Wasserstein distance approximation.

The port's own copy of `faceposegenerator_tpu/evaluation/metrics/sw.py`
(numpy only: the port imports nothing of the JAX package).

Behavioral rebuild of `Evaluation/dgm-eval/dgm_eval/metrics/sw.py:3-14`:
project both representation sets onto random unit directions, compute the
1-D Wasserstein-2 between sorted projections, average over projections.
"""

from __future__ import annotations

import numpy as np


def sliced_wasserstein(
    x: np.ndarray, y: np.ndarray, n_proj: int = 128, seed: int = 0
) -> float:
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    d = x.shape[1]
    n = min(x.shape[0], y.shape[0])
    dirs = rng.standard_normal((d, n_proj))
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True)
    px = np.sort(x @ dirs, axis=0)
    py = np.sort(y @ dirs, axis=0)
    # equalize sample counts by quantile interpolation
    if px.shape[0] != n:
        q = np.linspace(0, 1, n)
        px = np.stack([np.interp(q, np.linspace(0, 1, px.shape[0]), px[:, i]) for i in range(n_proj)], 1)
    if py.shape[0] != n:
        q = np.linspace(0, 1, n)
        py = np.stack([np.interp(q, np.linspace(0, 1, py.shape[0]), py[:, i]) for i in range(n_proj)], 1)
    return float(np.sqrt(np.mean((px - py) ** 2)))
