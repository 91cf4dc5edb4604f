"""Vendi score (eigen-entropy diversity) — per-dataset and per-class.

The port's own copy of `faceposegenerator_tpu/evaluation/metrics/vendi.py`
(numpy only: the port imports nothing of the JAX package).

Behavioral rebuild of `Evaluation/dgm-eval/dgm_eval/metrics/vendi.py:8-44`:
Vendi = exp(−Σ λᵢ log λᵢ) over eigenvalues of the normalized cosine-
similarity Gram matrix X Xᵀ / n; the per-class variant averages over label
groups (used for the per-identity diversity tables, SURVEY.md §2.4).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def vendi_score(features: np.ndarray, normalize: bool = True) -> float:
    x = np.asarray(features, np.float64)
    if normalize:
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    n = x.shape[0]
    if n == 0:
        return 0.0
    # eigenvalues of K/n via the (smaller of) gram/covariance trick
    if n <= x.shape[1]:
        s = np.linalg.eigvalsh(x @ x.T / n)
    else:
        s = np.linalg.eigvalsh(x.T @ x / n)
    s = np.clip(s, 0, None)
    s = s[s > 1e-12]
    ent = -np.sum(s * np.log(s))
    return float(np.exp(ent))


def per_class_vendi(features: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    labels = np.asarray(labels)
    scores = {}
    for lbl in np.unique(labels):
        scores[str(lbl)] = vendi_score(features[labels == lbl])
    vals = np.array(list(scores.values()))
    return {"mean_vendi": float(vals.mean()), "per_class": scores}
