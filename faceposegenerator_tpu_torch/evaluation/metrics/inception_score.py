"""Inception Score from classifier logits.

The port's own copy of `faceposegenerator_tpu/evaluation/metrics/inception_score.py`
(numpy only: the port imports nothing of the JAX package).

Behavioral rebuild of `Evaluation/dgm-eval/dgm_eval/metrics/inception_score.py`:
IS = exp(E_x[KL(p(y|x) ‖ p(y))]) over `splits` chunks, reported mean±std.
Encoder-agnostic: takes logits from any classifier head.
"""

from __future__ import annotations

import numpy as np


def inception_score_from_logits(logits: np.ndarray, splits: int = 10):
    logits = np.asarray(logits, np.float64)
    ex = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = ex / ex.sum(axis=1, keepdims=True)
    n = probs.shape[0]
    scores = []
    for part in np.array_split(probs, splits):
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = (part * (np.log(part + 1e-16) - np.log(py + 1e-16))).sum(axis=1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))
