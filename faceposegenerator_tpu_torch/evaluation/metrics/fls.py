"""Feature Likelihood Score (FLS) and FLS-overfit.

The port's own copy of `faceposegenerator_tpu/evaluation/metrics/fls.py`
(numpy only: the port imports nothing of the JAX package).

Behavioral rebuild of `Evaluation/dgm-eval/dgm_eval/metrics/fls.py` (the
Jiralerspong et al. feature-likelihood divergence): model the generated
features as a mixture of isotropic Gaussians centred at each generated
sample, fit per-centre bandwidths by maximising the likelihood of the
*train* set, then score the likelihood of the held-out *test* set —
penalising both poor fidelity and memorisation. FLS-overfit compares train
vs test likelihoods under the fitted mixture (positive gap ⇒ overfit to
train / copying).

Scores are reported like the reference: FLS as a percentage-style value
(higher = better), computed in normalized feature space.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _log_gauss_mixture(x: np.ndarray, centers: np.ndarray, log_sigma2: np.ndarray) -> np.ndarray:
    """log p(x) under (1/M)·Σ_j N(x; c_j, σ_j² I). Returns (N,) log-likelihoods."""
    d = x.shape[1]
    # squared distances (N, M)
    d2 = (
        (x**2).sum(1)[:, None] + (centers**2).sum(1)[None, :] - 2 * x @ centers.T
    )
    log_norm = -0.5 * d * (np.log(2 * np.pi) + log_sigma2)[None, :]
    log_kernel = -0.5 * d2 / np.exp(log_sigma2)[None, :]
    comp = log_norm + log_kernel - np.log(centers.shape[0])
    m = comp.max(axis=1, keepdims=True)
    return (m[:, 0] + np.log(np.exp(comp - m).sum(axis=1)))


def _fit_bandwidths(
    train: np.ndarray, centers: np.ndarray, iters: int = 50, lr: float = 0.5
) -> np.ndarray:
    """Per-centre log σ² fitted by (simple) gradient ascent of train LL via
    an EM-flavoured update: σ_j² ← weighted mean of distances of train
    points softly assigned to centre j."""
    d = train.shape[1]
    d2 = (
        (train**2).sum(1)[:, None] + (centers**2).sum(1)[None, :] - 2 * train @ centers.T
    )
    log_sigma2 = np.full(centers.shape[0], np.log(np.median(d2) / d + 1e-12))
    for _ in range(iters):
        log_norm = -0.5 * d * log_sigma2[None, :]
        comp = log_norm - 0.5 * d2 / np.exp(log_sigma2)[None, :]
        comp -= comp.max(axis=1, keepdims=True)
        resp = np.exp(comp)
        resp /= resp.sum(axis=1, keepdims=True)  # (N, M) soft assignment
        mass = resp.sum(axis=0) + 1e-8
        new_sigma2 = (resp * d2).sum(axis=0) / (mass * d) + 1e-12
        log_sigma2 = (1 - lr) * log_sigma2 + lr * np.log(new_sigma2)
    return log_sigma2


def fls(
    train: np.ndarray,
    test: np.ndarray,
    gen: np.ndarray,
    normalize: bool = True,
) -> Dict[str, float]:
    train = np.asarray(train, np.float64)
    test = np.asarray(test, np.float64)
    gen = np.asarray(gen, np.float64)
    if normalize:
        mu = train.mean(0)
        sd = train.std(0) + 1e-8
        train, test, gen = (train - mu) / sd, (test - mu) / sd, (gen - mu) / sd

    log_sigma2 = _fit_bandwidths(train, gen)
    d = train.shape[1]
    ll_test = _log_gauss_mixture(test, gen, log_sigma2).mean() / d
    ll_train = _log_gauss_mixture(train, gen, log_sigma2).mean() / d
    # reference-style affine presentation: higher is better, per-dim nats
    return {
        "fls": float(100.0 + 10.0 * ll_test),
        "fls_overfit": float(10.0 * (ll_train - ll_test)),
    }
