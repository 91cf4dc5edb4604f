"""AuthPct — percentage of authentic (non-memorised) generated samples.

The port's own copy of `faceposegenerator_tpu/evaluation/metrics/authpct.py`
(numpy, and `prdc.pairwise_distances` on a device; the port imports nothing
of the JAX package).

Behavioral rebuild of `Evaluation/dgm-eval/dgm_eval/metrics/authpct.py:4-23`:
a generated sample is *inauthentic* (a likely training-copy) when it sits
closer to its nearest real sample than that real sample's own nearest real
neighbour; AuthPct is the share of generated samples that are not such
copies.
"""

from __future__ import annotations

import numpy as np

from .prdc import pairwise_distances


def authpct(real_features: np.ndarray, gen_features: np.ndarray, device=None) -> float:
    d_rr = pairwise_distances(real_features, real_features, device=device)
    np.fill_diagonal(d_rr, np.inf)
    real_nn = d_rr.min(axis=1)  # (Nr,) each real's nearest-real distance

    d_rg = pairwise_distances(real_features, gen_features, device=device)  # (Nr, Ng)
    nearest_real = d_rg.argmin(axis=0)  # (Ng,)
    d_to_nearest = d_rg.min(axis=0)

    authentic = d_to_nearest > real_nn[nearest_real]
    return float(100.0 * authentic.mean())
