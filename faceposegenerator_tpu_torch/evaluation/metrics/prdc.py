"""Precision / Recall / Density / Coverage (+ realism) (port of
`faceposegenerator_tpu/evaluation/metrics/prdc.py`).

Behavioral rebuild of `Evaluation/dgm-eval/dgm_eval/metrics/prdc.py:56-114`
(the layer6ai vendored PRDC): kNN-radius manifold estimates with k=5 by
default. The O(N²) distance matrix is computed blockwise on a device, as the
JAX package computes it outside any kernel: fp32, TF32 off for the GEMM
(`torch.matmul`), blocks of 4096 copied back to host numpy. The radii and
comparisons that follow are numpy, as in JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...core.device import resolve_device


class _no_tf32:
    """The distance GEMM in full fp32 on the card, whatever the caller's
    setting; restored on exit."""

    def __enter__(self):
        self.before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.before


def pairwise_distances(a: np.ndarray, b: np.ndarray, block: int = 4096, device=None) -> np.ndarray:
    """Euclidean distance matrix (N, M) in fp32, ‖x‖² + ‖y‖² − 2·x·yᵀ
    clamped at 0 then square-rooted, blockwise on `device` (the card unless
    told "cpu")."""
    device = resolve_device(device)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    out = np.zeros((a.shape[0], b.shape[0]), np.float32)
    with torch.no_grad(), _no_tf32():
        for i in range(0, a.shape[0], block):
            x = torch.from_numpy(a[i : i + block]).to(device)
            x2 = torch.sum(x * x, dim=1, keepdim=True)
            for j in range(0, b.shape[0], block):
                y = torch.from_numpy(b[j : j + block]).to(device)
                d2 = x2 + torch.sum(y * y, dim=1, keepdim=True).T - 2 * torch.matmul(x, y.T)
                out[i : i + block, j : j + block] = torch.sqrt(torch.clamp_min(d2, 0.0)).cpu().numpy()
    return out


def _kth_radius(dist: np.ndarray, k: int) -> np.ndarray:
    """Distance to the k-th nearest neighbour (excluding self on the
    diagonal, which is distance 0 and occupies rank 0)."""
    return np.partition(dist, k, axis=1)[:, k]


def prdc(
    real_features: np.ndarray,
    fake_features: np.ndarray,
    nearest_k: int = 5,
    realism: bool = False,
    device=None,
) -> Dict[str, float]:
    real = np.asarray(real_features, np.float32)
    fake = np.asarray(fake_features, np.float32)
    # kth-neighbour needs k < n (self occupies rank 0)
    nearest_k = max(1, min(nearest_k, real.shape[0] - 1, fake.shape[0] - 1))

    d_rr = pairwise_distances(real, real, device=device)
    d_ff = pairwise_distances(fake, fake, device=device)
    d_rf = pairwise_distances(real, fake, device=device)

    r_real = _kth_radius(d_rr, nearest_k)  # (Nr,)
    r_fake = _kth_radius(d_ff, nearest_k)  # (Nf,)

    precision = float((d_rf < r_real[:, None]).any(axis=0).mean())
    recall = float((d_rf < r_fake[None, :]).any(axis=1).mean())
    density = float((1.0 / nearest_k) * (d_rf < r_real[:, None]).sum(axis=0).mean())
    coverage = float((d_rf.min(axis=1) < r_real).mean())

    out = {"precision": precision, "recall": recall, "density": density, "coverage": coverage}
    if realism:
        # per-fake max over real of r_real/d with median-filtered radii —
        # returns the PER-SAMPLE vector like the reference
        # (`dgm_eval/metrics/prdc.py:104-110`), not an aggregate
        mask = r_real < np.median(r_real)
        ratios = r_real[mask, None] / np.maximum(d_rf[mask, :], 1e-12)
        out["realism"] = ratios.max(axis=0)
    return out
