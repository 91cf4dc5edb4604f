"""LFW-bin face-verification protocol (port of
`faceposegenerator_tpu/evaluation/verification.py:26-185`, numpy and PIL as
there: the same embeddings give the same accuracies, bit for bit).

Behavioral rebuild of `FR_training/utils/verification.py`: the `.bin` file
is a pickle of (list of encoded jpeg bytes, issame bool list); each image is
embedded in original and horizontally-flipped form, the two embeddings are
summed and L2-normalized, then verification accuracy is computed by a
10-fold cross-validated threshold sweep over squared-L2 distance in [0, 4),
plus VAL@FAR (reference `load_bin:246`, `test:312`, `evaluate:215`,
`calculate_roc:69`, `calculate_val:148`). JPEG decode uses PIL instead of
mxnet (SURVEY.md §7 stage 9).

The embed function is any callable (B, 112, 112, 3) [-1,1] fp32 numpy →
(B, D), numpy or a tensor (on the card): a chunk's original and flipped
embeddings come back to the host in one copy, and the threshold sweep is
vectorised numpy.
"""

from __future__ import annotations

import io
import pickle
from typing import Callable, Tuple

import numpy as np


def load_bin(path: str, image_size: int = 112) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (N, S, S, 3) uint8, issame (N/2,) bool)."""
    with open(path, "rb") as f:
        bins, issame = pickle.load(f, encoding="bytes")
    from PIL import Image

    imgs = np.zeros((len(bins), image_size, image_size, 3), np.uint8)
    for i, b in enumerate(bins):
        if isinstance(b, np.ndarray) and b.ndim >= 2:
            arr = b  # already-decoded array
        else:
            arr = np.asarray(Image.open(io.BytesIO(bytes(b))).convert("RGB"))
        if arr.shape[0] != image_size:
            arr = np.asarray(
                Image.fromarray(arr).resize((image_size, image_size), Image.BILINEAR)
            )
        imgs[i] = arr
    return imgs, np.asarray(issame, bool)


def embed_with_flip(
    embed_fn: Callable, images: np.ndarray, batch_size: int = 64
) -> Tuple[np.ndarray, float]:
    """Sum of original+flipped embeddings, L2-normalized
    (reference `verification.py:292-343`). Returns (embeddings, xnorm)."""
    n = images.shape[0]
    out = None
    norms = []
    for start in range(0, n, batch_size):
        chunk = images[start : start + batch_size]
        pad = 0
        if chunk.shape[0] < batch_size:
            pad = batch_size - chunk.shape[0]
            chunk = np.concatenate([chunk, np.zeros_like(chunk[:1]).repeat(pad, 0)])
        x = chunk.astype(np.float32) / 255.0
        x = (x - 0.5) / 0.5
        e1, e2 = _host(embed_fn(x), embed_fn(np.ascontiguousarray(x[:, :, ::-1])))
        e = e1 + e2
        if pad:
            e = e[: batch_size - pad]
            e1 = e1[: batch_size - pad]
        if out is None:
            out = np.zeros((n, e.shape[1]), np.float32)
        out[start : start + e.shape[0]] = e
        norms.extend(np.linalg.norm(e1, axis=1).tolist())
    xnorm = float(np.mean(norms))
    out = out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)
    return out, xnorm


def _host(e1, e2):
    """Both embeddings as fp32 numpy; tensors in one device-to-host copy."""
    if hasattr(e1, "detach"):
        import torch

        both = torch.stack([e1.detach().float(), e2.detach().float()]).cpu().numpy()
        return both[0], both[1]
    return np.asarray(e1), np.asarray(e2)


def _fold_indices(n: int, n_folds: int):
    idx = np.arange(n)
    sizes = np.full(n_folds, n // n_folds)
    sizes[: n % n_folds] += 1
    start = 0
    for s in sizes:
        test = idx[start : start + s]
        train = np.concatenate([idx[:start], idx[start + s :]])
        yield train, test
        start += s


def calculate_accuracy(threshold: float, dist: np.ndarray, issame: np.ndarray):
    if dist.size == 0:
        return 0.0, 0.0, 0.0
    pred = dist < threshold
    tp = np.sum(pred & issame)
    fp = np.sum(pred & ~issame)
    tn = np.sum(~pred & ~issame)
    fn = np.sum(~pred & issame)
    tpr = 0.0 if tp + fn == 0 else tp / (tp + fn)
    fpr = 0.0 if fp + tn == 0 else fp / (fp + tn)
    return tpr, fpr, (tp + tn) / dist.size


def calculate_roc(
    thresholds: np.ndarray,
    embeddings1: np.ndarray,
    embeddings2: np.ndarray,
    issame: np.ndarray,
    n_folds: int = 10,
):
    dist = np.sum(np.square(embeddings1 - embeddings2), axis=1)
    n_thr = len(thresholds)
    tprs = np.zeros((n_folds, n_thr))
    fprs = np.zeros((n_folds, n_thr))
    accuracy = np.zeros(n_folds)
    # vectorized: acc[t, pair] over all thresholds at once
    pred = dist[None, :] < thresholds[:, None]  # (T, N)
    correct = pred == issame[None, :]
    for k, (train, test) in enumerate(_fold_indices(len(dist), n_folds)):
        acc_train = correct[:, train].mean(axis=1)
        best = int(np.argmax(acc_train))
        for t in range(n_thr):
            tprs[k, t], fprs[k, t], _ = calculate_accuracy(
                thresholds[t], dist[test], issame[test]
            )
        _, _, accuracy[k] = calculate_accuracy(thresholds[best], dist[test], issame[test])
    return tprs.mean(0), fprs.mean(0), accuracy


def calculate_val(
    thresholds: np.ndarray,
    embeddings1: np.ndarray,
    embeddings2: np.ndarray,
    issame: np.ndarray,
    far_target: float = 1e-3,
    n_folds: int = 10,
):
    """VAL (TAR) at a target FAR with fold-wise threshold calibration."""
    dist = np.sum(np.square(embeddings1 - embeddings2), axis=1)
    val = np.zeros(n_folds)
    far = np.zeros(n_folds)

    def far_at(threshold, d, s):
        pred = d < threshold
        fa = np.sum(pred & ~s)
        n_diff = np.sum(~s)
        return 0.0 if n_diff == 0 else fa / n_diff

    for k, (train, test) in enumerate(_fold_indices(len(dist), n_folds)):
        far_train = np.array([far_at(t, dist[train], issame[train]) for t in thresholds])
        if np.max(far_train) >= far_target:
            threshold = float(np.interp(far_target, far_train, thresholds))
        else:
            threshold = 0.0
        pred = dist[test] < threshold
        ta = np.sum(pred & issame[test])
        n_same = max(np.sum(issame[test]), 1)
        val[k] = ta / n_same
        far[k] = far_at(threshold, dist[test], issame[test])
    return float(val.mean()), float(val.std()), float(far.mean())


def evaluate(embeddings: np.ndarray, issame: np.ndarray, n_folds: int = 10):
    """embeddings interleaved (2N, D): pairs (0,1), (2,3), ..."""
    e1, e2 = embeddings[0::2], embeddings[1::2]
    thresholds = np.arange(0, 4, 0.01)
    n_folds = max(min(n_folds, len(issame)), 2)  # robust to tiny pair sets
    tpr, fpr, accuracy = calculate_roc(thresholds, e1, e2, issame, n_folds)
    val, val_std, far = calculate_val(thresholds, e1, e2, issame, 1e-3, n_folds)
    return tpr, fpr, accuracy, val, val_std, far


def test(
    data: Tuple[np.ndarray, np.ndarray] | str,
    embed_fn: Callable,
    batch_size: int = 64,
    n_folds: int = 10,
):
    """Full protocol on a loaded (images, issame) pair or a .bin path.
    Returns (acc_mean, acc_std, xnorm, val, val_std, far) — the reference's
    `test` surface (`verification.py:312-357`)."""
    if isinstance(data, str):
        data = load_bin(data)
    images, issame = data
    embeddings, xnorm = embed_with_flip(embed_fn, images, batch_size)
    _, _, accuracy, val, val_std, far = evaluate(embeddings, issame, n_folds)
    return float(accuracy.mean()), float(accuracy.std()), xnorm, val, val_std, far
