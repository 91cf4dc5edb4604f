"""Genuine/impostor pair building over identity-grouped embeddings.

The port's own copy of `faceposegenerator_tpu/evaluation/pairs.py`
(numpy only: the port imports nothing of the JAX package).

Behavioral rebuild of the reference pair builders (SURVEY.md §2.4):
  - AmongSynth (`genuine_and_impostor_AmongSynth.py:34-94`): genuine = all
    intra-identity pairs; impostor = cross-identity pairs subsampled with a
    `samples_skip` stride; identities with fewer than `min_samples` images
    are dropped (defaults 8 / 18).
  - SynthVsReal (`genuine_and_imposter_SynthVsReal.py:34-98`): genuine =
    synth×real same identity; impostor = synth×real different identity with
    stride `samples_skip` (default 17).

The reference fans cosine similarities out over multiprocessing pools
(`:158-186`); here scores come from one (normalized) matmul.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _normalize(x):
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def cosine_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _normalize(a) @ _normalize(b).T


def among_synth_pairs(
    embeds_by_id: Dict[str, np.ndarray],
    min_samples: int = 8,
    samples_skip: int = 18,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (genuine_scores, impostor_scores)."""
    ids = [k for k, v in sorted(embeds_by_id.items()) if len(v) >= min_samples]
    genuine: List[float] = []
    impostor: List[float] = []
    for i, ida in enumerate(ids):
        ea = embeds_by_id[ida]
        sims = cosine_matrix(ea, ea)
        iu = np.triu_indices(len(ea), k=1)
        genuine.extend(sims[iu].tolist())
        for idb in ids[i + 1 :]:
            eb = embeds_by_id[idb]
            cross = cosine_matrix(ea, eb).ravel()
            impostor.extend(cross[:: samples_skip + 1].tolist())
    return np.asarray(genuine), np.asarray(impostor)


def synth_vs_real_pairs(
    synth_by_id: Dict[str, np.ndarray],
    real_by_id: Dict[str, np.ndarray],
    samples_skip: int = 17,
) -> Tuple[np.ndarray, np.ndarray]:
    ids = sorted(set(synth_by_id) & set(real_by_id))
    genuine: List[float] = []
    impostor: List[float] = []
    for ida in ids:
        s = synth_by_id[ida]
        genuine.extend(cosine_matrix(s, real_by_id[ida]).ravel().tolist())
        for idb in ids:
            if idb == ida:
                continue
            cross = cosine_matrix(s, real_by_id[idb]).ravel()
            impostor.extend(cross[:: samples_skip + 1].tolist())
    return np.asarray(genuine), np.asarray(impostor)


def group_by_identity(embeddings: np.ndarray, names: List[str]) -> Dict[str, np.ndarray]:
    """Group flat `<id>_<img>` files by the identity prefix — the FR label
    convention (`utils/detect_align_crop_data.py:122,249-251`)."""
    groups: Dict[str, List[int]] = {}
    for i, n in enumerate(names):
        key = n.split("_")[0]
        groups.setdefault(key, []).append(i)
    return {k: embeddings[v] for k, v in groups.items()}
