"""EER / biometric score statistics (pyeer-equivalent) + FDR.

The port's own copy of `faceposegenerator_tpu/evaluation/eer.py`
(numpy only: the port imports nothing of the JAX package).

Behavioral rebuild of the vendored pyeer surface the reference drives
(`Evaluation/PyEER_analysis/pyeer_scripts/eer_info.py:160` `get_eer_stats`
and the `Stats` fields consumed by `analyse_pyeer_ID-Booth.py:102-173`):
FMR/FNMR curves over the joint threshold grid, EER (low/high/interpolated),
AUC, FMR@{0, 100, 1000} operating points, score moments, decidability d',
and the Fisher Discriminant Ratio FDR = (gmean−imean)²/(gstd²+istd²)
(`analyse_pyeer_ID-Booth.py:60-61`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class EERStats:
    """Full surface of the vendored `Stats` namedtuple
    (`pyeer_scripts/eer_stats.py:16-62`): rate curves, Youden-J and Matthews
    operating points, FMR- and FNMR-side operating points with thresholds,
    score moments, decidability, EER triple — plus the FDR `pyeer_driver` adds
    (`analyse_pyeer_ID-Booth.py:60-61`)."""

    thrs: np.ndarray
    fmr: np.ndarray
    fnmr: np.ndarray
    auc: float
    eer: float
    eer_low: float
    eer_high: float
    eer_th: float
    j_index: float  # Youden's J = max(1 - fmr - fnmr)
    j_index_th: float
    mccoef: float  # max Matthews correlation coefficient
    mccoef_th: float
    fmr0: float  # FNMR @ FMR≈0
    fmr100: float  # FNMR @ FMR≈1%
    fmr1000: float  # FNMR @ FMR≈0.1%
    fmr20: float  # FNMR @ FMR≈5%
    fmr10: float  # FNMR @ FMR≈10%
    fnmr0: float  # FMR @ FNMR≈0
    fnmr100: float  # FMR @ FNMR≈1%
    fnmr1000: float  # FMR @ FNMR≈0.1%
    fmr0_th: float
    fmr100_th: float
    fmr1000_th: float
    fmr20_th: float
    fmr10_th: float
    fnmr0_th: float
    gmean: float
    gstd: float
    imean: float
    istd: float
    decidability: float
    fdr: float


def get_eer_stats(gen_scores: Sequence[float], imp_scores: Sequence[float]) -> EERStats:
    """Similarity-score convention (higher = more genuine), matching the
    cosine-similarity inputs the reference feeds pyeer."""
    gen = np.sort(np.asarray(gen_scores, np.float64))
    imp = np.sort(np.asarray(imp_scores, np.float64))
    thrs = np.unique(np.concatenate([gen, imp]))

    # FMR: fraction of impostors >= thr; FNMR: fraction of genuines < thr
    fmr = 1.0 - np.searchsorted(imp, thrs, side="left") / len(imp)
    fnmr = np.searchsorted(gen, thrs, side="left") / len(gen)

    diff = fmr - fnmr
    idx = int(np.argmin(np.abs(diff)))
    eer_low = min(fmr[idx], fnmr[idx])
    eer_high = max(fmr[idx], fnmr[idx])
    eer = (fmr[idx] + fnmr[idx]) / 2

    # AUC of the ROC (TAR=1-FNMR vs FMR). Walking thresholds DESCENDING makes
    # both FMR and TAR monotone nondecreasing — the proper ROC staircase
    # (sorting by FMR alone breaks tie ordering and under-integrates).
    # Endpoints (0,·) and (1,1) are covered since thrs spans all scores.
    desc = np.argsort(-thrs)
    roc_fmr = np.concatenate([[0.0], fmr[desc], [1.0]])
    roc_tar = np.concatenate([[0.0], (1.0 - fnmr)[desc], [1.0]])
    auc = float(np.trapezoid(roc_tar, roc_fmr))

    def fmr_op(op):
        """Reference `get_fmr_op` (`eer_stats.py:252-271`): the FNMR at the
        threshold whose FMR is CLOSEST to the operating point."""
        i = int(np.argmin(np.abs(fmr - op)))
        return float(fnmr[i]), float(thrs[i])

    def fnmr_op(op):
        """Reference `get_fnmr_op` (`eer_stats.py:228-249`): the FMR at the
        LAST threshold whose FNMR is closest to the operating point."""
        temp = np.abs(fnmr - op)
        i = int(np.where(temp == temp.min())[0][-1])
        return float(fmr[i]), float(thrs[i])

    # Youden's J (`get_youden_index`, eer_stats.py:349-370)
    j = 1.0 - fnmr - fmr
    j_idx = int(np.argmax(j))

    # max Matthews correlation (`get_matthews_ccoef`, eer_stats.py:373-406)
    gn, im_n = len(gen), len(imp)
    fm_counts = fmr * im_n  # false matches (false positives) per threshold
    fnm_counts = fnmr * gn  # false non-matches (false negatives)
    tn = im_n - fm_counts
    tp = gn - fnm_counts
    num = tp * tn - fm_counts * fnm_counts
    den = (
        np.sqrt(tp + fm_counts) * np.sqrt(tp + fnm_counts)
        * np.sqrt(tn + fm_counts) * np.sqrt(tn + fnm_counts)
    )
    den[den == 0] = 1.0
    all_mcc = num / den
    mcc_idx = int(np.argmax(all_mcc))

    gmean, gstd = float(gen.mean()), float(gen.std())
    imean, istd = float(imp.mean()), float(imp.std())
    denom = np.sqrt(0.5 * (gstd**2 + istd**2))
    decidability = float(abs(gmean - imean) / denom) if denom > 0 else 0.0
    fdr_denom = gstd**2 + istd**2
    fdr = float((gmean - imean) ** 2 / fdr_denom) if fdr_denom > 0 else 0.0

    fmr0, fmr0_th = fmr_op(0.0)
    fmr1000, fmr1000_th = fmr_op(0.001)
    fmr100, fmr100_th = fmr_op(0.01)
    fmr20, fmr20_th = fmr_op(0.05)
    fmr10, fmr10_th = fmr_op(0.1)
    fnmr0, fnmr0_th = fnmr_op(0.0)
    fnmr100, _ = fnmr_op(0.01)
    fnmr1000, _ = fnmr_op(0.001)

    return EERStats(
        thrs=thrs, fmr=fmr, fnmr=fnmr, auc=auc, eer=float(eer),
        eer_low=float(eer_low), eer_high=float(eer_high), eer_th=float(thrs[idx]),
        j_index=float(j[j_idx]), j_index_th=float(thrs[j_idx]),
        mccoef=float(all_mcc[mcc_idx]), mccoef_th=float(thrs[mcc_idx]),
        fmr0=fmr0, fmr100=fmr100, fmr1000=fmr1000, fmr20=fmr20, fmr10=fmr10,
        fnmr0=fnmr0, fnmr100=fnmr100, fnmr1000=fnmr1000,
        fmr0_th=fmr0_th, fmr100_th=fmr100_th, fmr1000_th=fmr1000_th,
        fmr20_th=fmr20_th, fmr10_th=fmr10_th, fnmr0_th=fnmr0_th,
        gmean=gmean, gstd=gstd, imean=imean, istd=istd,
        decidability=decidability, fdr=fdr,
    )


# ---------------------------------------------------------------------------
# CMC (closed-set identification) — `pyeer_scripts/cmc_stats.py`
# ---------------------------------------------------------------------------


def get_cmc_curve(scores: dict, max_rank: int = 20) -> np.ndarray:
    """Cumulative Match Characteristic curve.

    `scores`: {query: (true_templates, candidates)} where `true_templates`
    is a list/set of correct template ids and `candidates` is a list of
    (template_id, score) pairs. Matches the reference `get_cmc_curve`
    (`cmc_stats.py:63-106`): candidates are ranked by DESCENDING similarity,
    rank-r rates accumulate, and the curve saturates at 1.
    Returns (max_rank,) identification rates for ranks 1..max_rank.
    """
    ranks = np.zeros(max_rank + 1)
    n_queries = max(len(scores), 1)
    ordered = {
        q: (set(true), sorted(cands, key=lambda ts: -ts[1]))
        for q, (true, cands) in scores.items()
    }
    for r in range(max_rank):
        in_rank = 0.0
        for true, cands in ordered.values():
            if r < len(cands) and cands[r][0] in true:
                in_rank += 1
        ranks[r + 1] = in_rank / n_queries + ranks[r]
        if ranks[r + 1] >= 1.0:
            ranks[r + 1 :] = 1.0
            break
    return ranks[1:]


def cmc_from_embeddings(
    query_embeds: np.ndarray,
    query_ids: np.ndarray,
    gallery_embeds: np.ndarray,
    gallery_ids: np.ndarray,
    max_rank: int = 20,
) -> np.ndarray:
    """Convenience builder: cosine-rank every query against the gallery and
    produce the CMC curve (rank-r identification rates)."""
    q = np.asarray(query_embeds, np.float64)
    g = np.asarray(gallery_embeds, np.float64)
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    g = g / np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-12)
    sims = q @ g.T  # (Q, G)
    scores = {
        i: (
            [int(query_ids[i])],
            [(int(gallery_ids[j]), float(sims[i, j])) for j in range(len(gallery_ids))],
        )
        for i in range(len(query_ids))
    }
    # template id may repeat in the gallery; group candidates by id keeping
    # the best score per id (closed-set identification convention)
    grouped = {}
    for qy, (true, cands) in scores.items():
        best = {}
        for tid, sc in cands:
            if tid not in best or sc > best[tid]:
                best[tid] = sc
        grouped[qy] = (true, list(best.items()))
    return get_cmc_curve(grouped, max_rank)
