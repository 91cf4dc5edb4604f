"""Analysis plots & tables (matplotlib-gated, npz fallback).

The port's own copy of `faceposegenerator_tpu/evaluation/analysis.py`
(numpy only: the port imports nothing of the JAX package).

Behavioral rebuild of the reference's analysis extras (SURVEY.md §2.4:
`Evaluation/PyEER_analysis/analysis_scripts/` distribution/log plots and the
pose notebook's KDE plots + LaTeX tables): per-dataset score/pose
distribution plots, DET/ROC curves from EER stats, and mean±std LaTeX table
emission.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from .eer import EERStats


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_roc(stats: Dict[str, EERStats], path: str):
    """ROC curves (TAR vs FMR, log x) for several runs on one axis."""
    try:
        plt = _plt()
    except ImportError:
        np.savez(
            os.path.splitext(path)[0] + ".npz",
            **{f"{k}_fmr": s.fmr for k, s in stats.items()},
            **{f"{k}_fnmr": s.fnmr for k, s in stats.items()},
        )
        return
    fig, ax = plt.subplots(figsize=(6, 5))
    for name, s in stats.items():
        order = np.argsort(s.fmr)
        ax.plot(np.maximum(s.fmr[order], 1e-6), 1 - s.fnmr[order], label=f"{name} (EER {s.eer:.3f})")
    ax.set_xscale("log")
    ax.set_xlabel("FMR")
    ax.set_ylabel("TAR (1-FNMR)")
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def plot_det(stats: Dict[str, EERStats], path: str):
    """DET curves (FNMR vs FMR, log-log)."""
    try:
        plt = _plt()
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(6, 5))
    for name, s in stats.items():
        order = np.argsort(s.fmr)
        ax.plot(np.maximum(s.fmr[order], 1e-6), np.maximum(s.fnmr[order], 1e-6), label=name)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("FMR")
    ax.set_ylabel("FNMR")
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def plot_distributions(series: Dict[str, np.ndarray], path: str, bins: int = 60, xlabel: str = ""):
    """Overlaid density histograms (the reference's score/pose KDE plots)."""
    try:
        plt = _plt()
    except ImportError:
        np.savez(os.path.splitext(path)[0] + ".npz", **series)
        return
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, values in series.items():
        ax.hist(np.asarray(values).ravel(), bins=bins, density=True, alpha=0.5, label=name)
    ax.set_xlabel(xlabel)
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def mean_std_latex_table(
    rows: Dict[str, Dict[str, Sequence[float]]],
    columns: Sequence[str],
    path: Optional[str] = None,
) -> str:
    """Pose-notebook-style mean±std LaTeX table: rows = {run: {col: values}}."""
    lines = [
        "\\begin{tabular}{l" + "c" * len(columns) + "}",
        " & " + " & ".join(columns) + " \\\\ \\hline",
    ]
    for name, cols in rows.items():
        cells = []
        for c in columns:
            v = np.asarray(cols.get(c, []), np.float64)
            cells.append(f"${v.mean():.2f} \\pm {v.std():.2f}$" if v.size else "--")
        lines.append(name.replace("_", "\\_") + " & " + " & ".join(cells) + " \\\\")
    lines.append("\\end{tabular}")
    out = "\n".join(lines)
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(out)
    return out


def plot_cmc(curves: Dict[str, np.ndarray], path: str):
    """CMC curves (identification rate vs rank) — `plot_cmc_stats`
    (`pyeer_scripts/plot.py:369`)."""
    try:
        plt = _plt()
    except ImportError:
        np.savez(os.path.splitext(path)[0] + ".npz", **curves)
        return
    fig, ax = plt.subplots(figsize=(6, 5))
    for name, curve in curves.items():
        ranks = np.arange(1, len(curve) + 1)
        ax.plot(ranks, curve, marker="o", markersize=3, label=name)
    ax.set_xlabel("Rank")
    ax.set_ylabel("Identification rate")
    ax.set_ylim(0, 1.02)
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


# ---------------------------------------------------------------------------
# Dataset distribution analysis (`analysis_scripts/analyse_dataset.py` +
# `plot_distributions.py` live parts — VERDICT r3 #5)
# ---------------------------------------------------------------------------


def load_embeddings_per_id(path: str, num_ids: int = 0, num_imgs: int = 0):
    """Per-identity embedding loader mirroring `analyse_dataset.py:24-44`
    `load_embeddings`: sorted file order, optional id/image truncation.
    Accepts three layouts: a dir of per-id `.npy` arrays (each (n, d) — the
    reference layout), a dir of per-id SUBDIRS of single-embedding `.npy`
    files, or a flat dir of `<id>_<img>.npy` files (the `save_emb_2_id`
    convention the repo's extractor writes). Returns a list of (n_i, d)
    arrays, one per identity, in sorted identity order."""
    entries = sorted(os.listdir(path))
    per_id = []
    npy = [e for e in entries if e.endswith(".npy")]
    subdirs = [e for e in entries if os.path.isdir(os.path.join(path, e))]
    if subdirs:
        for d in subdirs:
            files = sorted(
                f for f in os.listdir(os.path.join(path, d)) if f.endswith(".npy")
            )
            embs = [np.load(os.path.join(path, d, f)) for f in files]
            if embs:
                per_id.append(np.stack([e.reshape(-1) for e in embs]))
    elif npy and "_" in npy[0] and np.load(os.path.join(path, npy[0])).ndim == 1:
        groups: Dict[str, list] = {}
        for f in npy:  # flat <id>_<img>.npy
            ident = f.rsplit("_", 1)[0]
            groups.setdefault(ident, []).append(np.load(os.path.join(path, f)))
        per_id = [np.stack(groups[k]) for k in sorted(groups)]
    else:
        per_id = [np.atleast_2d(np.load(os.path.join(path, f))) for f in npy]
    if num_ids:
        per_id = per_id[:num_ids]
    if num_imgs:
        per_id = [e[:num_imgs] for e in per_id]
    return per_id


def split_gen_imp_scores(per_id, rng: Optional[np.random.Generator] = None):
    """Genuine/impostor cosine scores with the reference's sampling
    convention (`analyse_dataset.py:46-92` `split_gen_imp`): ALL intra-id
    pairs are genuine; impostors subsample — reference ids p+1, p+9, ...
    (stride 8), min(4, n) random images on each side. Returns
    (gen_scores, imp_scores) float64 arrays."""
    rng = rng or np.random.default_rng(0)
    norm = [
        e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
        for e in (np.asarray(e, np.float64) for e in per_id)
    ]
    gen, imp = [], []
    n_ids = len(norm)
    for p in range(n_ids):
        e = norm[p]
        sims = e @ e.T
        iu = np.triu_indices(len(e), k=1)
        gen.extend(sims[iu])
        k1 = min(len(e), 4)
        for ref_idx in range(p + 1, n_ids, 8):
            r = norm[ref_idx]
            k2 = min(len(r), 4)
            i1 = rng.choice(len(e), k1, replace=False)
            i2 = rng.choice(len(r), k2, replace=False)
            imp.extend((e[i1] @ r[i2].T).ravel())
    return np.asarray(gen), np.asarray(imp)


def plot_score_histogram(gen, imp, eer_th: float, path: str, bins: int = 100):
    """Genuine/impostor probability histogram with the EER-threshold line
    (`plot_distributions.py:25-49` `plot_score_histogram` semantics —
    probability-normalized bins over [-1, 1], vertical operating line)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    kw = dict(bins=bins, range=(-1, 1), density=False)
    for series, label, color in ((gen, "Genuine", "#64a0d9"),
                                 (imp, "Imposter", "#d99d64")):
        weights = np.full(len(series), 1.0 / max(len(series), 1))
        ax.hist(series, weights=weights, alpha=0.65, label=label,
                color=color, **kw)
    ax.axvline(x=eer_th, c="#EC6500", label="EER threshold")
    ax.set_xlabel("Cosine Similarity")
    ax.set_ylabel("Probability")
    ax.legend(loc="upper left")
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def dataset_distribution_report(
    embeds_dir: str,
    output_dir: str,
    name: str = "dataset",
    num_ids: int = 0,
    num_imgs: int = 0,
    seed: int = 0,
) -> Dict:
    """One-call equivalent of `analyse_dataset.py`'s distribution analysis:
    load per-id embeddings, build gen/imp scores, compute the full EER
    stats, and write <name>_hist.png + <name>_scores.npz +
    <name>_stats.json under `output_dir`. Returns the stats dict."""
    import json

    from .eer import get_eer_stats
    from .pyeer_driver import stats_to_dict

    per_id = load_embeddings_per_id(embeds_dir, num_ids=num_ids, num_imgs=num_imgs)
    if len(per_id) < 2:
        raise ValueError(f"need >=2 identities in {embeds_dir}, got {len(per_id)}")
    gen, imp = split_gen_imp_scores(per_id, np.random.default_rng(seed))
    st = get_eer_stats(gen, imp)
    os.makedirs(output_dir, exist_ok=True)
    np.savez(os.path.join(output_dir, f"{name}_scores.npz"), genuine=gen, impostor=imp)
    try:
        plot_score_histogram(
            gen, imp, st.eer_th, os.path.join(output_dir, f"{name}_hist.png")
        )
    except ImportError:
        pass  # matplotlib-less deployment: the .npz carries the data
    out = {
        "n_identities": len(per_id),
        "n_genuine": int(len(gen)),
        "n_impostor": int(len(imp)),
        **stats_to_dict(st),
    }
    with open(os.path.join(output_dir, f"{name}_stats.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


def plot_training_logs(
    jsonl_path: str,
    output_dir: str,
    metrics: Optional[Sequence[str]] = None,
    name: str = "logs",
) -> Dict:
    """Training-curve plots from a `core.trackers` scalars.jsonl
    (`analysis_scripts/plot_logs.py` equivalent for this stack's log
    format): one PNG per metric vs step. Returns {metric: n_points}."""
    import json

    records = []
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    if not records:
        raise ValueError(f"no records in {jsonl_path}")
    keys = metrics or sorted(
        {k for r in records for k in r if k not in ("step", "time")}
    )
    os.makedirs(output_dir, exist_ok=True)
    counts = {}
    plt = _plt()
    for k in keys:
        pts = [(r["step"], r[k]) for r in records if k in r]
        counts[k] = len(pts)
        if not pts:
            continue
        steps, vals = zip(*pts)
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(steps, vals)
        ax.set_xlabel("step")
        ax.set_ylabel(k)
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        fig.savefig(os.path.join(output_dir, f"{name}_{k.replace('/', '_')}.png"))
        plt.close(fig)
    return counts
