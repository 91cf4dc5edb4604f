"""Identity consistency / separability analysis (PyEER driver).

The port's own copy of `faceposegenerator_tpu/evaluation/pyeer_driver.py`
(numpy only: the port imports nothing of the JAX package).

Behavioral rebuild of `Evaluation/PyEER_analysis/analyse_pyeer_ID-Booth.py`:
for each (model-variant, config) pair build genuine/impostor cosine scores
— AmongSynth (intra vs cross identity within synthetic data) and
SynthVsReal (synthetic×real same/different identity) — compute EER stats +
FDR, save a JSON report and a score-distribution histogram plot
(`:60-61,102-173`), plus pyeer-style CSV/JSON report writers
(`pyeer_scripts/report` surface).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np

from .eer import EERStats, get_eer_stats
from .pairs import among_synth_pairs, group_by_identity, synth_vs_real_pairs


def stats_to_dict(st: EERStats) -> Dict:
    d = dataclasses.asdict(st)
    d.pop("thrs"), d.pop("fmr"), d.pop("fnmr")
    return {k: float(v) for k, v in d.items()}


def save_histogram(gen: np.ndarray, imp: np.ndarray, path: str, bins: int = 100):
    """Score-distribution histogram (matplotlib if present, else npz)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist(imp, bins=bins, alpha=0.6, density=True, label="impostor")
        ax.hist(gen, bins=bins, alpha=0.6, density=True, label="genuine")
        ax.set_xlabel("cosine similarity")
        ax.legend()
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
    except ImportError:
        np.savez(os.path.splitext(path)[0] + ".npz", genuine=gen, impostor=imp)


def analyse(
    synth_by_id: Dict[str, np.ndarray],
    real_by_id: Optional[Dict[str, np.ndarray]] = None,
    output_dir: Optional[str] = None,
    name: str = "run",
    min_samples: int = 8,
    skip_among: int = 18,
    skip_vs_real: int = 17,
) -> Dict:
    """Run both configs; returns {config: stats dict} and writes JSON+plots."""
    results: Dict = {}
    full_stats: Dict[str, EERStats] = {}

    gen, imp = among_synth_pairs(synth_by_id, min_samples=min_samples, samples_skip=skip_among)
    if len(gen) and len(imp):
        st = get_eer_stats(gen, imp)
        results["AmongSynth"] = stats_to_dict(st)
        full_stats["AmongSynth"] = st
        if output_dir:
            save_histogram(gen, imp, os.path.join(output_dir, f"{name}_AmongSynth_hist.png"))

    if real_by_id is not None:
        gen, imp = synth_vs_real_pairs(synth_by_id, real_by_id, samples_skip=skip_vs_real)
        if len(gen) and len(imp):
            st = get_eer_stats(gen, imp)
            results["SynthVsReal"] = stats_to_dict(st)
            full_stats["SynthVsReal"] = st
            if output_dir:
                save_histogram(gen, imp, os.path.join(output_dir, f"{name}_SynthVsReal_hist.png"))

    if output_dir and full_stats:
        # DET/ROC curves across configs (pyeer `plot_eer_stats` surface)
        from .analysis import plot_det, plot_roc

        plot_det(full_stats, os.path.join(output_dir, f"{name}_det.png"))
        plot_roc(full_stats, os.path.join(output_dir, f"{name}_roc.png"))

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, f"{name}_pyeer.json"), "w") as f:
            json.dump(results, f, indent=2)
        write_csv_report(results, os.path.join(output_dir, f"{name}_pyeer.csv"))
        write_html_report(results, os.path.join(output_dir, f"{name}_pyeer.html"))
        write_tex_report(results, os.path.join(output_dir, f"{name}_pyeer.tex"))
    return results


# pyeer's report column order/names (`pyeer_scripts/report.py:585-591`
# `generate_csv_eer_report`), mapped to EERStats field names; our extra
# fields (FDR, the FNMR-side operating points) append after.
_PYEER_COLUMNS = [
    ("GMean", "gmean"), ("GSTD", "gstd"), ("IMean", "imean"), ("ISTD", "istd"),
    ("Sensitivity index (d')", "decidability"), ("AUC", "auc"),
    ("J-Index", "j_index"), ("J-Index_TH", "j_index_th"),
    ("MCC", "mccoef"), ("MCC_TH", "mccoef_th"),
    ("EERlow", "eer_low"), ("EERhigh", "eer_high"), ("EER", "eer"),
    ("ZeroFMR", "fmr0"), ("FMR1000", "fmr1000"), ("FMR100", "fmr100"),
    ("FMR20", "fmr20"), ("FMR10", "fmr10"), ("ZeroFNMR", "fnmr0"),
    ("EER_TH", "eer_th"), ("ZeroFMR_TH", "fmr0_th"),
    ("FMR1000_TH", "fmr1000_th"), ("FMR100_TH", "fmr100_th"),
    ("FMR20_TH", "fmr20_th"), ("FMR10_TH", "fmr10_th"),
    ("ZeroFNMR_TH", "fnmr0_th"),
]


def _report_columns(stats: Dict) -> list:
    """(header, field) pairs: pyeer's columns first, then any extra fields
    the stats dict carries (fdr, fnmr100, ...)."""
    cols = [(h, k) for h, k in _PYEER_COLUMNS if k in stats]
    known = {k for _, k in cols}
    cols += [(k.upper(), k) for k in sorted(stats) if k not in known]
    return cols


def write_csv_report(results: Dict, path: str):
    """pyeer-layout CSV report (`generate_csv_eer_report`): one row per
    experiment under the reference's exact column header."""
    if not results:
        return
    cols = _report_columns(next(iter(results.values())))
    with open(path, "w") as f:
        f.write("Experiment ID," + ",".join(h for h, _ in cols) + "\n")
        for cfg_name, stats in results.items():
            f.write(cfg_name + "," + ",".join(f"{stats[k]:.6f}" for _, k in cols) + "\n")


def write_html_report(results: Dict, path: str, title: str = "EER report"):
    """pyeer-style HTML report (`generate_html_eer_report` surface): one
    stats table per experiment under the reference's column names."""
    if not results:
        return
    cols = _report_columns(next(iter(results.values())))
    rows = "".join(
        "<tr><td>{}</td>{}</tr>".format(
            name, "".join(f"<td>{stats[k]:.6f}</td>" for _, k in cols)
        )
        for name, stats in results.items()
    )
    html = (
        f"<html><head><title>{title}</title></head><body><h1>{title}</h1>"
        "<table border='1'><tr><th>Experiment ID</th>"
        + "".join(f"<th>{h}</th>" for h, _ in cols)
        + f"</tr>{rows}</table></body></html>"
    )
    with open(path, "w") as f:
        f.write(html)


def write_tex_report(results: Dict, path: str):
    """LaTeX table writer (the reference's notebook emits mean±std tables)."""
    if not results:
        return
    keys = sorted(next(iter(results.values())).keys())
    lines = [
        "\\begin{tabular}{l" + "r" * len(keys) + "}",
        "config & " + " & ".join(k.replace("_", "\\_") for k in keys) + " \\\\ \\hline",
    ]
    for name, stats in results.items():
        lines.append(
            name.replace("_", "\\_")
            + " & "
            + " & ".join(f"{stats[k]:.4f}" for k in keys)
            + " \\\\"
        )
    lines.append("\\end{tabular}")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def analyse_from_embedding_files(
    synth_embeds: np.ndarray,
    synth_names,
    real_embeds: Optional[np.ndarray] = None,
    real_names=None,
    **kw,
) -> Dict:
    """Convenience: group flat `<id>_<img>` embedding arrays by identity
    (the `save_emb_2_id` convention, `create_boundary_data.py:24-63`)."""
    synth_by_id = group_by_identity(synth_embeds, list(synth_names))
    real_by_id = (
        group_by_identity(real_embeds, list(real_names)) if real_embeds is not None else None
    )
    return analyse(synth_by_id, real_by_id, **kw)
