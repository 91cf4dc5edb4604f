"""The port's dgm-eval metrics and PyEER identity analysis against the JAX
package's, on seeded features. The numpy metrics (FD, FD∞, KD, Vendi,
per-class Vendi, SW, FLS, IS) are the same arithmetic: within 1e-6 relative.
Those built on the distance matrix (PRDC, AuthPct, C_T) compare the port's
torch matrix (fp32 on the CPU here) with JAX's jitted CPU one: the matrices
within 1e-5 of their max, PRDC's four numbers and AuthPct equal (no two
distances of these features lie within a rounding of each other), realism
and C_T within 1e-6 relative. EER statistics, pair scores and the report
files (JSON, CSV, HTML, TeX) equal; the plots written by both."""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from faceposegenerator_tpu.evaluation import analysis as janalysis
from faceposegenerator_tpu.evaluation import eer as jeer
from faceposegenerator_tpu.evaluation import metrics as jm
from faceposegenerator_tpu.evaluation import pairs as jpairs
from faceposegenerator_tpu.evaluation import pyeer_driver as jpyeer
from faceposegenerator_tpu_torch.evaluation import analysis, eer, metrics, pairs, pyeer_driver

# the packages' __init__ re-export `prdc` the function over `prdc` the module
jct, jprdc = (importlib.import_module(f"faceposegenerator_tpu.evaluation.metrics.{m}") for m in ("ct", "prdc"))
ct, prdc = (importlib.import_module(f"faceposegenerator_tpu_torch.evaluation.metrics.{m}") for m in ("ct", "prdc"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(0)
    real = rng.standard_normal((80, 12)).astype(np.float32)
    gen = (rng.standard_normal((70, 12)) * 1.1 + 0.2).astype(np.float32)
    test = rng.standard_normal((60, 12)).astype(np.float32)
    labels = np.repeat(np.arange(5), 14)
    return real, gen, test, labels


def _rel(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30), (got, want)


def test_numpy_metrics_match_jax(feats):
    real, gen, test, labels = feats
    _rel(metrics.frechet_distance(real, gen), jm.frechet_distance(real, gen))
    _rel(metrics.frechet_distance_inf(real, gen, num_points=5, seed=1),
         jm.frechet_distance_inf(real, gen, num_points=5, seed=1))
    _rel(metrics.kernel_distance(real, gen, n_subsets=10, seed=2), jm.kernel_distance(real, gen, n_subsets=10, seed=2))
    _rel(metrics.vendi_score(gen), jm.vendi_score(gen))
    got, want = metrics.per_class_vendi(gen, labels), jm.per_class_vendi(gen, labels)
    assert got["per_class"].keys() == want["per_class"].keys()
    _rel(list(got["per_class"].values()), list(want["per_class"].values()))
    _rel(metrics.sliced_wasserstein(real, gen, seed=3), jm.sliced_wasserstein(real, gen, seed=3))
    got, want = metrics.fls(real, test, gen), jm.fls(real, test, gen)
    assert got.keys() == want.keys()
    _rel([got[k] for k in want], [want[k] for k in want])
    logits = np.random.default_rng(4).standard_normal((50, 10))
    _rel(metrics.inception_score_from_logits(logits, splits=5), jm.inception_score_from_logits(logits, splits=5))


def test_distance_metrics_match_jax(feats):
    real, gen, test, _ = feats
    d = prdc.pairwise_distances(real, gen, block=32, device="cpu")
    want = jprdc.pairwise_distances(real, gen, block=32)
    assert d.dtype == np.float32 and d.shape == (80, 70)
    assert np.abs(d - want).max() <= 1e-5 * np.abs(want).max()
    got = prdc.prdc(real, gen, nearest_k=5, realism=True, device="cpu")
    want = jprdc.prdc(real, gen, nearest_k=5, realism=True)
    for k in ("precision", "recall", "density", "coverage"):
        assert got[k] == want[k], k
    _rel(got["realism"], want["realism"])
    assert metrics.authpct(real, gen, device="cpu") == jm.authpct(real, gen)
    got, want = ct.ct_score(real, test, gen, device="cpu"), jct.ct_score(real, test, gen)
    assert got.keys() == want.keys()
    _rel([got[k] for k in want], [want[k] for k in want])


def _by_id(seed, ids=6, per=10, dim=16):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((ids, dim))
    return {f"id{i}": (centres[i] + 0.6 * rng.standard_normal((per, dim))).astype(np.float32) for i in range(ids)}


def test_eer_and_pairs_match_jax():
    synth, real = _by_id(5), _by_id(6, per=4)
    got, want = pairs.among_synth_pairs(synth, min_samples=4), jpairs.among_synth_pairs(synth, min_samples=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    gen, imp = pairs.synth_vs_real_pairs(synth, real)
    np.testing.assert_array_equal(imp, jpairs.synth_vs_real_pairs(synth, real)[1])
    st, jst = eer.get_eer_stats(gen, imp), jeer.get_eer_stats(gen, imp)
    assert pyeer_driver.stats_to_dict(st) == jpyeer.stats_to_dict(jst)
    q, g = np.arange(12) % 6, np.arange(24) % 6
    emb = np.random.default_rng(7).standard_normal((36, 8))
    np.testing.assert_array_equal(eer.cmc_from_embeddings(emb[:12], q, emb[12:], g, max_rank=5),
                                  jeer.cmc_from_embeddings(emb[:12], q, emb[12:], g, max_rank=5))


def test_pyeer_analyse_matches_jax(tmp_path):
    """Both configurations, their report files equal; the histograms and the
    DET/ROC plots written (matplotlib is installed here)."""
    synth, real = _by_id(8), _by_id(9, per=4)
    kw = dict(min_samples=4, skip_among=3, skip_vs_real=2, name="run")
    got = pyeer_driver.analyse(synth, real, output_dir=str(tmp_path / "port"), **kw)
    want = jpyeer.analyse(synth, real, **kw)  # JAX's files from its own writers, without its plots
    assert set(got) == {"AmongSynth", "SynthVsReal"} and got == want
    os.makedirs(tmp_path / "jax")
    with open(tmp_path / "jax" / "run_pyeer.json", "w") as f:
        json.dump(want, f, indent=2)
    for ext, write in (("csv", jpyeer.write_csv_report), ("html", jpyeer.write_html_report),
                       ("tex", jpyeer.write_tex_report)):
        write(want, str(tmp_path / "jax" / f"run_pyeer.{ext}"))
    for ext in ("pyeer.json", "pyeer.csv", "pyeer.html", "pyeer.tex"):
        assert (tmp_path / "port" / f"run_{ext}").read_text() == (tmp_path / "jax" / f"run_{ext}").read_text(), ext
    assert json.loads((tmp_path / "port" / "run_pyeer.json").read_text()) == got
    for png in ("run_AmongSynth_hist.png", "run_SynthVsReal_hist.png", "run_det.png", "run_roc.png"):
        assert (tmp_path / "port" / png).stat().st_size > 0, png


def test_analysis_plots_and_tables(tmp_path):
    synth = _by_id(10)
    gen, imp = pairs.among_synth_pairs(synth, min_samples=4)
    stats = {"a": eer.get_eer_stats(gen, imp)}
    out = str(tmp_path)
    # ROC and DET come with test_pyeer_analyse_matches_jax
    analysis.plot_distributions({"gen": gen, "imp": imp}, os.path.join(out, "dist.png"))
    analysis.plot_cmc({"a": np.linspace(0.5, 1.0, 5)}, os.path.join(out, "cmc.png"))
    analysis.plot_score_histogram(gen, imp, stats["a"].eer_th, os.path.join(out, "hist.png"))
    for name in ("dist", "cmc", "hist"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0, name
    rows = {"m1": {"fd": [1.0, 2.0, 3.0]}, "m2": {"fd": [2.0, 4.0]}}
    assert analysis.mean_std_latex_table(rows, ["fd", "kd"]) == janalysis.mean_std_latex_table(rows, ["fd", "kd"])
    logs = tmp_path / "scalars.jsonl"
    logs.write_text("".join(json.dumps({"step": i, "loss": 1.0 / (i + 1)}) + "\n" for i in range(5)))
    assert analysis.plot_training_logs(str(logs), out, name="t") == janalysis.plot_training_logs(
        str(logs), str(tmp_path / "j"), name="t")
