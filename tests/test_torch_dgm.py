"""The port's dgm-eval driver against the JAX package's, on the CPU: file
order and labels equal; `compute_representations` with the `pixel` encoder
equal, its nsample + 2000 subsample the same files, its `.npz` cache under
JAX's file name and read back bit-equal; `compute_scores` and `main` (pixel;
and a tiny registered DINOv2 with `--heatmaps`) within 1e-6 relative of
JAX's scores (realism 1e-5; the tiny ViT's within 2e-4, its PRDC counts
equal). GradCAM and `make_heatmap_fn` are in test_torch_heatmaps.py."""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.evaluation import dgm as jdgm
from faceposegenerator_tpu.models import dinov2 as jdino
from faceposegenerator_tpu_torch.bridge.jax_params import load_jax_params
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.evaluation import dgm
from faceposegenerator_tpu_torch.models import dinov2
from test_torch_eval_vits import numpy_init

CPU = torch.device("cpu")
METRICS = ["fd", "fd_infinity", "kd", "prdc", "realism", "vendi", "authpct", "sw", "ct", "fls"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _write_tree(root, folders, per, size, seed, int_names=False):
    rng = np.random.default_rng(seed)
    for f in range(folders):
        d = os.path.join(root, f"cls{f}")
        os.makedirs(d, exist_ok=True)
        tint = rng.uniform(0, 255, 3)
        for i in range(per):
            low = rng.uniform(0, 255, (4, 4, 3)) * 0.5 + tint * 0.5
            img = Image.fromarray(low.astype(np.uint8)).resize((size, size), Image.BILINEAR)
            name = f"{(i * 7) % (per + 3) + 1}.png" if int_names else f"img{i}.png"
            img.save(os.path.join(d, name))
    return root


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("dgm")
    return {"real": _write_tree(str(root / "real"), 3, 14, 40, 0),
            "gen": _write_tree(str(root / "gen"), 3, 14, 40, 1, int_names=True),
            "test": _write_tree(str(root / "test"), 2, 12, 40, 2)}


def _same_scores(got: dict, want: dict, rel=1e-6):
    """Within `rel` of JAX's; realism (r / d per sample over fp32 distances
    from two matmul orders) within 1e-5."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        tol = max(rel, 1e-5) if k == "realism" else rel
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-12), (k, g, w)


@pytest.fixture(autouse=True)
def small_pixels(monkeypatch):
    """The `pixel` encoder at 4² (48 features) in both registries: at its
    default 32² (3072) the metrics' eigendecompositions take minutes here."""
    monkeypatch.setitem(dgm._ENCODERS, "pixel", functools.partial(dgm._pixel_encoder, size=4))
    monkeypatch.setitem(jdgm._ENCODERS, "pixel", functools.partial(jdgm._pixel_encoder, size=4))


def test_representations_and_scores_match_jax(sets, tmp_path):
    for path in sets.values():
        assert dgm.list_dataset_images(path) == jdgm.list_dataset_images(path)
    paths = dgm.list_dataset_images(sets["gen"])
    assert [os.path.basename(p) for p in paths[:3]] == ["1.png", "1.png", "1.png"]  # integer-aware order
    np.testing.assert_array_equal(dgm.image_labels(paths, sets["gen"]), jdgm.image_labels(paths, sets["gen"]))
    enc, jenc = dgm._ENCODERS["pixel"](device="cpu"), jdgm._ENCODERS["pixel"]()
    reps = {}
    for name, path in sets.items():
        got = dgm.compute_representations(path, enc, "pixel", batch_size=16, cache_dir=str(tmp_path / "port"))
        want = jdgm.compute_representations(path, jenc, "pixel", batch_size=16, cache_dir=str(tmp_path / "jax"))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        reps[name] = got
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name, path in sets.items():  # read back from the cache, the encoder never called
        again = dgm.compute_representations(path, None, "pixel", cache_dir=str(tmp_path / "port"))
        assert all(np.array_equal(a, b) for a, b in zip(again, reps[name]))
    kw = dict(reps_test=reps["test"][0], seed=3)
    got = dgm.compute_scores(METRICS, reps["real"][0], reps["gen"][0], reps["gen"][1], device="cpu", **kw)
    want = jdgm.compute_scores(METRICS, reps["real"][0], reps["gen"][0], reps["gen"][1], **kw)
    _same_scores(got, want)
    with pytest.raises(ValueError, match="requires 'prdc'"):
        dgm.compute_scores(["realism"], reps["real"][0], reps["gen"][0], device="cpu")


def test_nsample_quirk_subsamples_as_jax(tmp_path):
    """Subsampling only above nsample + 2000 files: 2012 files, nsample 10."""
    rng = np.random.default_rng(4)
    for i in range(2012):
        Image.fromarray(rng.integers(0, 255, (4, 4, 3), dtype=np.uint8)).save(tmp_path / f"{i}.png")
    enc, jenc = dgm._ENCODERS["pixel"](device="cpu"), jdgm._ENCODERS["pixel"]()
    got = dgm.compute_representations(str(tmp_path), enc, "pixel", nsample=10, seed=5)
    want = jdgm.compute_representations(str(tmp_path), jenc, "pixel", nsample=10, seed=5)
    assert got[0].shape == (10, 48) and np.array_equal(got[0], want[0])
    assert dgm._subsample(list(range(2010)), 10, 5) == list(range(2010))  # not above nsample + 2000


def _main_args(sets, out, model):
    return [sets["real"], sets["gen"], "--model", model, "--metrics", *METRICS, "--test_path", sets["test"],
            "--output_dir", out, "--batch_size", "16"]


def test_main_pixel_matches_jax(sets, tmp_path):
    got = dgm.main(_main_args(sets, str(tmp_path / "port"), "pixel") + ["--device", "cpu"])
    want = jdgm.main(_main_args(sets, str(tmp_path / "jax"), "pixel"))
    _same_scores(got["gen"], want["gen"])
    with open(tmp_path / "port" / "aggregate.json") as f:
        _same_scores(json.load(f)["gen"], want["gen"])
    assert (tmp_path / "port" / "scores_gen.json").exists()


TINY_VIT = dict(hidden_size=128, num_layers=1, num_heads=2, intermediate_size=256, patch_size=14, image_size=42)


@pytest.fixture(scope="module")
def tiny_dino():
    """JAX's tiny DINOv2 tree and the port module holding it (fp32)."""
    cfg = jdino.DINOv2Config(**TINY_VIT)
    params = numpy_init(jdino.init, cfg, 0)
    model = load_jax_params(dinov2.DINOv2(dinov2.DINOv2Config(**TINY_VIT), device="cpu"),
                            jax.tree.map(np.asarray, params))
    return params, cfg, model


def test_main_tiny_vit_with_heatmaps_matches_jax(sets, tmp_path, monkeypatch, tiny_dino):
    """A registered tiny DINOv2 through both drivers (one batch a set); the
    port's `--heatmaps` grid written (GradCAM's maps are held to JAX's in
    `test_gradcam_matches_jax`)."""
    params, cfg, model = tiny_dino
    mean, std = dgm.IMAGENET_MEAN, dgm.IMAGENET_STD
    jpre, pre = jdgm._resize_norm_preprocess(28, mean, std), dgm._resize_norm_preprocess(28, mean, std)
    jfwd = jax.jit(lambda x: jdino.cls_feature(params, x, cfg, policy=JPOLICY))

    def factory(weights_path=None, device=None, **kw):
        return dgm.Encoder(pre, lambda m, x, policy: m.cls_feature(x, PARITY_POLICY), CPU, model,
                           lambda x, tap: model.cls_feature(x, PARITY_POLICY, tap=tap), pre)

    monkeypatch.setitem(jdgm._ENCODERS, "tiny_vit", lambda weights_path=None: lambda b: np.asarray(jfwd(jpre(b))))
    monkeypatch.setitem(dgm._ENCODERS, "tiny_vit", factory)
    args = [sets["real"], sets["gen"], "--model", "tiny_vit", "--metrics", "fd", "kd", "prdc", "vendi",
            "--batch_size", "64"]
    got = dgm.main(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu", "--heatmaps",
                           "--heatmaps_count", "4"])
    want = jdgm.main(args + ["--output_dir", str(tmp_path / "jax")])
    for k in ("precision", "recall", "density", "coverage"):
        assert got["gen"][k] == want["gen"][k], k
    for k, w in want["gen"].items():
        assert abs(got["gen"][k] - w) <= 2e-4 * abs(w) + 1e-6, k
    grid = np.asarray(Image.open(tmp_path / "port" / "heatmaps_tiny_vit_gen_0.png"))
    assert grid.shape == (80, 80, 3)  # 2 × 2 tiles of 40²
