"""The port's FR data, verification and driver against the JAX package:
datasets and augmentation bit-equal for the same seeds, `verification.test`
bit-equal on equal embeddings, FR checkpoint files read across packages, and
`train_fr_run` → `test_fr_run` on a tiny backbone beside JAX's driver from
the same initial weights.
"""

import dataclasses
import io
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from faceposegenerator_tpu.core import checkpointing as jckpt
from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.data import augment as jaug
from faceposegenerator_tpu.data import fr_dataset as jds
from faceposegenerator_tpu.evaluation import verification as jver
from faceposegenerator_tpu.training import fr as jfr
from faceposegenerator_tpu.training import fr_driver as jdrv
from faceposegenerator_tpu_torch.bridge.jax_params import load_jax_params
from faceposegenerator_tpu_torch.core.checkpointing import save_pytree
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.core.tree import tree_paths
from faceposegenerator_tpu_torch.data import augment, fr_dataset
from faceposegenerator_tpu_torch.evaluation import verification
from faceposegenerator_tpu_torch.training import fr, fr_driver

TINY = dict(depths=(1, 1, 1, 1), fc_scale=1)
RES = 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _write_flat(root, ids=4, per_id=4, size=20, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(ids):
        base = rng.uniform(40, 215, 3)
        for j in range(per_id):
            img = np.clip(base + rng.normal(0, 30, (size, size, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, f"{10 + i}_{j}.jpg"), quality=95)
    return root


def _write_bin(path, pairs=20, size=RES, seed=1):
    rng = np.random.default_rng(seed)
    bins, issame = [], []
    for p in range(pairs):
        a = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        same = p % 2 == 0
        b = np.clip(a.astype(int) + rng.integers(-20, 21, a.shape), 0, 255).astype(np.uint8) if same else \
            rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        for img in (a, b):
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=95)
            bins.append(buf.getvalue())
        issame.append(same)
    with open(path, "wb") as f:
        pickle.dump((bins, issame), f)
    return path


@pytest.mark.parametrize("policy", ["hf", "ra_4_16", "blur", "faa_casia", "faa_imgnet"])
def test_augment_policies_bit_equal(policy):
    imgs = np.random.default_rng(2).integers(0, 256, (6, 24, 24, 3), dtype=np.uint8)
    ours, theirs = augment.get_aug_policy(policy), jaug.get_aug_policy(policy)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for img in imgs:
        np.testing.assert_array_equal(ours(img, r1), theirs(img, r2))
    assert augment.load_faa_policies(None, "casia") == jaug.load_faa_policies(None, "casia")


@pytest.mark.parametrize("kind", ["flat", "folder", "sharded"])
def test_datasets_bit_equal(tmp_path, kind):
    root = _write_flat(str(tmp_path / "flat"))
    if kind == "folder":
        for f in os.listdir(root):
            cls = tmp_path / "folder" / f.split("_")[0]
            cls.mkdir(parents=True, exist_ok=True)
            os.rename(os.path.join(root, f), cls / f)
        root = str(tmp_path / "folder")
    make = (fr_dataset.FolderDataset, jds.FolderDataset) if kind == "folder" else \
        (fr_dataset.FlatDirDataset, jds.FlatDirDataset)
    ours = make[0](root, image_size=RES, augment=augment.get_aug_policy("ra_2_9"), seed=4)
    theirs = make[1](root, image_size=RES, augment=jaug.get_aug_policy("ra_2_9"), seed=4)
    assert (ours.files, ours.num_classes) == (theirs.files, theirs.num_classes)
    kw = dict(num_shards=2, shard_index=1, order_seed=7) if kind == "sharded" else {}
    for epoch in range(2):
        a = list(fr_dataset.prefetch(ours.batches(3, epoch=epoch, **kw)))
        b = list(theirs.batches(3, epoch=epoch, **kw))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["images"], y["images"])
            np.testing.assert_array_equal(x["labels"], y["labels"])


def test_merge_synthetic_datasets_copies_the_same_files(tmp_path):
    synth = _write_flat(str(tmp_path / "synth"), ids=3, per_id=3)
    real = _write_flat(str(tmp_path / "real"), ids=2, per_id=2, seed=5)
    n = fr_dataset.merge_synthetic_datasets(synth, real, str(tmp_path / "ours"), samples_per_id=2)
    m = jds.merge_synthetic_datasets(synth, real, str(tmp_path / "theirs"), samples_per_id=2)
    assert n == m and sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "theirs"))


def test_verification_bit_equal_on_equal_embeddings(tmp_path):
    path = _write_bin(str(tmp_path / "lfw.bin"))
    images, issame = verification.load_bin(path, image_size=RES)
    j_images, j_issame = jver.load_bin(path, image_size=RES)
    np.testing.assert_array_equal(images, j_images)
    np.testing.assert_array_equal(issame, j_issame)
    proj = np.random.default_rng(8).normal(0, 1, (RES * RES * 3, 32)).astype(np.float32)

    def embed_np(x):
        return np.asarray(x, np.float32).reshape(len(x), -1) @ proj

    def embed_tensor(x):
        return torch.from_numpy(embed_np(x))

    want = jver.test((images, issame), embed_np, batch_size=16)
    assert verification.test((images, issame), embed_np, batch_size=16) == want
    assert verification.test((images, issame), embed_tensor, batch_size=16) == want


def _jax_fr_tree(loss="AdaFace"):
    cfg = jfr.FRConfig(num_classes=4, loss=loss, network="iresnet18")
    base = jfr.backbone_config
    jfr.backbone_config = lambda c: dataclasses.replace(base(c), **TINY)
    try:
        return cfg, jax.jit(lambda k: jfr.init_train_state(k, cfg))(jax.random.key(2))
    finally:
        jfr.backbone_config = base


def test_fr_checkpoint_files_cross_packages(tmp_path):
    """A best_backbone.npz that JAX writes loads into the port's (params,
    state), and the one the port writes loads into JAX's trees: bit-equal."""
    cfg, (params, state) = _jax_fr_tree()
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_pytree({"params": params, "state": state}, jpath)
    ours = fr.init_train_state(cfg, seed=9, device="cpu", backbone_cfg=fr.backbone_config(cfg, **TINY))
    fr.load_fr_checkpoint(jpath, *ours)
    want = dict(tree_paths(_np({"params": params, "state": state})))
    got = dict(tree_paths(fr.fr_checkpoint_tree(*ours)))
    assert set(got) == set(want)
    for p, leaf in got.items():
        np.testing.assert_array_equal(leaf, want[p], err_msg=p)
    ppath = str(tmp_path / "port.npz")
    save_pytree(fr.fr_checkpoint_tree(*ours), ppath)
    back = _np(jckpt.load_pytree({"params": params, "state": state}, ppath))
    for p, leaf in tree_paths(back):
        np.testing.assert_array_equal(leaf, want[p], err_msg=p)


def test_train_fr_run_matches_jax_driver(tmp_path, monkeypatch):
    """Both drivers from the same initial tree (ArcFace, no dropout, so no
    draws differ): 2 epochs of 2 steps with the verification callback on a
    synthetic bin; the same history of accuracies, best_backbone.npz within
    1e-4 of the tree's max abs, and test_fr_run reproducing the best epoch."""
    root = _write_flat(str(tmp_path / "flat"), ids=4, per_id=4, size=RES)
    bins = {"lfw": jver.load_bin(_write_bin(str(tmp_path / "lfw.bin")), image_size=RES)}
    cfg, (params, state) = _jax_fr_tree("ArcFace")
    cfg = dataclasses.replace(cfg, dropout=0.0, batch_size=4, num_epochs=2, early_stop_patience=5)
    base = jfr.backbone_config
    monkeypatch.setattr(jfr, "backbone_config", lambda c: dataclasses.replace(base(c), **TINY))
    monkeypatch.setattr(jfr, "init_train_state", lambda key, c: (params, state))
    want = jdrv.train_fr_run(cfg, jds.FlatDirDataset(root, image_size=RES), str(tmp_path / "jax"), val_bins=bins,
                             policy=JPOLICY, max_steps_per_epoch=2)

    ours = fr.backbone_config
    monkeypatch.setattr(fr, "backbone_config", lambda c: ours(c, **TINY))
    init = fr.init_train_state

    def from_jax(c, seed, device):
        p, s = init(c, seed, device)
        load_jax_params(p["backbone"], _np(params["backbone"]), _np(state["bn"]))
        with torch.no_grad():
            p["kernel"].copy_(torch.from_numpy(np.asarray(params["kernel"])))
        return p, s

    monkeypatch.setattr(fr, "init_train_state", from_jax)
    out = str(tmp_path / "port")
    got = fr_driver.train_fr_run(cfg, fr_dataset.FlatDirDataset(root, image_size=RES), out, val_bins=bins,
                                 policy=PARITY_POLICY, max_steps_per_epoch=2, device="cpu",
                                 checkpoint_every_epoch=True)
    assert [h["acc"] for h in got["history"]] == [h["acc"] for h in want["history"]]
    assert got["best_acc"] == want["best_acc"]
    for name in ("best_backbone.npz", "history.json", "fr_config.json", "epoch_1_backbone.npz"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "fr_config.json")) as f, open(tmp_path / "jax" / "fr_config.json") as g:
        assert json.load(f) == json.load(g)
    with np.load(os.path.join(out, "best_backbone.npz")) as a, np.load(tmp_path / "jax" / "best_backbone.npz") as b:
        assert set(a.files) == set(b.files)
        scale = max(float(np.abs(b[k]).max()) for k in b.files if k.startswith("params/"))
        for k in a.files:
            assert np.abs(a[k] - b[k]).max() <= 1e-4 * (scale if k.startswith("params/") else 1.0), k

    res = fr_driver.test_fr_run(cfg, os.path.join(out, "best_backbone.npz"), bins, str(tmp_path / "test.json"),
                                policy=PARITY_POLICY, device="cpu")
    assert res["lfw"]["accuracy"] == got["best_acc"] and os.path.exists(tmp_path / "test.json")
    assert fr_driver.train_fr_run(cfg, fr_dataset.FlatDirDataset(root, image_size=RES), out, device="cpu")["skipped"]
    # a mesh whose data axis does not divide the batch is refused before anything is written
    from faceposegenerator_tpu_torch.core.mesh import make_mesh

    with pytest.raises(ValueError, match="data axis"):
        fr_driver.train_fr_run(cfg, fr_dataset.FlatDirDataset(root, image_size=RES), str(tmp_path / "m"),
                               device="cpu", mesh=make_mesh(world_size=cfg.batch_size + 1, rank=0, device="cpu"))
    assert not os.path.exists(tmp_path / "m")
