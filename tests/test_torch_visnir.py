"""The port's RGBN data path and the conditional layouts against the JAX
package's (`data/visnir.py`, `data/conditional.py`): `VISNIRDataset`
items (a NIR file present and missing, with and without the flip
augmentation) and `load_bin_4channel` equal to JAX's; the 4-channel IResNet
(1, 1, 1, 1) from JAX's weights (`load_jax_params` carries the HWIO
(3, 3, 4, 64) conv1 to OIHW) in eval and one AdaFace SGD step against
JAX's at fp32 (1e-5 of the max abs); `flat_to_conditional` and
`conditional_to_flat` making the same trees and counts as JAX's.
"""

import dataclasses
import io
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.data import conditional as jconditional
from faceposegenerator_tpu.data import augment as jaugment
from faceposegenerator_tpu.data import visnir as jvisnir
from faceposegenerator_tpu.models import iresnet as jir
from faceposegenerator_tpu.training import fr as jfr
from faceposegenerator_tpu_torch.bridge.jax_params import load_jax_params
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.core.tree import tree_paths
from faceposegenerator_tpu_torch.data import augment, conditional, visnir
from faceposegenerator_tpu_torch.training import fr

from test_torch_checkpoints import numpy_init
from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(depths=(1, 1, 1, 1), fc_scale=1, in_channels=4)
B, RES, CLASSES = 8, 16, 10


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jpeg(rng, size, channels=3):
    from PIL import Image

    buf = io.BytesIO()
    arr = rng.integers(0, 256, (size, size, channels), np.uint8)
    Image.fromarray(arr if channels == 3 else arr[..., 0]).save(buf, "JPEG", quality=92)
    return buf.getvalue()


def _jax_rgbn_step():
    """JAX's tiny RGBN backbone (its init's tree filled from numpy, AdaFace's
    EMA at its initial 20 and 100) and one AdaFace step (key 5); its initial
    trees, final trees, loss, dropout mask and eval embedding."""
    cfg = jfr.FRConfig(num_classes=CLASSES, batch_size=B, loss="AdaFace", network="iresnet18")
    base = jfr.backbone_config
    jfr.backbone_config = lambda c: dataclasses.replace(base(c), **TINY)
    try:
        params, state = numpy_init(lambda k, c: jfr.init_train_state(k, c), cfg, 3)
        state["adaface"] = {"batch_mean": np.float32(20.0), "batch_std": np.float32(100.0)}
        init = (_np(params), _np(state))
        opt = jfr.make_optimizer(cfg)
        step = jfr.make_train_step(cfg, opt, policy=JPOLICY, donate=False)
        x, y = _batch()
        key = jax.random.key(5)
        mask = np.asarray(jax.random.bernoulli(key, 1 - cfg.dropout, (B, 512)))
        params, state, _, m = step(params, state, opt.init(params),
                                   {"images": jnp.asarray(x), "labels": jnp.asarray(y)}, key)
        bcfg = jfr.backbone_config(cfg)
        embed = jax.jit(lambda p, s, x: jir.apply(p, s, x, bcfg, policy=JPOLICY)[0])(
            init[0]["backbone"], init[1]["bn"], jnp.asarray(x))
    finally:
        jfr.backbone_config = base
    return cfg, init, (_np(params), _np(state)), float(m["loss"]), mask, np.asarray(embed)


@pytest.fixture(scope="module")
def jax_step():
    """JAX compiles its step on a worker thread while the data tests run."""
    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(_jax_rgbn_step)
    yield fut
    pool.shutdown()


def _batch():
    rng = np.random.default_rng(9)
    return rng.uniform(-1, 1, (B, RES, RES, 4)).astype(np.float32), rng.integers(0, CLASSES, B).astype(np.int32)


@pytest.fixture(scope="module")
def vis_nir(tmp_path_factory):
    """6 VIS JPEGs of 3 identities at 40² (resized to 32 by the datasets),
    NIR files (grayscale) for 4 of them."""
    d = tmp_path_factory.mktemp("visnir")
    rng = np.random.default_rng(3)
    for sub in ("vis", "nir"):
        (d / sub).mkdir()
    for i in range(6):
        name = f"{i // 2 + 10}_{i}.jpg"
        (d / "vis" / name).write_bytes(_jpeg(rng, 40))
        if i not in (1, 4):
            (d / "nir" / name).write_bytes(_jpeg(rng, 40, channels=1))
    return str(d / "vis"), str(d / "nir")


@pytest.mark.parametrize("aug", [None, "hf"])
def test_visnir_items_equal_jax(jax_step, vis_nir, aug):
    ds = visnir.VISNIRDataset(*vis_nir, image_size=32, augment=aug and augment.get_aug_policy(aug), seed=4)
    ref = jvisnir.VISNIRDataset(*vis_nir, image_size=32, augment=aug and jaugment.get_aug_policy(aug), seed=4)
    assert len(ds) == len(ref) == 6 and ds.num_classes == ref.num_classes == 3
    items = []
    for i in range(6):
        (gx, gy), (wx, wy) = ds[i], ref[i]
        assert gx.shape == (32, 32, 4) and gx.dtype == wx.dtype == np.float32
        np.testing.assert_array_equal(gx, wx, err_msg=f"item {i}")
        assert gy == wy
        items.append(gx)
    if aug is None:  # item 1 has no NIR file: its channel is the VIS mean
        vis = ((items[1][..., :3] * 0.5 + 0.5) * 255).round()
        np.testing.assert_allclose((items[1][..., 3] * 0.5 + 0.5) * 255, vis.mean(-1).astype(np.uint8), atol=1e-3)
    got, want = next(ds.batches(4, shuffle=True)), next(ref.batches(4, shuffle=True))
    np.testing.assert_array_equal(got["images"], want["images"])
    np.testing.assert_array_equal(got["labels"], want["labels"])


def test_load_bin_4channel_equals_jax(tmp_path):
    rng = np.random.default_rng(5)
    for name, ch in (("vis", 3), ("nir", 1)):
        with open(tmp_path / f"{name}.bin", "wb") as f:
            pickle.dump(([_jpeg(rng, 24, ch) for _ in range(8)], [True, False, True, False]), f)
    got = visnir.load_bin_4channel(str(tmp_path / "vis.bin"), str(tmp_path / "nir.bin"), image_size=24)
    want = jvisnir.load_bin_4channel(str(tmp_path / "vis.bin"), str(tmp_path / "nir.bin"), image_size=24)
    assert got[0].shape == (8, 24, 24, 4) and got[0].dtype == np.uint8
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_rgbn_iresnet_and_fr_step_match_jax(jax_step):
    """The 4-channel backbone from JAX's init: conv1 carried HWIO → OIHW, the
    eval embedding, then one AdaFace step with JAX's dropout mask: the loss
    within 1e-5 relative, every param and state leaf within 1e-5 of its
    tree's max abs."""
    cfg, (p0, s0), (p1, s1), want_loss, mask, want_embed = jax_step.result()
    bcfg = fr.backbone_config(cfg, **TINY)
    params, state = fr.init_train_state(cfg, device="cpu", backbone_cfg=bcfg)
    load_jax_params(params["backbone"], p0["backbone"], s0["bn"])
    w = params["backbone"].conv1.weight
    assert w.shape == (64, 4, 3, 3)
    np.testing.assert_array_equal(w.detach().numpy(), p0["backbone"]["conv1"]["w"].transpose(3, 2, 0, 1))
    with torch.no_grad():
        params["kernel"].copy_(torch.from_numpy(np.array(p0["kernel"])))
    x, y = _batch()
    with torch.no_grad():
        embed = params["backbone"](torch.from_numpy(x), PARITY_POLICY).numpy()
    assert np.abs(embed - want_embed).max() <= 1e-5 * np.abs(want_embed).max()
    opt = fr.make_optimizer(cfg)
    step = fr.make_train_step(cfg, opt, PARITY_POLICY)
    params, state, _, m = step(params, state, opt.init(params), {"images": x, "labels": y},
                               draws={"dropout": torch.from_numpy(np.array(mask)), "margin": torch.zeros(B)})
    assert abs(float(m["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
    got = fr.fr_checkpoint_tree(params, state)
    for tree, want in ((got["params"], p1), (got["state"], s1)):
        want_paths = dict(tree_paths(want))
        got_paths = dict(tree_paths(tree))
        assert set(got_paths) == set(want_paths)
        scale = max(float(np.abs(v).max()) for v in want_paths.values())
        for path, leaf in got_paths.items():
            assert np.abs(leaf - want_paths[path]).max() <= 1e-5 * scale, path


def _tree(root):
    return sorted((os.path.relpath(os.path.join(d, f), root), open(os.path.join(d, f), "rb").read())
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("copy", [True, False])
def test_conditional_converters_equal_jax(tmp_path, copy):
    rng = np.random.default_rng(6)
    files = {name: rng.bytes(16) for name in ("3_a.jpg", "3_b.png", "12_c.jpeg", "7_d.JPG", "notes.txt")}
    for side in ("port", "jax"):
        flat = tmp_path / side / "flat"
        flat.mkdir(parents=True)
        for name, data in files.items():
            (flat / name).write_bytes(data)
    results = {}
    for side, mod in (("port", conditional), ("jax", jconditional)):
        base = tmp_path / side
        counts = mod.flat_to_conditional(str(base / "flat"), str(base / "cond"), copy=copy)
        (base / "cond" / "3" / "5_e.jpg").write_bytes(b"x")  # a name with another id's prefix
        (base / "cond" / "stray.jpg").write_bytes(b"y")  # not in an id folder: skipped
        n = mod.conditional_to_flat(str(base / "cond"), str(base / "flat2"), copy=copy)
        results[side] = (counts, n, _tree(str(base / "cond")), _tree(str(base / "flat2")),
                         _tree(str(base / "flat")))
    assert results["port"] == results["jax"]
    assert results["port"][0] == {"3": 2, "12": 1, "7": 1} and results["port"][1] == 5
