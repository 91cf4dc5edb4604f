"""The port's ID-Booth driver and its modules (dataset, checkpoints, config
snapshot, logging, trackers, the image grid, the driver and the sweep)
against the JAX package, on the CPU.

Most checks run no model. The dataset's batches, the checkpoint manager's
directories and the config snapshot must be bit-equal (or byte-equal) to
JAX's for the same files, seed and save sequence; a JAX-written `state.npz`
loads into the port bit-equal. `run_identity` runs end to end on the tiny
bundle of tests/test_torch_training.py at 64², fp32 (PARITY_POLICY), with
random weights from seeds: 2 epochs, then resumed to 3, which must be
bit-equal to an uninterrupted 3-epoch run (every array of the last
checkpoint, the epoch means), and its final LoRA file must read back
through JAX's `diffusion.lora_io` equal to the port's trainable.
`run_identities_vmapped` trains two identities stacked against two serial
`run_identity` calls (the tolerances of the stacked-update test in
tests/test_torch_training.py), then resumes. The sweep must make JAX's
folders, configs and identity groups on the same directory sizes.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.core import checkpointing as jckpt
from faceposegenerator_tpu.core.config import snapshot_config as jsnapshot
from faceposegenerator_tpu.data.dreambooth import DreamBoothDataset as JDataset
from faceposegenerator_tpu.diffusion import lora_io as jlora_io
from faceposegenerator_tpu.models import unet2d as junet
from faceposegenerator_tpu.training import idbooth as jidbooth
from faceposegenerator_tpu.training import idbooth_driver as jdriver
from faceposegenerator_tpu.training import multi_identity as jmulti
from faceposegenerator_tpu_torch.core import checkpointing, logging_utils
from faceposegenerator_tpu_torch.core.config import snapshot_config
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.core.trackers import Tracker
from faceposegenerator_tpu_torch.core.tree import tree_map, tree_paths
from faceposegenerator_tpu_torch.data.dreambooth import DreamBoothDataset
from faceposegenerator_tpu_torch.models import clip_text, iresnet, unet2d, vae
from faceposegenerator_tpu_torch.pipelines.sweep import save_image_grid
from faceposegenerator_tpu_torch.training import idbooth, idbooth_driver, multi_identity

TINY = idbooth.ModelBundle(
    text_cfg=clip_text.CLIPTextConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64),
    unet_cfg=unet2d.UNetConfig(block_out_channels=(32, 64, 64, 64), cross_attention_dim=32, head_dim=8,
                               norm_groups=8),
    vae_cfg=vae.VAEConfig(block_out_channels=(32, 32, 32, 32)),
    arcface_cfg=iresnet.config_for("r18", num_features=64),
)
JUNET_CFG = junet.UNetConfig(block_out_channels=(32, 64, 64, 64), cross_attention_dim=32, head_dim=8, norm_groups=8)


def _frozen():
    return {
        "text_encoder": clip_text.CLIPTextModel(TINY.text_cfg, device="cpu", seed=0),
        "unet": unet2d.UNet2DCondition(TINY.unet_cfg, device="cpu", seed=1),
        "vae": vae.AutoencoderKL(TINY.vae_cfg, device="cpu", seed=2),
        "arcface": iresnet.IResNet(TINY.arcface_cfg, device="cpu", seed=3),
    }


def _images(folder, sizes, seed):
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(os.path.join(folder, f"img_{i}.jpg"))


def _image_tree(root, res=64, n_inst=2, n_cls=2, sizes=None, cls_sizes=None):
    """root/src/id_1 (instance images), root/class (class images),
    root/embeds/id_1 (per-image .npy, one .pt) and root/class_embed.npy."""
    inst, cls, emb = (os.path.join(root, p) for p in ("src/id_1", "class", "embeds/id_1"))
    _images(inst, sizes or [(res, res)] * n_inst, 0)
    _images(cls, cls_sizes or [(res, res)] * n_cls, 1)
    os.makedirs(emb)
    rng = np.random.default_rng(2)
    for i in range(n_inst):
        e = rng.standard_normal(64).astype(np.float32)
        if i == 1:
            torch.save(torch.from_numpy(e), os.path.join(emb, f"img_{i}.pt"))
        else:
            np.save(os.path.join(emb, f"img_{i}.npy"), e)
    np.save(os.path.join(root, "class_embed.npy"), rng.standard_normal(64).astype(np.float32))
    return inst, cls, emb


def _assert_batches_equal(mine, ref):
    mine, ref = list(mine), list(ref)
    assert len(mine) == len(ref) > 0
    for a, b in zip(mine, ref):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == np.asarray(b[k]).dtype and np.array_equal(a[k], np.asarray(b[k])), k


@pytest.mark.parametrize("center_crop", [False, True])
def test_dataset_batches_match_jax(tmp_path, center_crop):
    """Resize, crop, shuffle, class cycling and embeddings (.npy, .pt, the
    class embed): two epochs of batches bit-equal to JAX's."""
    inst, cls, emb = _image_tree(str(tmp_path), n_inst=3, n_cls=5, sizes=[(40, 52), (48, 32), (33, 33)])
    ids = np.arange(77, dtype=np.int32)
    kw = dict(class_dir=cls, class_ids=ids + 1, embeds_dir=emb, resolution=32, center_crop=center_crop, seed=7,
              embed_dim=64)
    mine, ref = DreamBoothDataset(inst, ids, **kw), JDataset(inst, ids, **kw)
    assert len(mine) == len(ref) == 5
    for _ in range(2):
        _assert_batches_equal(mine.batches(2), ref.batches(2))
    solo = dict(kw, class_dir=None, class_ids=None)
    _assert_batches_equal(DreamBoothDataset(inst, ids, **solo).batches(2, drop_last=False),
                          JDataset(inst, ids, **solo).batches(2, drop_last=False))


def test_dataset_sharded_batches_match_jax(tmp_path):
    """Each host's rows of the global batch bit-equal to JAX's; the two
    shards in host order make the whole batch."""
    inst, cls, emb = _image_tree(str(tmp_path), n_inst=4, n_cls=3, sizes=[(36, 36)] * 4)
    ids = np.arange(77, dtype=np.int32)
    kw = dict(class_dir=cls, class_ids=ids, embeds_dir=emb, resolution=32, center_crop=True, seed=3, embed_dim=64)
    for shard in (0, 1):
        _assert_batches_equal(DreamBoothDataset(inst, ids, **kw).sharded_batches(1, 2, shard, epoch=1, order_seed=5),
                              JDataset(inst, ids, **kw).sharded_batches(1, 2, shard, epoch=1, order_seed=5))
    whole = list(DreamBoothDataset(inst, ids, **kw).sharded_batches(2, 1, 0, epoch=1, order_seed=5))
    parts = [list(DreamBoothDataset(inst, ids, **kw).sharded_batches(1, 2, s, epoch=1, order_seed=5)) for s in (0, 1)]
    for w, p0, p1 in zip(whole, *parts):
        assert np.array_equal(w["pixel_values"], np.concatenate([p0["pixel_values"], p1["pixel_values"]]))


def test_tree_paths_match_jax_and_stacking_round_trips():
    """The port's tree walker: JAX's key paths and leaves (None an empty
    subtree, tuples kept), and stack_pytrees / unstack_pytree built on it
    round-trip, sharing numbers and refusing numbers that differ."""
    tree = {"b": [np.float32(1.0), None, (np.arange(2.0), {"z": np.zeros(3)})], "a": 3}
    ref = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): v
           for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    mine = dict(tree_paths(tree))
    assert set(mine) == set(ref) == {"a", "b/0", "b/2/0", "b/2/1/z"}
    assert all(mine[p] is ref[p] for p in ref)
    assert isinstance(tree_map(lambda x: x, tree)["b"][2], tuple)
    trees = [{"t": [torch.full((2,), float(i)), None], "count": 4} for i in range(3)]
    stacked = multi_identity.stack_pytrees(trees)
    assert stacked["t"][0].shape == (3, 2) and stacked["t"][1] is None and stacked["count"] == 4
    for i, back in enumerate(multi_identity.unstack_pytree(stacked, 3)):
        assert torch.equal(back["t"][0], trees[i]["t"][0]) and back["count"] == 4
    with pytest.raises(ValueError, match="shared number"):
        multi_identity.stack_pytrees([{"count": 1}, {"count": 2}])


def test_checkpoint_manager_matches_jax(tmp_path):
    """Naming, pruning oldest first, latest() by step and restore on the
    same save sequence as JAX's; the state.npz keys are JAX's tree paths."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal(4).astype(np.float32),
            "b": [rng.standard_normal(2).astype(np.float32), None, {"z": np.zeros(3, np.float32)}]}
    opt = {"count": np.array(3)}
    mine = checkpointing.CheckpointManager(str(tmp_path / "port"), total_limit=2)
    ref = jckpt.CheckpointManager(str(tmp_path / "jax"), total_limit=2)
    ttree = jax.tree.map(torch.from_numpy, tree)
    for epoch, step in ((0, 100), (1, 200), (3, 150), (2, 400)):
        mine.save(epoch, step, ttree, {"count": 3})
        ref.save(epoch, step, tree, opt)
        assert sorted(os.listdir(mine.output_dir)) == sorted(os.listdir(ref.output_dir))
    assert [c[:2] for c in mine.list_checkpoints()] == [c[:2] for c in ref.list_checkpoints()] == [(1, 200), (2, 400)]
    assert os.path.basename(mine.latest()) == os.path.basename(ref.latest()) == "checkpoint-2-400"
    for name in ("state.npz", "META"):
        assert os.path.exists(os.path.join(mine.latest(), name))
    with open(os.path.join(mine.latest(), "META")) as f, open(os.path.join(ref.latest(), "META")) as g:
        assert f.read() == g.read()
    with np.load(os.path.join(mine.latest(), "state.npz")) as a, np.load(os.path.join(ref.latest(), "state.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    t, o, epoch, step = mine.restore(mine.latest(), jax.tree.map(torch.zeros_like, ttree), {"count": 0})
    assert (epoch, step, o) == (2, 400, {"count": 3})
    assert t["b"][1] is None and t["a"].dtype == torch.float32
    assert np.array_equal(t["b"][2]["z"].numpy(), tree["b"][2]["z"]) and np.array_equal(t["a"].numpy(), tree["a"])


def test_jax_state_npz_trainable_loads_into_port(tmp_path):
    """The `trainable` of a state.npz written by JAX's CheckpointManager
    loads into the port's LoRA tree, bit-equal."""
    shapes = jax.eval_shape(functools.partial(junet.init, cfg=JUNET_CFG), jax.random.key(1))
    jtrain = jidbooth.init_trainable(jax.random.key(4), jidbooth.IDBoothConfig(), None, shapes)
    jtrain = jax.tree.map(lambda x: np.asarray(x) + 0.25, jtrain)  # nonzero B too
    jopt = jidbooth.make_optimizer(jidbooth.IDBoothConfig(), 10).init(jtrain)
    path = jckpt.CheckpointManager(str(tmp_path)).save(0, 7, jtrain, jopt)
    template = idbooth.init_trainable(0, idbooth.IDBoothConfig(), TINY, _frozen()["unet"])
    got = checkpointing.load_pytree({"trainable": template}, os.path.join(path, "state.npz"))["trainable"]
    mine = dict(tree_paths(got))
    ref = {"/".join(jckpt._path_key(k) for k in p): np.asarray(v)
           for p, v in jax.tree_util.tree_flatten_with_path(jtrain)[0]}
    assert set(mine) == set(ref) and len(mine) == len(idbooth.tree_leaves(template)) == 256
    for k, v in ref.items():
        assert mine[k].requires_grad and np.array_equal(mine[k].detach().numpy(), v), k


def test_snapshot_config_matches_jax(tmp_path):
    kw = dict(which_loss="triplet_prior", train_batch_size=3, losses_to_test=("", "triplet_prior"),
              checkpoints_total_limit=2, identity_chunk=1, learning_rate=5e-5)
    a = snapshot_config(idbooth.IDBoothConfig(**kw), str(tmp_path / "port"))
    b = jsnapshot(jidbooth.IDBoothConfig(**kw), str(tmp_path / "jax"))
    with open(a) as f, open(b) as g:
        assert f.read() == g.read()
    assert idbooth.IDBoothConfig(**kw).to_dict() == jidbooth.IDBoothConfig(**kw).to_dict()


def _run(cfg, out, inst, cls, emb, frozen, **kw):
    ids = np.arange(77, dtype=np.int32) % 64
    return idbooth_driver.run_identity(cfg, TINY, frozen, inst, out, class_dir=cls, embeds_dir=emb,
                                       policy=PARITY_POLICY, instance_ids=ids, class_ids=ids[::-1].copy(), **kw)


@pytest.fixture
def one_thread():
    """Torch (and MKL) on one thread within the test: MKL picks its thread
    count by the machine's load (MKL_DYNAMIC), and a GEMM split otherwise
    rounds otherwise, so two runs on a loaded machine may differ in the
    last bit; and the test workers share the machine's cores, which a
    thread pool per worker oversubscribes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_run_identity_resume_matches_an_uninterrupted_run(tmp_path, one_thread):
    """2 epochs, then resume to 3, against 3 epochs in one run: the
    directory contract, the last checkpoint's every array and the last
    epoch's means bit-equal; the final LoRA file read by JAX equal to the
    port's trainable. The learning rate is constant: a cosine schedule's
    length is num_train_epochs, so a 2-epoch and a 3-epoch run would part
    from their first step."""
    PARITY_POLICY.configure_backends()
    # images wider or taller than 64: every epoch's random crops draw from the dataset's RNG
    inst, cls, emb = _image_tree(str(tmp_path), sizes=[(64, 80), (72, 64)], cls_sizes=[(80, 64), (64, 70)])
    frozen = _frozen()
    cfg = idbooth.IDBoothConfig(which_loss="triplet_prior", resolution=64, num_train_epochs=2, train_batch_size=2,
                                checkpointing_epochs=1, checkpoints_total_limit=2, lr_scheduler="constant",
                                learning_rate=1e-3)
    whole = str(tmp_path / "whole")
    trainable, history = _run(cfg.replace(num_train_epochs=3), whole, inst, cls, emb, frozen)
    assert len(history) == 3 and all(np.isfinite(h["loss"]) for h in history)
    out = str(tmp_path / "out")
    _, first = _run(cfg, out, inst, cls, emb, frozen)
    assert first == history[:2]
    names = sorted(os.listdir(out))
    assert names == ["checkpoint-0-1", "checkpoint-1-2", "logs", "pytorch_lora_weights.safetensors", "training.log"]
    assert sorted(os.listdir(os.path.join(out, "checkpoint-1-2"))) == [
        "META", "data_rng.json", "pytorch_lora_weights.safetensors", "state.npz"]
    with open(os.path.join(out, "logs", "scalars.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
    resumed, second = _run(cfg.replace(num_train_epochs=3), out, inst, cls, emb, frozen, resume=True)
    assert second == history[2:]
    assert sorted(os.listdir(out))[:2] == ["checkpoint-1-2", "checkpoint-2-3"]  # pruned to 2
    for a, b in zip(idbooth.tree_leaves(resumed), idbooth.tree_leaves(trainable)):
        assert torch.equal(a, b)
    with np.load(os.path.join(out, "checkpoint-2-3", "state.npz")) as a, \
            np.load(os.path.join(whole, "checkpoint-2-3", "state.npz")) as b:
        assert sorted(a.files) == sorted(b.files) and "opt_state/exp_avg_sq/unet_lora/mid_block/attentions/0/" \
            "blocks/0/attn2/out/b" in a.files
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
        assert int(a["opt_state/count"]) == 3
    shapes = jax.eval_shape(functools.partial(junet.init, cfg=JUNET_CFG), jax.random.key(1))
    lora = jlora_io.load_lora_safetensors(out, shapes)
    ref = dict(tree_paths(lora["unet"]))
    mine = dict(tree_paths(resumed["unet_lora"]))
    assert set(ref) == set(mine) and lora["text_encoder"] is None
    for k, v in ref.items():
        assert np.array_equal(np.asarray(v), mine[k].detach().numpy()), k


def _assert_checkpoints_close(stacked_ckpt, serial_ckpt, lr, beta1):
    """A stacked identity's checkpoint against its serial run's, at the
    tolerances of the stacked-update test in tests/test_torch_training.py:
    the AdamW moments within 1e-6 + 1e-4 relative; the LoRA, after one
    update, within 1e-6 wherever the gradient is at least 1e-6 (Adam's first
    step is g / (|g| + eps): below that the two batch shapes' fp32 rounding
    noise becomes up to a whole step), and within 2·lr an update everywhere
    (an Adam update moves an entry by at most lr, plus weight decay)."""
    with np.load(os.path.join(stacked_ckpt, "state.npz")) as a, np.load(os.path.join(serial_ckpt, "state.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        updates = int(b["opt_state/count"])
        assert int(a["opt_state/count"]) == updates
        kept = total = 0
        for key in (f for f in b.files if f.startswith("trainable/")):
            diff = np.abs(a[key] - b[key])
            assert diff.max() <= 2 * lr * updates, key
            if updates == 1:
                keep = np.abs(b["opt_state/exp_avg/" + key[len("trainable/"):]]) / (1 - beta1) >= 1e-6
                assert diff[keep].max(initial=0.0) <= 1e-6, key
                kept, total = kept + int(keep.sum()), total + keep.size
        assert kept >= 0.5 * total, (kept, total)
        for key in (f for f in b.files if f.startswith("opt_state/exp_avg")):
            np.testing.assert_allclose(a[key], b[key], atol=1e-6, rtol=1e-4, err_msg=key)


def test_run_identities_vmapped_matches_serial_runs(tmp_path, one_thread):
    """Two identities stacked for 2 epochs (one step each) against two
    serial run_identity calls on the same folders (triplet_prior, no
    validation): each identity's files, epoch means (1e-5 relative) and
    checkpoints after the first and the last epoch (as in
    `_assert_checkpoints_close`); then the stacked run resumed to 3 epochs
    runs one epoch, and a group whose identities stand at different
    checkpoints is refused."""
    PARITY_POLICY.configure_backends()
    root = str(tmp_path)
    inst, cls, emb = _image_tree(root, sizes=[(64, 80), (72, 64)], cls_sizes=[(80, 64), (64, 70)])
    inst2, emb2 = os.path.join(root, "src", "id_2"), os.path.join(root, "embeds", "id_2")
    _images(inst2, [(80, 72), (64, 66)], 3)
    os.makedirs(emb2)
    for i, e in enumerate(np.random.default_rng(4).standard_normal((2, 64)).astype(np.float32)):
        np.save(os.path.join(emb2, f"img_{i}.npy"), e)
    frozen = _frozen()
    cfg = idbooth.IDBoothConfig(which_loss="triplet_prior", resolution=64, num_train_epochs=2, train_batch_size=2,
                                checkpointing_epochs=1, checkpoints_total_limit=2, lr_scheduler="constant")
    ids = np.arange(77, dtype=np.int32) % 64
    kw = dict(class_dir=cls, policy=PARITY_POLICY, instance_ids=ids, class_ids=ids[::-1].copy())
    outs = [os.path.join(root, "stacked", i) for i in ("id_1", "id_2")]
    t_list, hists = multi_identity.run_identities_vmapped(cfg, TINY, frozen, [inst, inst2], outs,
                                                          embeds_dirs=[emb, emb2], **kw)
    assert len(t_list) == len(hists) == 2
    for k, (src, emb_k, out) in enumerate(zip((inst, inst2), (emb, emb2), outs)):
        serial_out = os.path.join(root, "serial", f"id_{k + 1}")
        trainable, history = idbooth_driver.run_identity(cfg, TINY, frozen, src, serial_out, embeds_dir=emb_k, **kw)
        # the stacked run logs into the first identity's folder, and keeps no tracker
        assert sorted(os.listdir(out)) == ["checkpoint-0-1", "checkpoint-1-2", "pytorch_lora_weights.safetensors"] + (
            ["training.log"] if k == 0 else [])
        assert len(hists[k]) == len(history) == 2
        for mine, ref in zip(hists[k], history):
            assert set(mine) == set(ref) | {"grad_norm"} and mine["epoch"] == ref["epoch"]
            for key, v in ref.items():
                np.testing.assert_allclose(mine[key], v, rtol=1e-5, err_msg=key)
        for name in ("checkpoint-0-1", "checkpoint-1-2"):
            assert sorted(os.listdir(os.path.join(out, name))) == sorted(os.listdir(os.path.join(serial_out, name)))
            _assert_checkpoints_close(os.path.join(out, name), os.path.join(serial_out, name), cfg.learning_rate,
                                      cfg.adam_beta1)
        with np.load(os.path.join(out, "checkpoint-1-2", "state.npz")) as a:
            for path, leaf in tree_paths(t_list[k]):
                assert np.array_equal(leaf.detach().numpy(), a["trainable/" + path]), path
    diff = max(float((x - y).detach().abs().max()) for x, y in zip(idbooth.tree_leaves(t_list[0]),
                                                                  idbooth.tree_leaves(t_list[1])))
    assert diff > 1e-4  # the two identities' LoRAs differ

    _, more = multi_identity.run_identities_vmapped(cfg.replace(num_train_epochs=3), TINY, frozen, [inst, inst2], outs,
                                                    embeds_dirs=[emb, emb2], **kw)
    assert [[h["epoch"] for h in hist] for hist in more] == [[2], [2]]
    for out in outs:
        assert sorted(os.listdir(out))[:2] == ["checkpoint-1-2", "checkpoint-2-3"]  # pruned to 2
        with np.load(os.path.join(out, "checkpoint-2-3", "state.npz")) as a:
            assert int(a["opt_state/count"]) == 3
    os.rename(os.path.join(outs[1], "checkpoint-2-3"), os.path.join(outs[1], "checkpoint-2-4"))
    with pytest.raises(ValueError, match="same"):
        multi_identity.run_identities_vmapped(cfg.replace(num_train_epochs=4), TINY, frozen, [inst, inst2], outs,
                                              embeds_dirs=[emb, emb2], **kw)


def test_run_identity_refuses_a_mesh(tmp_path):
    """A mesh whose data axis does not divide the global batch (here
    [instance; class] = 2 rows over 3 ranks) is refused before anything
    loads or is written."""
    from faceposegenerator_tpu_torch.core.mesh import make_mesh

    mesh = make_mesh(world_size=3, rank=0, device="cpu")
    with pytest.raises(ValueError, match="data axis"):
        idbooth_driver.run_identity(idbooth.IDBoothConfig(), TINY, {}, str(tmp_path), str(tmp_path), mesh=mesh)
    assert not any(tmp_path.iterdir())


def test_validation_images_and_grid(tmp_path, one_thread):
    """DPM-Solver++ validation images on the tiny nets ([0, 1], the text
    LoRA moving them), tiled by save_image_grid."""
    frozen = _frozen()
    cfg = idbooth.IDBoothConfig(resolution=64, num_validation_images=2, train_text_encoder=True)
    trainable = idbooth.init_trainable(0, cfg, TINY, frozen["unet"], frozen["text_encoder"])

    def tok(prompts):
        return np.stack([np.full(77, len(p) % 64, np.int32) for p in prompts])

    imgs = idbooth_driver.validation_images(frozen, trainable, cfg, TINY, tok, PARITY_POLICY, num_steps=2)
    assert imgs.shape == (2, 64, 64, 3) and imgs.dtype == np.float32 and 0 <= imgs.min() <= imgs.max() <= 1
    with torch.no_grad():
        for leaf in idbooth.tree_leaves(trainable["text_lora"])[1::2]:
            leaf.fill_(0.5)
    moved = idbooth_driver.validation_images(frozen, trainable, cfg, TINY, tok, PARITY_POLICY, num_steps=2)
    assert np.abs(moved - imgs).max() > 1e-4
    path = str(tmp_path / "v" / "grid.png")
    save_image_grid(imgs, path, per_row=1)
    from PIL import Image

    grid = np.asarray(Image.open(path))
    assert grid.shape == (128, 64, 3)
    assert np.array_equal(grid[64:], (np.clip(imgs[1], 0, 1) * 255).astype(np.uint8))


def test_generate_class_images(tmp_path):
    """Only the missing images, batch by batch, the i-th from seed i,
    named <i>-<sha1 of its bytes>.jpg."""
    calls = []

    def pipe(prompt, num_inference_steps, seed):
        calls.append((len(prompt), seed, num_inference_steps))
        return np.stack([np.full((8, 8, 3), (seed + i) / 10, np.float32) for i in range(len(prompt))])

    d = str(tmp_path / "cls")
    os.makedirs(d)
    open(os.path.join(d, "old.png"), "w").close()
    assert idbooth_driver.generate_class_images(pipe, d, "photo of a person", 6, batch_size=2,
                                                num_inference_steps=3) == 6
    assert calls == [(2, 1, 3), (2, 3, 3), (1, 5, 3)]
    names = sorted(f for f in os.listdir(d) if f.endswith(".jpg"))
    assert [n.split("-")[0] for n in names] == ["1", "2", "3", "4", "5"] and all(len(n) == 2 + 40 + 4 for n in names)


def _sweep_tree(root):
    sizes = {"id_1": 3, "id_2": 3, "id_3": 5, "id_4": 3, "id_5": 5, "id_6": 1, "id_10": 3}
    for ident, n in sizes.items():
        os.makedirs(os.path.join(root, "src", ident))
        for i in range(n):
            open(os.path.join(root, "src", ident, f"{i}.jpg"), "w").close()
    os.makedirs(os.path.join(root, "class"))
    for i in range(2):
        open(os.path.join(root, "class", f"{i}.png"), "w").close()


@pytest.mark.parametrize("vmap_identities", [1, 2])
def test_run_experiment_sweep_matches_jax(tmp_path, monkeypatch, vmap_identities):
    """Folders, config snapshots, and which identities train alone or in
    groups (by steps per epoch), against JAX's sweep on the same directory
    sizes; the runs themselves are recorded, not trained."""
    _sweep_tree(str(tmp_path))
    calls = {"port": [], "jax": []}

    def recorder(side, kind):
        def run(cfg, bundle, frozen, **kw):
            out = kw["output_dirs"] if kind == "group" else [kw["output_dir"]]
            calls[side].append((kind, cfg.which_loss, [os.path.relpath(o, str(tmp_path / side)) for o in out]))
            return ([], [[{"epoch": 0}]] * len(out)) if kind == "group" else ({}, [{"epoch": 0}])
        return run

    monkeypatch.setattr(idbooth_driver, "run_identity", recorder("port", "serial"))
    monkeypatch.setattr(multi_identity, "run_identities_vmapped", recorder("port", "group"))
    monkeypatch.setattr(jdriver, "run_identity", recorder("jax", "serial"))
    monkeypatch.setattr(jmulti, "run_identities_vmapped", recorder("jax", "group"))
    kw = dict(losses_to_test=("", "triplet_prior"), train_batch_size=1)
    src, cls = str(tmp_path / "src"), str(tmp_path / "class")
    mine = idbooth_driver.run_experiment_sweep(idbooth.IDBoothConfig(**kw), TINY, {}, src, str(tmp_path / "port"),
                                               class_dir=cls, vmap_identities=vmap_identities)
    ref = jdriver.run_experiment_sweep(jidbooth.IDBoothConfig(**kw), None, {}, src, str(tmp_path / "jax"),
                                       class_dir=cls, vmap_identities=vmap_identities)
    assert calls["port"] == calls["jax"] and len(calls["port"]) == (14 if vmap_identities == 1 else 8)
    assert sorted(mine) == sorted(ref) and len(mine) == 14
    assert sorted(os.listdir(tmp_path / "port")) == ["DreamBooth", "ID-Booth"]
    for folder in ("DreamBooth", "ID-Booth"):
        with open(tmp_path / "port" / folder / "training_config.json") as f, \
                open(tmp_path / "jax" / folder / "training_config.json") as g:
            assert f.read() == g.read()
    if vmap_identities == 2:
        groups = [c[2] for c in calls["port"] if c[0] == "group" and c[1] == ""]
        assert groups == [["DreamBooth/id_1", "DreamBooth/id_2"], ["DreamBooth/id_4", "DreamBooth/id_10"],
                          ["DreamBooth/id_3", "DreamBooth/id_5"]]


def test_logging_and_tracker(tmp_path):
    meter = logging_utils.AverageMeter()
    for v, n in ((1.0, 1), (4.0, 2)):
        meter.update(v, n)
    assert meter.avg == 3.0 and meter.val == 4.0
    tree = {"a": torch.ones(2), "b": [torch.tensor([1.0, float("nan")]), None], "i": torch.arange(3)}
    with pytest.raises(FloatingPointError, match="b/0"):
        logging_utils.nan_check(tree, "state")
    assert logging_utils.nan_check({"a": torch.ones(2)})
    logger = logging_utils.setup_logging(str(tmp_path), name="fpg-test")
    tp = logging_utils.ThroughputLogger(frequency=2, total_steps=10, logger=logger)
    assert tp(1, 4) is None and tp(2, 4)["step"] == 2
    with logging_utils.profile_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))
    tracker = Tracker(str(tmp_path / "logs"), backend="jsonl")
    tracker.log_scalars(3, {"loss": torch.tensor(0.5)})
    tracker.log_images(3, "val", np.zeros((2, 4, 4, 3), np.float32))
    tracker.close()
    with open(tmp_path / "logs" / "scalars.jsonl") as f:
        rec = json.loads(f.read())
    assert rec["step"] == 3 and rec["loss"] == 0.5
    assert sorted(os.listdir(tmp_path / "logs" / "images")) == ["val_3_0.png", "val_3_1.png"]
    for h in logger.handlers:
        h.close()
