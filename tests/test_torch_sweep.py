"""The rest of the port's sweep and its FIQA / pose harness against the JAX
package: the prompt grid, `per_prompt_noise`'s contract, `run_sweep`
unpacked and packed against JAX `run_sweep`, the packed tree against the
unpacked one, RepVGG and `fuse_branches`, the 6D-rotation math, the pose
and quality functions (also on uint8 images resized on the device), the
scoring and aggregation helpers, IResNet's features and the non-square
`resize_bilinear`; and the batch engine's images against JAX's sampler on
the same program JAX compiles for the packed sweep (batch 4, per-sample
adapters, 128²), so that JAX compiles it once.

The sweep runs the tiny serving models of tests/test_torch_serving.py at
128² (see `H`), 3 DDPM steps, 2 variants with a LoRA file each (written
by the port's `save_lora_safetensors`, read by both packages), 3 prompts
of one identity, batch 4: at batch 2 the 6 packed slots leave no pad slot, at 4 the last
packed batch has 2. Both sides' noise is replaced by one numpy table keyed
by prompt index, as tests/test_torch_driver.py:425 replaces the training
sweep's runs: the pipelines below look the prompt of each row up and pass
its stream as `noise_override`. JAX's sweeps (one compile each) and its
harness functions run on worker threads while the port works.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.evaluation import fiqa as jfiqa
from faceposegenerator_tpu.evaluation import pose as jpose
from faceposegenerator_tpu.models import iresnet as jiresnet
from faceposegenerator_tpu.models import repvgg as jrepvgg
from faceposegenerator_tpu.ops import image as jimage
from faceposegenerator_tpu.pipelines import sweep as jsweep
from faceposegenerator_tpu.pipelines.txt2img import StableDiffusionPipeline as JPipeline
from faceposegenerator_tpu_torch.bridge.jax_params import load_jax_params
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.diffusion.lora_io import save_lora_safetensors
from faceposegenerator_tpu_torch.diffusion.sampler import per_prompt_noise, sample
from faceposegenerator_tpu_torch.evaluation import fiqa, pose
from faceposegenerator_tpu_torch.models import iresnet, repvgg
from faceposegenerator_tpu_torch.ops.image import resize_bilinear
from faceposegenerator_tpu_torch.pipelines import sweep
from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline
from faceposegenerator_tpu_torch.serving import GenerationRequest, SamplerServer
from faceposegenerator_tpu_torch.serving.engine import request_noise

from test_torch_checkpoints import numpy_init
from test_torch_serving import build_pipes, one_torch_thread  # noqa: F401 (autouse)

# 128², not the serving tests' 64²: at 64² the tiny UNet's bottom level is
# 1×1, its GroupNorm groups hold 2 values, and the two packages' fp32
# outputs drift apart by up to ~2e-3 on some inputs (tests/test_torch_serving.py)
S, H = 3, 128
IDENTITY, GENDERS = "id_3", {"id_3": "woman"}
VARIANTS = ("DreamBooth", "ID-Booth")
SWEEP = dict(identities=[IDENTITY], models_to_test=VARIANTS, num_prompts=3, num_inference_steps=S,
             guidance_scale=5.0, batch_size=4, seed=0, height=H, width=H, writer_threads=2)
# a small RepVGG (the B1g2 pattern: groups of 2 on every other layer) and IResNet
REPVGG = dict(num_blocks=(1, 2, 1, 1), width_multiplier=(0.25, 0.25, 0.25, 0.5))
IRESNET = dict(depths=(1, 1, 1, 1), num_features=64)


def table_noise(prompts):
    """The numpy noise table both sweeps draw from: (S+1, P, h, w, 4)."""
    rng = np.random.default_rng(8)
    return rng.standard_normal((S + 1, len(prompts), H // 8, H // 8, 4)).astype(np.float32)


def with_table_noise(base, prompts, to_array):
    """`base` (a pipeline class) whose calls take each row's stream from
    `table_noise(prompts)`, by the row's prompt (or its token ids)."""
    table = table_noise(prompts)

    class TableNoise(base):
        def __call__(self, prompt=None, negative_prompt=None, **kw):
            ids = np.asarray(kw["input_ids"] if kw.get("input_ids") is not None else self.tokenize(prompt))
            known = np.asarray(self.tokenize(prompts))
            rows = [int(np.flatnonzero((known == row).all(axis=1))[0]) for row in ids]
            kw["noise_override"] = to_array(table[:, rows])
            return super().__call__(prompt, negative_prompt, **kw)

    return TableNoise


def write_loras(root, pipe, loras):
    """A LoRA file for each variant under <root>/<variant>/<identity>/<checkpoint>."""
    for variant, name in zip(VARIANTS, ("A", "B")):
        d = os.path.join(root, variant, IDENTITY, "checkpoint-31-6400")
        save_lora_safetensors(loras[name], os.path.join(d, "pytorch_lora_weights.safetensors"))


def png_tree(root):
    return {os.path.relpath(os.path.join(d, f), root): np.asarray(Image.open(os.path.join(d, f)))
            for d, _, fs in os.walk(root) for f in fs if f.endswith(".png")}


def sixdrepnet_tree(cfg, seed=0):
    """JAX `pose.init_sixdrepnet`'s tree at its scales (He-normal convs,
    zero biases, an N(0, 1/feat) head), drawn by numpy: JAX's eager init
    costs seconds."""
    rng = np.random.default_rng(seed)
    layers = [{"w": (rng.standard_normal((3, 3, cin // g, cout)) * (2.0 / (9 * cin // g)) ** 0.5).astype(np.float32),
               "b": np.zeros(cout, np.float32), "stride": s, "groups": g}
              for cin, cout, s, g in jrepvgg._layer_plan(cfg)]
    feat = layers[-1]["w"].shape[-1]
    head = {"w": (rng.standard_normal((6, feat)) * feat**-0.5).astype(np.float32), "b": np.zeros(6, np.float32)}
    return {"backbone": {"layers": layers}, "head": head}


def _jax_harness(images_u8, small_u8, faces, sixd, rots):
    """JAX's pose and quality functions on the inputs, and the trees they ran."""
    jcfg = jrepvgg.RepVGGConfig(**REPVGG)
    pose_params = sixdrepnet_tree(jcfg)
    icfg = jiresnet.IResNetConfig(**IRESNET)
    params, state = numpy_init(jiresnet.init, icfg, 5)
    qs = jfiqa.init_qs_head(jax.random.key(1), fc_in=512 * 49)
    out = dict(trees=(pose_params, params, state, qs))
    out["pose"] = np.asarray(jpose.make_pose_fn(pose_params, jcfg)(faces["pose"]))
    out["pose_u8"] = np.asarray(jpose.make_pose_fn_u8(pose_params, jcfg)(images_u8))
    emb, q = jfiqa.make_quality_fn(params, state, qs, icfg, policy=JPOLICY)(faces["fiqa"])
    out["quality"] = (np.asarray(emb), np.asarray(q))
    emb, q = jfiqa.make_quality_fn_u8(params, state, qs, icfg, policy=JPOLICY)(small_u8)
    out["quality_u8"] = (np.asarray(emb), np.asarray(q))
    out["features"] = np.asarray(jax.jit(lambda x: jiresnet.apply(params, state, x, icfg, policy=JPOLICY, train=False,
                                                                  return_features=True)[2])(faces["fiqa"]))
    euler = jax.jit(jpose.euler_from_rotation)
    r = jax.jit(jpose.rotation_from_ortho6d)(sixd)
    e = euler(r)
    out["rotation"], out["euler"] = np.asarray(r), np.asarray(e)
    out["euler_rots"] = np.asarray(euler(rots))
    return out


# the engine comparison's batch of 4: adapters A, B, none, A (the packed
# sweep's program: batch 4, per-sample adapters, 128², 3 steps)
ENGINE_REQS = [("face portrait photo of woman sks person", 7, "A"),
               ("face side-portrait photo of man sks person, forest background", 9, "B"),
               ("face portrait photo of old man sks person", 11, None),
               ("face portrait photo of young woman sks person, beach background", 13, "A")]


def _engine_noise():
    return request_noise([s for _, s, _ in ENGINE_REQS], S, H // 8, H // 8, "cpu")


def _jax_engine(p):
    """JAX `sample` (through its pipeline) on the engine's batch."""
    jp = p["jpipe"]
    zero = jax.tree.map(jnp.zeros_like, p["jloras"]["A"])
    trees = [p["jloras"][i] if i else zero for _, _, i in ENGINE_REQS]
    return np.asarray(jp(input_ids=jp.tokenize([q for q, _, _ in ENGINE_REQS]),
                         negative_input_ids=jp.tokenize([""] * len(ENGINE_REQS)),
                         lora=jax.tree.map(lambda *xs: jnp.stack(xs), *trees),
                         lora_scale=jnp.ones((len(ENGINE_REQS),), jnp.float32),
                         noise_override=jnp.asarray(_engine_noise().numpy()), num_inference_steps=S,
                         guidance_scale=5.0, height=H, width=H, output_type="np"))


def _jax_sweep(p, tmp, lora_root, pack):
    prompts = jsweep.build_prompts(IDENTITY, GENDERS, jsweep.build_prompt_combinations(), 3, seed=0)
    jp = p["jpipe"]
    pipe = with_table_noise(JPipeline, prompts, jnp.asarray)(jp.params, jp.models, tokenizer=jp.tokenizer,
                                                             policy=JPOLICY)
    out = os.path.join(tmp, f"jax_{'packed' if pack else 'unpacked'}")
    jsweep.run_sweep(pipe, lora_root, out, gender_dict_path=os.path.join(tmp, "genders.json"),
                     pack_variants=pack, **SWEEP)
    if pack:  # the same program, compiled by now
        return png_tree(out), _jax_engine(p)
    return png_tree(out)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sweep"))
    p = build_pipes()
    with open(os.path.join(tmp, "genders.json"), "w") as f:
        json.dump(GENDERS, f)
    lora_root = os.path.join(tmp, "loras")
    write_loras(lora_root, p["pipe"], p["loras"])
    rng = np.random.default_rng(9)
    inputs = dict(images_u8=rng.integers(0, 256, (3, 72, 56, 3), dtype=np.uint8),
                  small_u8=rng.integers(0, 256, (2, 128, 96, 3), dtype=np.uint8),
                  faces=dict(pose=rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
                             fiqa=rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)),
                  sixd=np.concatenate([rng.standard_normal((6, 6)),
                                       [[1e-9, 1e-9, 1.0, 1.0, 0.0, 0.0]]]).astype(np.float32),
                  # the identity and a yaw of 90° (sy = 0: the gimbal-locked branch)
                  rots=np.array([np.eye(3), [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]], np.float32))
    pool = ThreadPoolExecutor(max_workers=3)
    jobs = {"unpacked": pool.submit(_jax_sweep, p, tmp, lora_root, False),
            "packed": pool.submit(_jax_sweep, p, tmp, lora_root, True),
            "harness": pool.submit(_jax_harness, **inputs)}
    yield dict(p, tmp=tmp, lora_root=lora_root, jobs=jobs, **inputs)
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def port_sweeps(setup):
    """The port's sweeps, unpacked and packed, with the names `on_images` saw."""
    prompts = sweep.build_prompts(IDENTITY, GENDERS, sweep.build_prompt_combinations(), 3, seed=0)
    pipe = setup["pipe"]
    noisy = with_table_noise(StableDiffusionPipeline, prompts, torch.from_numpy)(
        pipe.nets, pipe.models, pipe.policy, tokenizer=pipe.tokenizer)
    trees, seen = {}, {}
    for pack in (False, True):
        key = "packed" if pack else "unpacked"
        out = os.path.join(setup["tmp"], f"port_{key}")
        seen[key] = []

        def hook(model, identity, names, images, key=key):
            assert isinstance(images, torch.Tensor) and images.dtype == torch.uint8
            seen[key].append((model, identity, list(names), tuple(images.shape)))

        sweep.run_sweep(noisy, setup["lora_root"], out, gender_dict_path=os.path.join(setup["tmp"], "genders.json"),
                        pack_variants=pack, on_images=hook, **SWEEP)
        trees[key] = png_tree(out)
    return prompts, trees, seen


def test_build_prompts_match_jax(setup):
    """(Asking for `setup` starts JAX's runs first.)"""
    combos = sweep.build_prompt_combinations()
    assert combos == jsweep.build_prompt_combinations()
    for kw in (dict(add_age=True), dict(add_background=False, add_age=True), dict(num_prompts=100),
               dict(add_background=False, num_prompts=5)):
        assert sweep.build_prompt_combinations(**kw) == jsweep.build_prompt_combinations(**kw)
    genders = {"id_1": "man", "id_2": "woman"}
    for seed in range(4):
        for ident in ("id_1", "id_2", "id_9"):
            got = sweep.build_prompts(ident, genders, combos, 21, seed=seed)
            assert got == jsweep.build_prompts(ident, genders, combos, 21, seed=seed) and len(got) == 21
    assert sweep.build_prompts("id_1", genders, combos, 3, add_gender=False, add_pose=False) == \
        jsweep.build_prompts("id_1", genders, combos, 3, add_gender=False, add_pose=False)
    assert (sweep.BACKGROUNDS, sweep.AGE_PHASES, sweep.DEFAULT_NEGATIVE, sweep.MODEL_VARIANTS) == \
        (jsweep.BACKGROUNDS, jsweep.AGE_PHASES, jsweep.DEFAULT_NEGATIVE, jsweep.MODEL_VARIANTS)


def test_per_prompt_noise_keys_streams_by_identity_and_prompt():
    a = per_prompt_noise(3, [0, 1, 2, 0], S, 8, 8, "cpu")
    b = per_prompt_noise(3, [2, 0], S, 8, 8, "cpu")
    assert a.shape == (S + 1, 4, 8, 8, 4) and a.dtype == torch.float32
    assert torch.equal(a[:, 0], a[:, 3]) and torch.equal(a[:, 0], b[:, 1]) and torch.equal(a[:, 2], b[:, 0])
    assert not torch.equal(a[:, 0], a[:, 1]) and not torch.equal(a[:, 1], a[:, 2])
    other = per_prompt_noise(4, [0], S, 8, 8, "cpu")
    assert not torch.equal(other[:, 0], a[:, 0])
    assert abs(float(a.mean())) < 0.1 and abs(float(a.std()) - 1.0) < 0.1


def test_run_sweep_matches_jax(setup, port_sweeps):
    """File names equal, every image within 1 uint8 code of JAX's, in both modes."""
    prompts, trees, _ = port_sweeps
    assert len(set(prompts)) == len(prompts)  # the table is keyed by prompt
    for key in ("unpacked", "packed"):
        want = setup["jobs"][key].result()
        want = want[0] if key == "packed" else want
        got = trees[key]
        assert sorted(got) == sorted(want)
        assert len(got) == 2 * 3 + 1  # 2 variants × 3 prompts and the comparison grid
        for name in got:
            assert np.abs(got[name].astype(int) - want[name].astype(int)).max() <= 1, (key, name)


def test_packed_tree_matches_unpacked(port_sweeps):
    """The packed sweep writes the unpacked sweep's files and images (within
    1 uint8 code); its hooks see 2 mixed batches, the last with 2 pad slots."""
    _, trees, seen = port_sweeps
    assert sorted(trees["packed"]) == sorted(trees["unpacked"])
    for name, img in trees["packed"].items():
        assert np.abs(img.astype(int) - trees["unpacked"][name].astype(int)).max() <= 1, name
    assert [s[0] for s in seen["unpacked"]] == list(VARIANTS)
    assert seen["unpacked"][0][2] == [f"{IDENTITY}_{i:03d}.png" for i in range(3)]
    packed = seen["packed"]
    assert [s[0] for s in packed] == [None, None] and all(s[3] == (4, H, H, 3) for s in packed)
    names = packed[0][2] + packed[1][2]
    assert names[:6] == [f"{v}/{IDENTITY}_{i:03d}.png" for v in VARIANTS for i in range(3)]
    assert names[6:] == [None, None]


def test_engine_matches_jax_sample(setup):
    """The batch engine's batch (`multi_lora`, adapters A, B, none, A) against
    JAX `sample` on the same tokens, adapters and noise: 3e-4 before
    quantizing, so uint8 within 1 code."""
    pipe = setup["pipe"]
    server = SamplerServer(pipe, batch_size=len(ENGINE_REQS), max_wait_s=5.0, multi_lora=True,
                           num_inference_steps=S, height=H, width=H)
    try:
        for name, tree in setup["loras"].items():
            server.register_lora(name, tree)
        got = server.generate([GenerationRequest(prompt=q, seed=s, lora_id=i) for q, s, i in ENGINE_REQS])
        lora, scale = server._stacked_lora(tuple(i for _, _, i in ENGINE_REQS))
        fp32 = sample(pipe.nets, server._schedule, pipe.tokenize([q for q, _, _ in ENGINE_REQS]),
                      pipe.tokenize([""] * len(ENGINE_REQS)), guidance_scale=5.0, height=H, width=H,
                      policy=PARITY_POLICY, lora=lora, lora_scale=scale, noise_override=_engine_noise()).numpy()
    finally:
        server.shutdown()
    want = setup["jobs"]["packed"].result()[1]
    np.testing.assert_allclose(fp32, want, atol=3e-4, rtol=0)
    want_u8 = np.clip(np.round(want * 255.0), 0, 255)
    for b, res in enumerate(got):
        assert np.abs(res.image.astype(int) - want_u8[b]).max() <= 1
        np.testing.assert_array_equal(res.image, np.clip(np.round(fp32[b] * 255.0), 0, 255).astype(np.uint8))


def test_missing_checkpoint_runs_the_base_model(setup, tmp_path):
    """A variant without a checkpoint runs the base model in both modes
    (the port's unpacked mode unloads the previous variant's adapter)."""
    pipe = setup["pipe"]
    lora_root = str(tmp_path / "loras")
    d = os.path.join(lora_root, VARIANTS[0], IDENTITY, "checkpoint-31-6400")
    save_lora_safetensors(setup["loras"]["A"], os.path.join(d, "pytorch_lora_weights.safetensors"))
    kw = dict(SWEEP, num_prompts=1, batch_size=2)
    for pack in (False, True):
        out = str(tmp_path / f"out{pack}")
        sweep.run_sweep(pipe, lora_root, out, pack_variants=pack, **kw)
        tree = png_tree(out)
        name = f"{IDENTITY}_000.png"
        base = pipe(sweep.build_prompts(IDENTITY, {}, sweep.build_prompt_combinations(), 1, seed=0),
                    negative_prompt=sweep.DEFAULT_NEGATIVE, num_inference_steps=S, height=H, width=H,
                    seed=3, output_type="u8")[0] if not pack else None
        if base is not None:
            np.testing.assert_array_equal(tree[os.path.join(VARIANTS[1], IDENTITY, name)], base)
        assert np.abs(tree[os.path.join(VARIANTS[0], IDENTITY, name)].astype(int)
                      - tree[os.path.join(VARIANTS[1], IDENTITY, name)]).max() >= 1
    assert pipe.lora is None


# --- the harness --------------------------------------------------------------


@pytest.fixture(scope="module")
def harness(setup):
    """The port's pose and quality models on JAX's trees, and JAX's outputs."""
    j = setup["jobs"]["harness"].result()
    pose_params, params, state, qs = j["trees"]
    sixd = pose.init_sixdrepnet(repvgg.RepVGGConfig(**REPVGG), device="cpu")
    load_jax_params(sixd, jax.tree.map(lambda x: np.asarray(x) if hasattr(x, "shape") else x, pose_params))
    net = iresnet.IResNet(iresnet.IResNetConfig(**IRESNET), device="cpu")
    load_jax_params(net, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    head = fiqa.init_qs_head(device="cpu")
    load_jax_params(head, jax.tree.map(np.asarray, qs))
    return dict(j, sixd=sixd, net=net, head=head)


def test_rotation_math_matches_jax(setup, harness):
    """Gram-Schmidt and the Euler angles, a gimbal-locked row included: 1e-5."""
    r = pose.rotation_from_ortho6d(torch.from_numpy(setup["sixd"]))
    np.testing.assert_allclose(r.numpy(), harness["rotation"], atol=1e-5, rtol=0)
    e = pose.euler_from_rotation(torch.cat([r, torch.from_numpy(setup["rots"])]))
    want = np.concatenate([harness["euler"], harness["euler_rots"]])
    np.testing.assert_allclose(e.numpy(), want, atol=1e-5, rtol=0)
    assert np.allclose(e[-1].numpy(), [0.0, 90.0, 0.0], atol=1e-4)
    for m in r.numpy():
        np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-5)


def test_fuse_branches_matches_jax_and_the_train_time_branches():
    rng = np.random.default_rng(11)
    cout, cin, groups = 8, 8, 2

    def bn():
        return {"g": rng.uniform(0.5, 1.5, cout), "b": rng.standard_normal(cout) * 0.1,
                "mean": rng.standard_normal(cout) * 0.1, "var": rng.uniform(0.5, 1.5, cout)}

    w3, w1 = rng.standard_normal((cout, cin // groups, 3, 3)), rng.standard_normal((cout, cin // groups, 1, 1))
    bn3, bn1, bnid = bn(), bn(), bn()
    w, b = repvgg.fuse_branches(w3, bn3, w1, bn1, bnid, groups=groups)
    jw, jb = jrepvgg.fuse_branches(w3, bn3, w1, bn1, bnid, groups=groups)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(b, jb)
    x = torch.from_numpy(rng.standard_normal((2, cin, 6, 6)))

    def bn_apply(y, p):
        t = {k: torch.from_numpy(v)[None, :, None, None] for k, v in p.items()}
        return (y - t["mean"]) / torch.sqrt(t["var"] + 1e-5) * t["g"] + t["b"]

    branches = (bn_apply(F.conv2d(x, torch.from_numpy(w3), padding=1, groups=groups), bn3)
                + bn_apply(F.conv2d(x, torch.from_numpy(w1), groups=groups), bn1) + bn_apply(x, bnid))
    fused = F.conv2d(x, torch.from_numpy(w), torch.from_numpy(b), padding=1, groups=groups)
    np.testing.assert_allclose(fused.numpy(), branches.numpy(), atol=1e-10)


def test_pose_fns_match_jax(setup, harness):
    """The 6DRepNet on JAX's weights (2e-4), on normalised faces and on
    uint8 images padded and resized on the device; then the helpers."""
    sixd = harness["sixd"]
    assert [(c.stride[0], c.groups) for c in sixd.backbone.layers] == [
        (s, g) for _, _, s, g in jrepvgg._layer_plan(jrepvgg.RepVGGConfig(**REPVGG))]
    np.testing.assert_allclose(pose.make_pose_fn(sixd)(setup["faces"]["pose"]).numpy(), harness["pose"],
                               atol=2e-4, rtol=0)
    fn_u8 = pose.make_pose_fn_u8(sixd)
    np.testing.assert_allclose(fn_u8(setup["images_u8"]).numpy(), harness["pose_u8"], atol=2e-4, rtol=0)
    per_id = pose.poses_for_images(torch.from_numpy(setup["images_u8"]), ["a", "b", "a"], fn_u8, batch_size=2)
    assert sorted(per_id) == ["a", "b"] and len(per_id["a"]) == 2
    np.testing.assert_allclose(per_id["a"][1], harness["pose_u8"][2], atol=2e-4)
    agg = pose.aggregate_poses(per_id)
    ref = jpose.aggregate_poses(per_id)
    assert json.dumps(agg, sort_keys=True) == json.dumps(ref, sort_keys=True)
    img = setup["images_u8"][0]
    np.testing.assert_array_equal(pose.preprocess_for_pose(img), jpose.preprocess_for_pose(img))


def test_estimate_dataset_poses_and_score_dataset(setup, harness, tmp_path):
    """The folder walkers on a small tree, against JAX's walkers given the
    port's functions (their file handling and output files are the same)."""
    root = tmp_path / "imgs"
    for ident in ("1", "2"):
        (root / ident).mkdir(parents=True)
        for i in range(3):
            Image.fromarray(setup["images_u8"][i]).save(root / ident / f"{i}.png")
    pose_fn = pose.make_pose_fn(harness["sixd"])
    got = pose.estimate_dataset_poses(str(root), pose_fn, str(tmp_path / "p.json"), batch_size=4)
    want = jpose.estimate_dataset_poses(str(root), lambda x: pose_fn(x).numpy(), str(tmp_path / "j.json"),
                                        batch_size=4)
    assert got == want and got["global"]["count"] == 6
    qfn = fiqa.make_quality_fn(harness["net"], harness["head"], PARITY_POLICY)
    got = fiqa.score_dataset(str(root), qfn, str(tmp_path / "q.txt"), max_images=5, batch_size=2)
    want = jfiqa.score_dataset(str(root), lambda x: tuple(t.numpy() for t in qfn(x)), str(tmp_path / "jq.txt"),
                               max_images=5, batch_size=2)
    assert got == want and len(got) == 5
    assert (tmp_path / "q.txt").read_text() == (tmp_path / "jq.txt").read_text()


def test_quality_fns_match_jax(setup, harness, tmp_path):
    """IResNet's features and CR-FIQA's head on JAX's weights (2e-4), on
    [-1, 1] faces and on uint8 images resized to 112² on the device."""
    net, head = harness["net"], harness["head"]
    faces = torch.from_numpy(setup["faces"]["fiqa"])
    with torch.inference_mode():
        emb, feats = net(faces, PARITY_POLICY, return_features=True)
        assert torch.equal(emb, net(faces, PARITY_POLICY))
    np.testing.assert_allclose(feats.numpy(), harness["features"], atol=2e-4, rtol=0)
    for fn, x, key in ((fiqa.make_quality_fn, setup["faces"]["fiqa"], "quality"),
                       (fiqa.make_quality_fn_u8, setup["small_u8"], "quality_u8")):
        e, q = fn(net, head, PARITY_POLICY)(x)
        np.testing.assert_allclose(e.numpy(), harness[key][0], atol=2e-4, rtol=0)
        np.testing.assert_allclose(q.numpy(), harness[key][1], atol=2e-4, rtol=0)
    fn_u8 = fiqa.make_quality_fn_u8(net, head, PARITY_POLICY)
    out = str(tmp_path / "scores.txt")
    scores = fiqa.score_images(torch.from_numpy(setup["small_u8"]), ["x.png", "y.png"], fn_u8, out, batch_size=1)
    np.testing.assert_allclose([scores["x.png"], scores["y.png"]], harness["quality_u8"][1], atol=2e-4)
    assert open(out).read().splitlines()[1].startswith("y.png ")
    with pytest.raises(ValueError):
        fiqa.score_images(torch.from_numpy(setup["small_u8"]), ["x.png"], fn_u8)


def test_convert_qs_from_state_dict_matches_jax():
    rng = np.random.default_rng(12)
    sd = {"qs.weight": rng.standard_normal((1, 512 * 49)).astype(np.float32),
          "qs.bias": rng.standard_normal(1).astype(np.float32)}
    got, want = fiqa.convert_qs_from_state_dict(sd), jfiqa.convert_qs_from_state_dict(sd)
    for k in ("w", "b"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    head = load_jax_params(fiqa.init_qs_head(device="cpu"), got)
    assert torch.equal(head.weight, torch.from_numpy(got["w"]))


@pytest.mark.parametrize("out_hw", [(112, 112), (40, 90), (160, 120)], ids=["square", "down", "up"])
def test_resize_bilinear_matches_jax(out_hw):
    """Square outputs through the crop path, others as `jax.image.resize`
    (antialiased when shrinking), from a non-square input: 3e-4 on [0, 255]
    (about 1e-6 of the range: fp32 rounding of the filter taps)."""
    x = np.random.default_rng(13).uniform(0, 255, (2, 72, 100, 3)).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(x), out_hw).numpy()
    want = np.asarray(jimage.resize_bilinear(jnp.asarray(x), out_hw))
    assert got.shape == want.shape == (2, *out_hw, 3)
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=0)
