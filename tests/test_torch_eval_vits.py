"""The port's ViT encoders (DINOv2, the MAE ViT, CLIP vision, Data2Vec-Vision)
against the JAX package's at tiny configs with head dim 64, fp32 (JAX
PARITY_POLICY; the port's PARITY_POLICY, TF32 off on a card), trees in JAX
`init`'s layout with seeded values carried over by
`bridge.jax_params.load_jax_params`: features within 2e-4 of their max abs. DINOv2's position-embedding resize against
`jax.image.resize(method="bicubic")` at 37→16 (downsampling, antialiased)
and 4→7 (upsampling), within 1e-5 of the max abs. The converters on
reference-layout state dicts (DINOv2 hub and transformers layouts, CLIP's
transformers layout with and without `vision_model.`, Data2Vec's
transformers layout): the port's tree equals JAX's leaf for leaf and loads
into the module. Those state dicts are written by `_state_dict` from the
key layouts the converters read, with random values: importing
`transformers` here would cost more than this file's time budget."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.bridge import torch_weights as jtw
from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.models import clip_vision as jclip
from faceposegenerator_tpu.models import data2vec_vision as jd2v
from faceposegenerator_tpu.models import dinov2 as jdino
from faceposegenerator_tpu_torch.bridge import torch_weights as tw
from faceposegenerator_tpu_torch.bridge.jax_params import load_jax_params
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.models import clip_vision, data2vec_vision, dinov2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel=2e-4):
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * float(np.abs(want).max()), err


TINY = dict(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256)  # head dim 64


def numpy_init(init, cfg, seed):
    """JAX `init`'s tree shapes (`jax.eval_shape`, no compile) filled from a
    seed: norm scales ("g") 1 + N(0, 0.1²), every other leaf N(0, 0.05²)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", None)
        x = rng.standard_normal(s.shape).astype(np.float32)
        return jnp.asarray(1.0 + 0.1 * x if name == "g" else 0.05 * x)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(lambda k: init(k, cfg), jax.random.key(0)))


def _dinov2_case(layerscale):
    cfg = jdino.DINOv2Config(**TINY, patch_size=14, image_size=98, layerscale=layerscale)  # trained grid 7 → 4
    params = numpy_init(jdino.init, cfg, 1)
    want = lambda x: jdino.cls_feature(params, x, cfg, policy=JPOLICY)  # noqa: E731
    model = dinov2.DINOv2(dinov2.DINOv2Config(**dataclasses.asdict(cfg)), device="cpu")
    return params, want, model, lambda m, x: m.cls_feature(x, PARITY_POLICY)


def _clip_case():
    cfg = jclip.CLIPVisionConfig(**TINY, patch_size=14, image_size=56)
    params = numpy_init(jclip.init, cfg, 3)
    want = lambda x: jclip.cls_feature(params, x, cfg, policy=JPOLICY)  # noqa: E731
    model = clip_vision.CLIPVision(clip_vision.CLIPVisionConfig(**dataclasses.asdict(cfg)), device="cpu")
    return params, want, model, lambda m, x: m.cls_feature(x, PARITY_POLICY)


def _data2vec_case():
    cfg = jd2v.Data2VecVisionConfig(**TINY, patch_size=14, image_size=56)
    params = numpy_init(jd2v.init, cfg, 5)
    want = lambda x: jd2v.pooled_feature(params, x, cfg)  # noqa: E731
    model = data2vec_vision.Data2VecVision(data2vec_vision.Data2VecVisionConfig(**dataclasses.asdict(cfg)),
                                           device="cpu")
    return params, want, model, lambda m, x: m.pooled_feature(x)


CASES = {"dinov2": lambda: _dinov2_case(True), "mae": lambda: _dinov2_case(False), "clip": _clip_case,
         "data2vec": _data2vec_case}


@pytest.mark.parametrize("name", list(CASES))
def test_vit_encoders_match_jax(name):
    params, want_fn, model, got_fn = CASES[name]()
    x = np.random.default_rng(6).standard_normal((2, 56, 56, 3)).astype(np.float32)
    want = jax.jit(want_fn)(jnp.asarray(x))
    model = load_jax_params(model, _np(params))
    assert not any(p.requires_grad for p in model.parameters())
    with torch.no_grad():
        got = got_fn(model, torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("src,grid", [(37, 16), (4, 7)])
def test_pos_embed_resize_matches_jax_bicubic(src, grid):
    pos = np.random.default_rng(src).standard_normal((1, 1 + src * src, 8)).astype(np.float32)
    want = jdino._interpolate_pos_embed(jnp.asarray(pos), grid)
    got = dinov2.interpolate_pos_embed(torch.from_numpy(pos), grid)
    _close(got.numpy(), want, rel=1e-5)
    assert torch.equal(dinov2.interpolate_pos_embed(torch.from_numpy(pos), src), torch.from_numpy(pos))


def _state_dict(shapes: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def _layers(n, spec):
    return {f"{p.format(i=i)}": s for i in range(n) for p, s in spec.items()}


D, M, P = 128, 256, 14


def _dinov2_hub(ls=True):
    keys = {"patch_embed.proj.weight": (D, 3, P, P), "patch_embed.proj.bias": (D,), "cls_token": (1, 1, D),
            "pos_embed": (1, 50, D), "norm.weight": (D,), "norm.bias": (D,)}
    spec = {"blocks.{i}.attn.qkv.weight": (3 * D, D), "blocks.{i}.attn.qkv.bias": (3 * D,),
            "blocks.{i}.attn.proj.weight": (D, D), "blocks.{i}.attn.proj.bias": (D,),
            "blocks.{i}.norm1.weight": (D,), "blocks.{i}.norm1.bias": (D,), "blocks.{i}.norm2.weight": (D,),
            "blocks.{i}.norm2.bias": (D,), "blocks.{i}.mlp.fc1.weight": (M, D), "blocks.{i}.mlp.fc1.bias": (M,),
            "blocks.{i}.mlp.fc2.weight": (D, M), "blocks.{i}.mlp.fc2.bias": (D,)}
    if ls:
        spec.update({"blocks.{i}.ls1.gamma": (D,), "blocks.{i}.ls2.gamma": (D,)})
    return {**keys, **_layers(2, spec)}


def _dinov2_hf():
    keys = {"embeddings.patch_embeddings.projection.weight": (D, 3, P, P),
            "embeddings.patch_embeddings.projection.bias": (D,), "embeddings.cls_token": (1, 1, D),
            "embeddings.position_embeddings": (1, 50, D), "layernorm.weight": (D,), "layernorm.bias": (D,)}
    a = "encoder.layer.{i}.attention"
    spec = {f"{a}.attention.{n}.{w}": ((D, D) if w == "weight" else (D,))
            for n in ("query", "key", "value") for w in ("weight", "bias")}
    spec.update({f"{a}.output.dense.weight": (D, D), f"{a}.output.dense.bias": (D,),
                 "encoder.layer.{i}.layer_scale1.lambda1": (D,), "encoder.layer.{i}.layer_scale2.lambda1": (D,),
                 "encoder.layer.{i}.norm1.weight": (D,), "encoder.layer.{i}.norm1.bias": (D,),
                 "encoder.layer.{i}.norm2.weight": (D,), "encoder.layer.{i}.norm2.bias": (D,),
                 "encoder.layer.{i}.mlp.fc1.weight": (M, D), "encoder.layer.{i}.mlp.fc1.bias": (M,),
                 "encoder.layer.{i}.mlp.fc2.weight": (D, M), "encoder.layer.{i}.mlp.fc2.bias": (D,)})
    return {**keys, **_layers(2, spec)}


def _clip_hf(prefix):
    keys = {"embeddings.patch_embedding.weight": (D, 3, P, P), "embeddings.class_embedding": (D,),
            "embeddings.position_embedding.weight": (17, D), "pre_layrnorm.weight": (D,), "pre_layrnorm.bias": (D,),
            "post_layernorm.weight": (D,), "post_layernorm.bias": (D,)}
    spec = {f"encoder.layers.{{i}}.self_attn.{n}_proj.{w}": ((D, D) if w == "weight" else (D,))
            for n in ("q", "k", "v", "out") for w in ("weight", "bias")}
    spec.update({f"encoder.layers.{{i}}.layer_norm{j}.{w}": (D,) for j in (1, 2) for w in ("weight", "bias")})
    spec.update({"encoder.layers.{i}.mlp.fc1.weight": (M, D), "encoder.layers.{i}.mlp.fc1.bias": (M,),
                 "encoder.layers.{i}.mlp.fc2.weight": (D, M), "encoder.layers.{i}.mlp.fc2.bias": (D,)})
    return {prefix + k: s for k, s in {**keys, **_layers(2, spec)}.items()}


def _data2vec_hf():
    keys = {"embeddings.patch_embeddings.projection.weight": (D, 3, P, P),
            "embeddings.patch_embeddings.projection.bias": (D,), "embeddings.cls_token": (1, 1, D),
            "pooler.layernorm.weight": (D,), "pooler.layernorm.bias": (D,)}
    a = "encoder.layer.{i}.attention"
    spec = {f"{a}.attention.query.weight": (D, D), f"{a}.attention.query.bias": (D,),
            f"{a}.attention.key.weight": (D, D), f"{a}.attention.value.weight": (D, D),
            f"{a}.attention.value.bias": (D,),
            f"{a}.attention.relative_position_bias.relative_position_bias_table": (7**2 + 3, 2),
            f"{a}.output.dense.weight": (D, D), f"{a}.output.dense.bias": (D,),
            "encoder.layer.{i}.lambda_1": (D,), "encoder.layer.{i}.lambda_2": (D,),
            "encoder.layer.{i}.intermediate.dense.weight": (M, D), "encoder.layer.{i}.intermediate.dense.bias": (M,),
            "encoder.layer.{i}.output.dense.weight": (D, M), "encoder.layer.{i}.output.dense.bias": (D,)}
    spec.update({f"encoder.layer.{{i}}.layernorm_{n}.{w}": (D,) for n in ("before", "after")
                 for w in ("weight", "bias")})
    return {**keys, **_layers(2, spec)}


def _dino_module(ls):
    return dinov2.DINOv2(dinov2.DINOv2Config(**TINY, patch_size=P, image_size=98, layerscale=ls), device="cpu")


CONVERTERS = {
    "dinov2 hub": (_dinov2_hub(), "convert_dinov2_state_dict", lambda: _dino_module(True)),
    "mae hub": (_dinov2_hub(ls=False), "convert_dinov2_state_dict", lambda: _dino_module(False)),
    "dinov2 transformers": (_dinov2_hf(), "convert_dinov2_state_dict", lambda: _dino_module(True)),
    "clip transformers": (_clip_hf("vision_model."), "convert_clip_vision_state_dict", lambda: clip_vision.CLIPVision(
        clip_vision.CLIPVisionConfig(**TINY, patch_size=P, image_size=56), device="cpu")),
    "clip unprefixed": (_clip_hf(""), "convert_clip_vision_state_dict", lambda: clip_vision.CLIPVision(
        clip_vision.CLIPVisionConfig(**TINY, patch_size=P, image_size=56), device="cpu")),
    "data2vec transformers": (_data2vec_hf(), "convert_data2vec_state_dict", lambda: data2vec_vision.Data2VecVision(
        data2vec_vision.Data2VecVisionConfig(**TINY, patch_size=P, image_size=56), device="cpu")),
}


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_vit_converters_match_jax(name):
    shapes, fn, module = CONVERTERS[name]
    sd = _state_dict(shapes, seed=len(name))
    got, want = getattr(tw, fn)(sd), _np(getattr(jtw, fn)(sd))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == np.float32 and np.array_equal(g, w)
    load_jax_params(module(), got)  # strict: every parameter filled, every leaf placed
