"""The port's CLIP, UNet and VAE against their JAX twins.

Weights are JAX `init` trees carried into the port by
`bridge.jax_params.load_jax_params`; inputs are numpy arrays from a seed;
both sides run fp32 (JAX PARITY_POLICY, the port's PARITY_POLICY). JAX
attention runs the Pallas flash kernels in interpret mode. Tolerances are
the repo's own (tests/test_unet_vae_torch_parity.py:74,98,115).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.models import clip_text as jclip
from faceposegenerator_tpu.models import unet2d as junet
from faceposegenerator_tpu.models import vae as jvae
from faceposegenerator_tpu_torch.bridge.jax_params import jax_tree_to_torch, load_jax_params
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.models import clip_text, unet2d, vae

TINY_UNET = dict(block_out_channels=(64, 128, 128, 128), cross_attention_dim=64, head_dim=64)
TINY_VAE = dict(block_out_channels=(32, 32, 32, 32))
TINY_CLIP = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=256)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def nonzero_lora(params, seed=1):
    """A JAX rank-4 LoRA tree whose B factors are nonzero."""
    lora = junet.init_lora(jax.random.key(seed), params, rank=4)
    leaves, treedef = jax.tree.flatten(lora)
    keys = jax.random.split(jax.random.key(seed + 1), len(leaves))
    leaves = [leaf + 0.1 * jax.random.normal(k, leaf.shape) for leaf, k in zip(leaves, keys)]
    return jax.tree.unflatten(treedef, leaves)


def test_clip_text_matches_jax():
    jcfg = jclip.CLIPTextConfig(**TINY_CLIP)
    params = jclip.init(jax.random.key(0), jcfg)
    model = load_jax_params(clip_text.CLIPTextModel(clip_text.CLIPTextConfig(**TINY_CLIP), device="cpu"), _np(params))
    ids = np.random.default_rng(0).integers(0, 1000, (2, 77))
    ref = jax.jit(lambda p, i: jclip.apply(p, i, jcfg, policy=JPOLICY))(params, jnp.asarray(ids))
    with torch.no_grad():
        out = model(torch.from_numpy(ids), PARITY_POLICY)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_unet_with_lora_matches_jax_flash():
    """Tiny UNet at head_dim 64 (K1's path; one head at level 0), rank-4
    LoRA with nonzero B, against unet2d.apply(attn_impl="flash")."""
    jcfg = junet.UNetConfig(**TINY_UNET)
    params = junet.init(jax.random.key(0), jcfg)
    lora = nonzero_lora(params)
    model = load_jax_params(unet2d.UNet2DCondition(unet2d.UNetConfig(**TINY_UNET), device="cpu"), _np(params))
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([7, 531])
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    apply = jax.jit(lambda p, *a, lora: junet.apply(p, *a, jcfg, policy=JPOLICY, lora=lora, attn_impl="flash"))
    ref = apply(params, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx), lora=lora)
    with torch.no_grad():
        out = model(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx), PARITY_POLICY,
                    lora=jax_tree_to_torch(_np(lora), "cpu", torch.float32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


def test_vae_decode_matches_jax():
    jcfg = jvae.VAEConfig(**TINY_VAE)
    params = jvae.init(jax.random.key(2), jcfg)
    model = load_jax_params(vae.AutoencoderKL(vae.VAEConfig(**TINY_VAE), device="cpu"), _np(params))
    lat = (np.random.default_rng(2).standard_normal((2, 4, 4, 4)) * 0.2).astype(np.float32)
    ref = jax.jit(lambda p, z: jvae.decode(p, z, jcfg, policy=JPOLICY))(params, jnp.asarray(lat))
    with torch.no_grad():
        out = model.decode(torch.from_numpy(lat), PARITY_POLICY)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-4, rtol=3e-4)


def test_sd21_transformer_real_shape_matches_jax():
    """One level-0 transformer at SD2.1 widths: 320 channels, 5 heads × 64,
    1024-dim cross-attention context, over 16×16 tokens."""
    jcfg = junet.SD21_UNET_CONFIG
    p = junet._transformer_init(jax.random.key(3), jcfg, 320, jnp.float32)
    tr = unet2d.Transformer2D(unet2d.SD21_UNET_CONFIG, 320)
    load_jax_params(tr, _np(p))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 16, 16, 320)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 1024)).astype(np.float32)
    ref = junet._transformer_apply(p, jnp.asarray(x), jnp.asarray(ctx), jcfg, attn_impl="flash")
    with torch.no_grad():
        out = tr(torch.from_numpy(x), torch.from_numpy(ctx), unet2d.SD21_UNET_CONFIG)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4, rtol=5e-4)


def test_sd_vae_mid_attention_real_shape_matches_jax():
    """The VAE mid-block attention at 512 channels (one 512-dim head, K2's path) over 16×16 tokens."""
    p = jvae._attn_init(jax.random.key(4), 512, jnp.float32)
    attn = vae.VAEAttention(512)
    load_jax_params(attn, _np(p))
    x = np.random.default_rng(4).standard_normal((1, 16, 16, 512)).astype(np.float32)
    ref = jvae._attn_apply(p, jnp.asarray(x), attn_impl="flash")
    with torch.no_grad():
        out = attn(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4, rtol=5e-4)


def test_init_lora_layout_matches_jax():
    jcfg = junet.UNetConfig(**TINY_UNET)
    jl = junet.init_lora(jax.random.key(0), junet.init(jax.random.key(0), jcfg), rank=4)
    tl = unet2d.init_lora(unet2d.UNet2DCondition(unet2d.UNetConfig(**TINY_UNET), device="cpu"), rank=4)
    j_shapes = jax.tree.map(lambda a: tuple(a.shape), _np(jl))
    t_shapes = jax.tree.map(lambda a: tuple(a.shape), tl)
    assert jax.tree.structure(j_shapes, is_leaf=lambda x: isinstance(x, tuple)) == \
        jax.tree.structure(t_shapes, is_leaf=lambda x: isinstance(x, tuple))
    assert j_shapes == t_shapes


def test_load_jax_params_is_strict():
    """A tree whose shapes or keys do not match the module, or that leaves a
    parameter unfilled, raises instead of loading part of the weights."""
    p = _np(jvae._attn_init(jax.random.key(5), 64, jnp.float32))
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(vae.VAEAttention(32), p)
    with pytest.raises(KeyError, match="no such attribute"):
        load_jax_params(vae.VAEAttention(64), dict(p, extra={"w": np.zeros(3, np.float32)}))
    with pytest.raises(KeyError, match="not in the tree"):
        load_jax_params(vae.VAEAttention(64), {k: v for k, v in p.items() if k != "out"})
    attn = load_jax_params(vae.VAEAttention(64), p)
    np.testing.assert_array_equal(attn.q.weight.detach().numpy(), p["q"]["w"])
