"""The port's ops against their JAX twins (same numpy inputs, fp32, CPU).

Attention is held against the JAX Pallas flash kernel run in interpret mode,
as tests/test_ops.py runs it; on the CPU the port's wrappers take the plain
version of their CUDA kernels (tests/test_torch_kernels_cuda.py holds the
kernels themselves against that plain version on a card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.ops import lora as jlora
from faceposegenerator_tpu.ops import norms as jnorms
from faceposegenerator_tpu.ops.flash_attention import flash_attention as jflash
from faceposegenerator_tpu_torch.ops.attention import dot_product_attention
from faceposegenerator_tpu_torch.ops.lora import lora_dense
from faceposegenerator_tpu_torch.ops.norms import group_norm, layer_norm


def _qkv(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d)))


@pytest.mark.parametrize(
    "b,sq,skv,h,d,kv_len",
    [
        (2, 256, 256, 5, 64, None),  # self-attention, odd head count (K1's path)
        (2, 256, 77, 5, 64, None),  # cross-attention over 77 text tokens
        (2, 256, 128, 5, 64, 77),  # padded keys masked by kv_len
        (1, 256, 256, 1, 512, None),  # the VAE's one 512-dim head (K2's path)
    ],
)
def test_attention_matches_jax_flash(b, sq, skv, h, d, kv_len):
    q, k, v = _qkv(0, b, sq, skv, h, d)
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=kv_len,
                 block_q=128, block_k=128, interpret=True)
    out = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), kv_len=kv_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_reference_impl_matches_flash_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 64, 100, 2, 64))
    a = dot_product_attention(q, k, v, kv_len=77, impl="reference")
    b = dot_product_attention(q, k, v, kv_len=77, impl="flash")
    torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_matches_jax(eps, act):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 8, 8, 64)) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    bta = rng.standard_normal(64).astype(np.float32)
    ref = jnorms.group_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(bta), num_groups=32, eps=eps, act=act)
    out = group_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(bta), 32, eps, act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 77, 96)) * 2).astype(np.float32)
    g = rng.standard_normal(96).astype(np.float32)
    bta = rng.standard_normal(96).astype(np.float32)
    ref = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(bta))
    out = layer_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(bta))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_layer_norm_bf16_matches_jax(param_dtype):
    """bf16 x (the UNet's transformer blocks, CLIP, the eval ViTs): the
    statistics and the affine in fp32, one rounding to bf16 at the end, as
    JAX's `layer_norm` does; at most 0.01% of the elements may differ (an
    affine applied in bf16 moves ~29% of them by an ulp)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((64, 320)) * 3 + 0.5).astype(np.float32)
    g = (1.0 + 0.2 * rng.standard_normal(320)).astype(np.float32)
    bta = (0.2 * rng.standard_normal(320)).astype(np.float32)
    jdt, tdt = getattr(jnp, param_dtype), getattr(torch, param_dtype)
    ref = jnorms.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jdt), jnp.asarray(bta, jdt))
    out = layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(g).to(tdt), torch.from_numpy(bta).to(tdt))
    assert out.dtype == torch.bfloat16
    differ = np.mean(out.float().numpy() != np.asarray(ref, np.float32))
    assert differ <= 1e-4, f"{differ:.2%} of the bf16 outputs differ from JAX's"


@pytest.mark.parametrize("with_lora", [False, True])
def test_lora_dense_matches_jax(with_lora):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, 32)).astype(np.float32)
    w = rng.standard_normal((48, 32)).astype(np.float32) / 6
    b = rng.standard_normal(48).astype(np.float32)
    a_ = rng.standard_normal((4, 32)).astype(np.float32) if with_lora else None
    b_ = rng.standard_normal((48, 4)).astype(np.float32) if with_lora else None
    j = lambda t: None if t is None else jnp.asarray(t)  # noqa: E731
    t = lambda t: None if t is None else torch.from_numpy(t)  # noqa: E731
    ref = jlora.lora_dense(j(x), j(w), j(b), lora_a=j(a_), lora_b=j(b_), scale=0.7)
    out = lora_dense(t(x), t(w), t(b), lora_a=t(a_), lora_b=t(b_), scale=0.7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
