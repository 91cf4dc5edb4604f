"""K8's plain version (`attention_int8_plain`) against the JAX package's
`flash_attention_int8`, its Pallas kernel run in interpret mode under
`jax.jit` as in the sampling program, fp32 inputs from numpy seeds: within
1e-4 max abs, and within 3e-2 relative of exact attention, as the JAX tests
assert. JAX quantizes p against the row max of one 4096-key block; a case
puts each row's max in the last 64 keys, where a running-max softmax over
64-key tiles gives other codes (shown by running the plain version with
64-key blocks). Past 4096 keys (4096 + 128 here, as the 640² request's 6400
do) JAX's grid takes a second block with its own row max, and the plain
version follows it: with every row's max in the second block and with
kv_len ending inside it; quantizing p against one max over all the keys
misses JAX's output. The CUDA kernel itself is held to this plain version in
tests/test_torch_kernels_cuda.py; it uses expf, as JAX's exp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.ops.attention import _reference_attention
from faceposegenerator_tpu.ops.flash_attention import flash_attention_int8 as jflash_int8
from faceposegenerator_tpu_torch.ops import flash_attention as fa
from faceposegenerator_tpu_torch.ops.attention import dot_product_attention

_jint8 = jax.jit(lambda q, k, v, kv_len: jflash_int8(q, k, v, kv_len=kv_len, interpret=True),
                 static_argnames="kv_len")


def _qkv(seed, b, sq, skv, h, d=64):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d)))


def _last_tile_max(seed=5):
    """Keys 192..255 align with the queries, so every row's max is there."""
    q, k, v = _qkv(seed, 1, 128, 256, 2)
    k *= 0.3
    k[:, 192:] = 2.0 * q[:, :64]
    return q, k, v


@pytest.mark.parametrize("case", ["4 heads", "5 heads", "kv_len 77 of 128", "max in the last tile"])
def test_int8_plain_matches_jax(case):
    kv_len = None
    if case == "4 heads":
        q, k, v = _qkv(0, 2, 256, 256, 4)
    elif case == "5 heads":
        q, k, v = _qkv(1, 2, 256, 256, 5)
    elif case == "kv_len 77 of 128":
        (q, k, v), kv_len = _qkv(2, 1, 128, 128, 2), 77
    else:
        q, k, v = _last_tile_max()
    want = np.asarray(_jint8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len))
    fa.reset_launch_counts()
    got = dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)), kv_len=kv_len, impl="flash_int8")
    assert fa.LAUNCHES["flash_int8"] == 0  # a CPU tensor never launches
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    exact = np.asarray(_reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125, kv_len))
    assert np.linalg.norm(got.numpy() - exact) / np.linalg.norm(exact) < 3e-2


def test_a_running_max_over_64_key_tiles_computes_another_function(monkeypatch):
    q, k, v = _last_tile_max()
    want = np.asarray(_jint8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None))
    monkeypatch.setattr(fa, "_INT8_BLOCK_K", 64)
    tiled = fa.attention_int8_plain(*(torch.from_numpy(a) for a in (q, k, v)), 0.125)
    assert np.abs(tiled.numpy() - want).max() > 1e-3


def test_other_head_dims_take_the_exact_kernels():
    """As JAX's flash_attention_int8 (flash_attention.py:1284-1288): the VAE's
    512-dim head stays exact."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 64, 64, 1, 512))
    got = dot_product_attention(q, k, v, impl="flash_int8")
    torch.testing.assert_close(got, fa.attention_plain(q, k, v, 512**-0.5), atol=0, rtol=0)


def _max_in_second_block(seed=7):
    """1 × 128 queries × 4224 keys × 2 heads; keys 4096.. are 0.5·q, the
    others 0.3·N(0, 1), so every row's max lies in the second 4096-key block,
    a few logits above the first block's."""
    q, k, v = _qkv(seed, 1, 128, 4096 + 128, 2)
    k[:, :4096] *= 0.3
    k[:, 4096:] = 0.5 * q
    return q, k, v


@pytest.mark.parametrize("case", ["max in the second block", "kv_len 4160 of 4224"])
def test_int8_plain_matches_jax_past_one_key_block(case):
    if case == "max in the second block":
        (q, k, v), kv_len = _max_in_second_block(), None
    else:
        (q, k, v), kv_len = _qkv(8, 1, 128, 4096 + 128, 2), 4160
    want = np.asarray(_jint8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len))
    got = fa.attention_int8_plain(*(torch.from_numpy(a) for a in (q, k, v)), 0.125, kv_len)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_one_max_over_both_key_blocks_computes_another_function(monkeypatch):
    q, k, v = _max_in_second_block()
    want = np.asarray(_jint8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None))
    monkeypatch.setattr(fa, "_INT8_BLOCK_K", 4096 + 128)
    one_block = fa.attention_int8_plain(*(torch.from_numpy(a) for a in (q, k, v)), 0.125)
    assert np.abs(one_block.numpy() - want).max() > 1e-4
