"""The fp32 routes of the port's kernels, on the CPU.

`flash_attention.kernel_for` names, before any launch, the kernel entry
points that a dtype and head dim go to on the card, or the plain einsum; it
must agree with JAX's own `flash_supported` (flash_attention.py:87-101),
called as on a TPU (`jax.default_backend` patched to "tpu" inside the test;
no JAX file changes). K7's and K8's plain versions, which the fp32 kernel
instances are held to on the card, against the JAX kernels in interpret mode
on fp32 inputs: K7's codes bit-exact and its output within 1e-6 relative,
K8's output within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.ops import flash_attention as jfa
from faceposegenerator_tpu.ops import quant as jquant
from faceposegenerator_tpu.ops import quant_pallas
from faceposegenerator_tpu_torch.ops import _build
from faceposegenerator_tpu_torch.ops import flash_attention as fa
from faceposegenerator_tpu_torch.ops import qdense as qd
from faceposegenerator_tpu_torch.ops import quant

_DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp32": (torch.float32, jnp.float32),
           "fp16": (torch.float16, jnp.float16)}


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("d", [64, 96, 128, 256, 384, 512])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_kernel_for_agrees_with_jax_flash_supported(monkeypatch, dtype, d, backward):
    tdt, jdt = _DTYPES[dtype]
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    x = jnp.zeros((1, 8, 2, d), jdt)
    names = fa.kernel_for(tdt, d, backward)
    assert (names is not None) == jfa.flash_supported(x, x, x)
    if names is not None:
        names = names if backward else (names,)
        assert all(n in _build.SOURCE_OF and n in fa.LAUNCHES for n in names)
        assert all(("_f32" in n) == (dtype == "fp32") for n in names)


# JAX's row quantizer inside `_qdense_kernel`, under jit as the sampling program runs it
_jcodes = jax.jit(lambda x: jnp.clip(jnp.round(x / (jnp.maximum(jnp.max(jnp.abs(x), axis=1, keepdims=True), 1e-8)
                                                   / 127.0)), -127, 127))


@pytest.mark.parametrize("m,k,n", [(37, 64, 72), (100, 320, 128)])
def test_qdense_plain_at_fp32_matches_pallas(m, k, n):
    rng = np.random.default_rng(m + k)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    w = (rng.standard_normal((n, k)) * k**-0.5).astype(np.float32)
    jw = jquant.quantize_weight(jnp.asarray(w), channel_axis=0)
    want = np.asarray(quant_pallas.qdense_pallas(jnp.asarray(x), jw["q"], jw["s"], block_m=32, block_n=128,
                                                 interpret=True))
    codes, _ = qd.quantize(torch.from_numpy(x), -1)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(_jcodes(jnp.asarray(x))))
    tw = quant.quantize_weight(torch.from_numpy(w))
    qd.reset_launch_counts()
    got = qd.qdense_kernel(torch.from_numpy(x), tw.q, tw.s)
    assert got.dtype == torch.float32 and not any(qd.LAUNCHES.values())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


_jint8 = jax.jit(lambda q, k, v, kv_len: jfa.flash_attention_int8(q, k, v, kv_len=kv_len, interpret=True),
                 static_argnames="kv_len")


@pytest.mark.parametrize("b,sq,skv,h,kv_len", [(1, 96, 77, 3, None), (2, 64, 128, 1, 100)])
def test_flash_int8_plain_at_fp32_matches_jax(b, sq, skv, h, kv_len):
    rng = np.random.default_rng(sq + skv)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((b, sq, h, 64), (b, skv, h, 64), (b, skv, h, 64)))
    want = np.asarray(_jint8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len))
    fa.reset_launch_counts()
    got = fa.flash_attention_int8(*(torch.from_numpy(a) for a in (q, k, v)), 0.125, kv_len)
    assert got.dtype == torch.float32 and not any(fa.LAUNCHES.values())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
