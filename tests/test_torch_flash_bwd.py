"""The port's attention backward against the JAX package's (same numpy
inputs, fp32, CPU).

The JAX side is `jax.grad` of `flash_attention(..., interpret=True)`: its
custom VJP runs the Pallas backward kernels (K5 at d=64, K6 at d=128) in
interpret mode, as tests/test_ops.py:72-118 runs them. The port side is
`attention_bwd_plain` on the forward's own output and log-sum-exp, and
`FlashAttention.apply` differentiated by autograd, which on CPU tensors
routes to the plain versions (tests/test_torch_kernels_cuda.py holds the
CUDA kernels against those plain versions on a card). Tolerance
atol = rtol = 2e-4, test_ops' own; gradients of keys at >= kv_len must be 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.ops.flash_attention import flash_attention as jflash
from faceposegenerator_tpu_torch.ops import flash_attention as fa
from faceposegenerator_tpu_torch.ops.attention import dot_product_attention

CASES = [  # (b, sq, skv, h, d, kv_len)
    (2, 128, 128, 2, 64, None),
    (2, 200, 200, 5, 64, None),  # odd head count, unaligned sequence
    (2, 128, 128, 2, 64, 77),  # padded keys masked by kv_len
    (2, 256, 77, 5, 64, None),  # cross-attention over 77 text tokens
    (1, 256, 256, 1, 128, None),  # the plain (d % 128 == 0) path
]


def _inputs(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d)))


def _jax_grads(q, k, v, kv_len):
    def loss(q, k, v):
        out = jflash(q, k, v, kv_len=kv_len, block_q=128, block_k=128, interpret=True)
        return jnp.sum(out**2)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))]


@pytest.mark.parametrize("b,sq,skv,h,d,kv_len", CASES)
def test_backward_matches_jax_flash(b, sq, skv, h, d, kv_len):
    q, k, v = _inputs(11, b, sq, skv, h, d)
    ref = _jax_grads(q, k, v, kv_len)
    scale = d**-0.5

    # the plain backward on the plain forward's o and lse, loss = Σ o² so dO = 2·o
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = fa.attention_plain_lse(tq, tk, tv, scale, kv_len)
    plain = fa.attention_bwd_plain(tq, tk, tv, o, lse, 2 * o, scale, kv_len)

    # the autograd Function, as the models call it
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    fa.reset_launch_counts()
    dot_product_attention(*xs, kv_len=kv_len).square().sum().backward()
    assert all(n == 0 for n in fa.LAUNCHES.values())  # CPU tensors launch nothing

    for g_plain, x, g_ref in zip(plain, xs, ref):
        np.testing.assert_allclose(g_plain.numpy(), g_ref, atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(x.grad.numpy(), g_ref, atol=2e-4, rtol=2e-4)
    if kv_len is not None:
        for g in (plain[1], plain[2], xs[1].grad, xs[2].grad):
            assert float(g[:, kv_len:].abs().max()) == 0.0


@pytest.mark.parametrize("kv_len", [None, 77])
def test_plain_lse_matches_logsumexp(kv_len):
    """attention_plain_lse: the output equals the JAX flash forward's, and
    lse (B, H, Sq) is the natural-log log-sum-exp of the scaled logits
    over the live keys."""
    b, sq, skv, h, d = 2, 128, 128, 5, 64
    q, k, v = _inputs(12, b, sq, skv, h, d)
    o, lse = fa.attention_plain_lse(*(torch.from_numpy(a) for a in (q, k, v)), d**-0.5, kv_len)
    n = skv if kv_len is None else kv_len
    logits = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k[:, :n].astype(np.float64)) * d**-0.5
    mx = logits.max(-1, keepdims=True)
    ref_lse = (mx + np.log(np.exp(logits - mx).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=1e-5, rtol=1e-5)
    ref_o = jflash(*(jnp.asarray(a) for a in (q, k, v)), kv_len=kv_len, block_q=128, block_k=128, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=1e-4, rtol=1e-4)


def test_forward_wrappers_return_lse_on_cpu():
    """with_lse on CPU tensors returns the plain (o, lse) for both kernels'
    wrappers and counts no launch."""
    fa.reset_launch_counts()
    for d, fwd in ((64, fa.flash_fwd_d64), (512, fa.flash_fwd_wide)):
        q, k, v = (torch.from_numpy(a) for a in _inputs(13, 1, 40, 30, 2, d))
        o, lse = fwd(q, k, v, d**-0.5, 20, with_lse=True)
        ro, rl = fa.attention_plain_lse(q, k, v, d**-0.5, 20)
        torch.testing.assert_close(o, ro, atol=0, rtol=0)
        torch.testing.assert_close(lse, rl, atol=0, rtol=0)
        torch.testing.assert_close(fwd(q, k, v, d**-0.5, 20), fa.attention_plain(q, k, v, d**-0.5, 20))
    assert all(n == 0 for n in fa.LAUNCHES.values())
