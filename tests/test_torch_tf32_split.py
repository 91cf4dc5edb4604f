"""The 3xTF32 arithmetic of the fp32 attention kernels (csrc/flash_f32.cu),
emulated in plain PyTorch on the CPU, against the JAX package's fp32 flash
attention.

Each fp32 operand is split as hi = rna_tf32(x), lo = rna_tf32(x − hi)
(`tf32_split_plain`: round to nearest, ties away, by integer operations on
the fp32 bits, as `cvt.rna.tf32.f32` does), and each matrix product is the
kernel's three: a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, fp32 accumulation (the
products of tf32 values are exact in fp32). The forward keeps P relative to
the row max as the kernel does and splits it before P·V; the backward
recomputes P from the LSE and splits P and dS before the second products.

The JAX side is `flash_attention(..., interpret=True)` and `jax.grad` of it,
which run the Pallas kernels (K1/K5 at d = 64, K2/K6 at D = 512) in interpret
mode as tests/test_ops.py runs them; the LSE is held to float64 numpy. The
gate is the port's fp32 gate (chip_smoke.py phase 11): max abs err within
1e-4 and mean abs err within 1e-5 of the output's (each gradient's) max abs,
the LSE within 1e-5. One-pass TF32 (operands rounded once, one product)
must miss it: at d = 64 over 256 keys, chip_smoke.py's TF32 row in
miniature.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.ops.flash_attention import flash_attention as jflash
from faceposegenerator_tpu_torch.ops import flash_attention as fa

CASES = {  # (b, sq, skv, h, d, kv_len)
    "d64 over 256 keys": (1, 128, 256, 2, 64, None),
    "d64, 77 of 128 keys by kv_len": (1, 128, 128, 2, 64, 77),
    "D512 over 128 keys": (1, 128, 128, 1, 512, None),
}
MAX_ERR, MEAN_ERR, LSE_ERR = 1e-4, 1e-5, 1e-5


def _mm3(a, b):
    """a @ b in 3xTF32: three products of the tf32 parts, small terms first."""
    (ah, al), (bh, bl) = fa.tf32_split_plain(a), fa.tf32_split_plain(b)
    return al @ bh + ah @ bl + ah @ bh


def _mm1(a, b):
    """a @ b in one-pass TF32."""
    return fa.tf32_round(a) @ fa.tf32_round(b)


def _heads(x):
    return x.permute(0, 2, 1, 3)  # (B, S, H, D) → (B, H, S, D)


def _mask(kv_len, skv):
    m = torch.zeros(skv)
    if kv_len is not None:
        m[kv_len:] = float("-inf")
    return m


def _forward(mm, q, k, v, scale, kv_len):
    """(o, lse): S = q·kᵀ, P = exp(S·scale − m) against the row max m, o =
    (P·v) / ΣP, lse = m + log ΣP (natural log, scaled logits)."""
    s = mm(_heads(q), _heads(k).transpose(-1, -2)) * scale + _mask(kv_len, k.shape[1])
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return _heads(mm(p, _heads(v)) / l), (m + torch.log(l))[..., 0]


def _backward(mm, q, k, v, o, lse, do, scale, kv_len):
    """(dq, dk, dv) from the forward's o and lse: P recomputed, dP = dO·vᵀ,
    dS = P∘(dP − rowsum(dO∘o)), dV = Pᵀ·dO, dK = scale·dSᵀ·q, dQ = scale·dS·k."""
    qh, kh, vh, doh = (_heads(t) for t in (q, k, v, do))
    s = mm(qh, kh.transpose(-1, -2)) * scale + _mask(kv_len, k.shape[1])
    p = torch.exp(s - lse[..., None])
    dp = mm(doh, vh.transpose(-1, -2))
    ds = p * (dp - (doh * _heads(o)).sum(-1, keepdim=True))
    dv = mm(p.transpose(-1, -2), doh)
    dk = mm(ds.transpose(-1, -2), qh) * scale
    dq = mm(ds, kh) * scale
    return tuple(_heads(t) for t in (dq, dk, dv))


def _inputs(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d)))


def _lse64(q, k, scale, kv_len):
    n = k.shape[1] if kv_len is None else kv_len
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k[:, :n].astype(np.float64)) * scale
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


def _within(out, ref):
    err = np.abs(out.astype(np.float64) - ref)
    n = np.abs(ref).max()
    return err.max() <= MAX_ERR * n and err.mean() <= MEAN_ERR * n, (err.max(), err.mean(), n)


@pytest.fixture(scope="module")
def jax_refs():
    """Per case: the inputs, dO = 2·o (loss Σo²), JAX's o and its gradients."""
    import jax

    refs = {}
    for name, (b, sq, skv, h, d, kv_len) in CASES.items():
        q, k, v = _inputs(7, b, sq, skv, h, d)

        def loss(q, k, v):
            out = jflash(q, k, v, kv_len=kv_len, block_q=128, block_k=128, interpret=True)
            return jnp.sum(out**2), out

        (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(a) for a in (q, k, v)))
        refs[name] = (q, k, v, np.asarray(o), [np.asarray(g) for g in grads])
    return refs


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_forward_meets_the_fp32_gate(jax_refs, case):
    b, sq, skv, h, d, kv_len = CASES[case]
    q, k, v, o_ref, _ = jax_refs[case]
    o, lse = _forward(_mm3, *(torch.from_numpy(a) for a in (q, k, v)), d**-0.5, kv_len)
    ok, errs = _within(o.numpy(), o_ref)
    assert ok, errs
    assert np.abs(lse.numpy() - _lse64(q, k, d**-0.5, kv_len)).max() <= LSE_ERR


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_backward_meets_the_fp32_gate(jax_refs, case):
    """Gradients of Σo² (dO = 2·o) on the emulated forward's own o and lse."""
    b, sq, skv, h, d, kv_len = CASES[case]
    q, k, v, _, grads_ref = jax_refs[case]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = _forward(_mm3, tq, tk, tv, d**-0.5, kv_len)
    grads = _backward(_mm3, tq, tk, tv, o, lse, 2 * o, d**-0.5, kv_len)
    for name, g, r in zip(("dq", "dk", "dv"), grads, grads_ref):
        ok, errs = _within(g.numpy(), r)
        assert ok, (name, errs)
    if kv_len is not None:
        assert grads[1][:, kv_len:].abs().max().item() == 0.0 and grads[2][:, kv_len:].abs().max().item() == 0.0


def test_one_pass_tf32_misses_the_fp32_gate(jax_refs):
    """The gate tells fp32 from TF32: one-pass TF32 attention at d = 64 over
    256 keys misses it, as the TF32 row of chip_smoke.py does at 4096."""
    b, sq, skv, h, d, kv_len = CASES["d64 over 256 keys"]
    q, k, v, o_ref, _ = jax_refs["d64 over 256 keys"]
    o, _ = _forward(_mm1, *(torch.from_numpy(a) for a in (q, k, v)), d**-0.5, kv_len)
    ok, errs = _within(o.numpy(), o_ref)
    assert not ok, errs


@pytest.mark.parametrize("s", [1, 77, 130])
def test_split_plain_layouts(s):
    """`f32_split_plain`: hi and lo are tf32 values (13 low bits 0) summing
    to x within 2^-22 relative; the transposed layout pads to 64 keys with
    zeros and puts key 8a + (0, 2, 4, 6, 1, 3, 5, 7)[c] at position 8a + c."""
    x = torch.from_numpy(np.random.default_rng(s).standard_normal((2, s, 3, 32)).astype(np.float32))
    nat = fa.f32_split_plain(x, False)
    assert nat.shape == (2, 6, s, 32)
    assert not (nat.view(torch.int32) & 0x1FFF).any()
    whole = (nat[0] + nat[1]).view(2, 3, s, 32).permute(0, 2, 1, 3)
    assert ((whole - x).abs() <= 2.0**-22 * x.abs()).all()
    tr = fa.f32_split_plain(x, True)
    pad = -(-s // 64) * 64
    assert tr.shape == (2, 6, 32, pad)
    keys = [8 * (c // 8) + (0, 2, 4, 6, 1, 3, 5, 7)[c % 8] for c in range(pad)]
    for c, key in enumerate(keys):
        want = nat[:, :, key] if key < s else torch.zeros_like(nat[:, :, 0])
        assert torch.equal(tr[:, :, :, c], want)
