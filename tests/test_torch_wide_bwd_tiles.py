"""K6's arithmetic and tile addressing (csrc/flash_bwd.cu, the D % 128 == 0
backward), emulated on the CPU.

The kernel runs three passes (dV, then dK, then dQ), each CTA's two consumer
warpgroups owning one half of the head dim: per tile they compute partial
scores (and dP) over their halves in fp32, add the two partials, recompute
p = exp2(s·scale·log2e − lse·log2e) in every pass, round p (dV) and dS to
bf16, and accumulate their output half in fp32 over 64-query tiles (dV) or
32-row tiles (dK, dQ). Here:

  * that arithmetic, in numpy fp32 in the kernel's order (D-half partial
    scores added as the exchange adds them, p and dS rounded to bf16, fp32
    accumulation per tile, keys >= kv_len masked, the scores recomputed in
    each pass), against `jax.grad` of the JAX package's `flash_attention` in
    interpret mode (which runs `_bwd_kernel_plain_dkv/_dq`, the TPU kernels
    K6 replaces) at D = 512 and 256 with ragged Sq = 130, Skv = 200 and
    kv_len = 150, within the bf16 gradient gate (2e-2 max, 2e-3 mean of
    each gradient's max abs); the same emulation without the other half's
    partial, or without the key mask, must miss it;
  * the tile addressing: the k16 slices each warpgroup's first products
    read (box wg·D/128 + kk/4, 32·(kk % 4) bytes in) cover its half of the
    head dim once, in order; the second products' MN-major slices (2048·kc
    bytes into a box of 64 or 32 rows) cover the streamed tile's rows and
    the warpgroup's columns once; and under the 128-byte swizzle the
    descriptors' reads land where TMA wrote each element.
The kernels themselves are held to the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.ops.flash_attention import flash_attention as jflash
from faceposegenerator_tpu_torch.ops import flash_attention as fa

LOG2E = np.float32(1.4426950408889634)
B, SQ, SKV, H, KV_LEN = 1, 130, 200, 2, 150


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _inputs(d, seed=5):
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16(rng.standard_normal(s)) for s in ((B, SQ, H, d), (B, SKV, H, d), (B, SKV, H, d)))
    do = _bf16(rng.standard_normal((B, SQ, H, d)))
    return q, k, v, do


def _mm(a, b):
    return (a.astype(np.float32) @ b.astype(np.float32)).astype(np.float32)


def emulate_k6(q, k, v, o, lse, do, scale, kv_len, halves=2, mask=True):
    """(dq, dk, dv) in the kernels' arithmetic, bf16 values in fp32 arrays.
    halves=1 keeps only warpgroup 0's partial scores; mask=False leaves
    keys >= kv_len unmasked (both wrong, for the gate to refuse)."""
    b_, sq, h_, d = q.shape
    skv = k.shape[1]
    kv_end = skv if kv_len is None else min(skv, kv_len)
    hd = d // 2
    scale_log2 = np.float32(scale) * LOG2E
    dd = (do.astype(np.float32) * o).sum(-1, dtype=np.float32)  # the wrapper's rowsum(dO∘O), (B, Sq, H)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for b in range(b_):
        for h in range(h_):
            qh, kh, vh, doh = q[b, :, h], k[b, :, h], v[b, :, h], do[b, :, h]
            l2 = (lse[b, h] * LOG2E).astype(np.float32)

            def partial_sum(a, c):  # the two warpgroups' partials over their halves, added by the exchange
                parts = [_mm(a[:, i * hd:(i + 1) * hd], c[:, i * hd:(i + 1) * hd].T) for i in range(2)]
                return parts[0] + parts[1] if halves == 2 else parts[0]

            def probs():  # recomputed in every pass
                s = partial_sum(qh, kh)
                p = np.exp2((s.astype(np.float64) * scale_log2 - l2[:, None]).astype(np.float32)).astype(np.float32)
                if mask:
                    p[:, kv_end:] = 0.0
                return p

            def dscores():
                dp = partial_sum(doh, vh)
                return _bf16(probs() * (dp - dd[b, :, h][:, None]))

            p = _bf16(probs())
            acc = np.zeros((skv, d), np.float32)
            for j in range(0, sq, 64):  # dV: 64-query tiles
                acc += _mm(p[j:j + 64].T, doh[j:j + 64])
            dv[b, :, h] = _bf16(acc)
            ds = dscores()
            acc = np.zeros((skv, d), np.float32)
            for j in range(0, sq, 32):  # dK: 32-query tiles
                acc += _mm(ds[j:j + 32].T, qh[j:j + 32])
            dk[b, :, h] = _bf16(acc * np.float32(scale))
            ds = dscores()
            acc = np.zeros((sq, d), np.float32)
            for j in range(0, kv_end, 32):  # dQ: 32-key tiles up to kv_end
                acc += _mm(ds[:, j:j + 32], kh[j:j + 32])
            dq[b, :, h] = _bf16(acc * np.float32(scale))
    return dq, dk, dv


def _gate(got, want):
    """The bf16 gradient gate: max and mean abs err within 2e-2 and 2e-3 of
    the gradient's max abs."""
    err = np.abs(got - want)
    n = np.abs(want).max()
    return err.max() <= 2e-2 * n and err.mean() <= 2e-3 * n


@pytest.fixture(scope="module", params=[512, 256])
def case(request):
    d = request.param
    q, k, v, do = _inputs(d)

    def loss(q, k, v):
        return jnp.sum(jflash(q, k, v, kv_len=KV_LEN, interpret=True) * jnp.asarray(do))

    want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))]
    o, lse = fa.attention_plain_lse(*(torch.from_numpy(a) for a in (q, k, v)), d**-0.5, KV_LEN)
    return dict(d=d, q=q, k=k, v=v, do=do, o=_bf16(o.numpy()), lse=lse.numpy(), want=want)


def test_emulated_passes_meet_the_gradient_gate_against_jax(case):
    got = emulate_k6(case["q"], case["k"], case["v"], case["o"], case["lse"], case["do"], case["d"] ** -0.5, KV_LEN)
    for name, g, w in zip(("dq", "dk", "dv"), got, case["want"]):
        assert _gate(g, w), name
    assert np.abs(got[1][:, KV_LEN:]).max() == 0.0 and np.abs(got[2][:, KV_LEN:]).max() == 0.0


@pytest.mark.parametrize("wrong", [dict(halves=1), dict(mask=False)], ids=["one half's scores", "keys unmasked"])
def test_the_gate_refuses_a_wrong_emulation(case, wrong):
    got = emulate_k6(case["q"], case["k"], case["v"], case["o"], case["lse"], case["do"], case["d"] ** -0.5, KV_LEN,
                     **wrong)
    assert not all(_gate(g, w) for g, w in zip(got, case["want"]))


# ---------------------------------------------------------------------------
# tile addressing
# ---------------------------------------------------------------------------


def swizzle(addr):
    """The 128-byte swizzle of a byte address in a 1024-byte-aligned tile:
    address bits [7, 10) XORed into bits [4, 7)."""
    return addr ^ ((addr >> 3) & 0x70)


def tma_box_byte(r, c):
    """Where TMA writes element (row r, column c) of a 64-column bf16 box."""
    return swizzle(128 * r + 2 * c)


@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_first_products_read_each_half_once(d):
    """issue_s / issue_dp: warpgroup wg's KS = D/32 k16 slices (box
    wg·D/128 + kk/4, 32·(kk % 4) bytes in) read its half of the head dim,
    once and in order; each K-major read (row r, element e of the slice)
    lands where TMA wrote (r, the slice's column + e), for 64- and 32-row
    boxes."""
    hb = d // 128
    for wg in range(2):
        cols = []
        for kk in range(d // 32):
            box, start = wg * hb + kk // 4, 32 * (kk % 4)
            cols += [64 * box + start // 2 + e for e in range(16)]
            for rows in (64, 32):
                for r in range(rows):
                    for e in range(16):
                        read = box * rows * 128 + swizzle(start + 128 * r + 2 * e)
                        assert read == box * rows * 128 + tma_box_byte(r, start // 2 + e)
        assert cols == list(range(wg * d // 2, (wg + 1) * d // 2))


@pytest.mark.parametrize("bn", [64, 32])
@pytest.mark.parametrize("d", [128, 512])
def test_second_products_read_the_tile_once(d, bn):
    """issue_out: for each of a warpgroup's D/128 output blocks cb and each
    of the BN/16 k16 slices kc, the MN-major operand starts 2048·kc bytes
    into box wg·D/128 + cb of a BN-row tile and reads (k, n) at 128·k + 2n:
    the tile's rows and the warpgroup's columns, each once, where TMA wrote
    them."""
    hb, sbox = d // 128, bn * 128
    for wg in range(2):
        seen = np.zeros((bn, d), np.int64)
        for cb in range(d // 128):
            box = wg * hb + cb
            for kc in range(bn // 16):
                start = box * sbox + 2048 * kc
                for k in range(16):
                    for n in range(64):
                        got = box * sbox + swizzle(start - box * sbox + 128 * k + 2 * n)
                        row, col = 16 * kc + k, 64 * box + n
                        assert got == box * sbox + tma_box_byte(row, n)
                        seen[row, col] += 1
        assert (seen[:, wg * d // 2:(wg + 1) * d // 2] == 1).all() and seen.sum() == bn * d // 2
