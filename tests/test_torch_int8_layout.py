"""CPU emulation of the layouts and exact conversions that K7 (csrc/qdense.cu)
and K8 (csrc/flash_int8.cu) compute by hand, checked by exact integer
equality against the plain versions' codes (`qdense_plain`'s, through
`quantize`; `attention_int8_plain`'s, through `int8_codes_plain`):

  * the shared-memory swizzles: `swz64` (K7 writes its x codes with it) and
    K7's bf16 output staging, against the address maps the hardware reads
    (the 64- and 128-byte swizzles as XORs of address bits, applied to the
    canonical K-major layout of a wgmma descriptor or a TMA box), and the
    staging store free of bank conflicts;
  * the wgmma fragments: an s32 accumulator of scores, its codes packed
    (PRMT) into the s8 register A operand of the next product, against V's
    codes in the permuted key order (`v_key`) that the codes launch writes;
  * the magic-number conversions: K8's trunc of p·127 + 0.5, at every
    float32 within a few ulps of each code boundary; the quantizers' rint
    and clip (both kernels' `code`) against `quantize` over a wide range of
    values;
  * K8's score loop and K7's GEMM end to end on small seeded inputs, in the
    kernels' arithmetic, against the plain versions.
The CUDA kernels themselves are held to the plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from faceposegenerator_tpu_torch.ops import flash_attention as fa
from faceposegenerator_tpu_torch.ops import qdense as qd


# ---------------------------------------------------------------------------
# address maps
# ---------------------------------------------------------------------------


def swizzle(addr, b):
    """The hardware swizzle of a byte address (CUTLASS's Swizzle<b, 4, 3>:
    bits [7, 7 + b) XORed into bits [4, 4 + b)); b = 2: 64-byte, b = 3:
    128-byte. Tiles start on 1024-byte boundaries."""
    return addr ^ ((addr >> 3) & (((1 << b) - 1) << 4))


def swz64(row, col):
    """sm90_common.cuh `swz64`, as the kernel writes it."""
    return 64 * row + ((((col >> 4) ^ (row >> 1)) & 3) << 4) + (col & 15)


def desc_read(row, byte, row_bytes, b):
    """Where a wgmma reads byte `byte` of row `row` of a K-major operand
    (8-row groups row_bytes·8 apart: SBO 512 for 64-byte rows, 1024 for
    128-byte ones): the canonical address, swizzled."""
    return swizzle(row * row_bytes + byte, b)


def test_swz64_is_the_64_byte_swizzle_a_wgmma_reads():
    rows, cols = np.meshgrid(np.arange(128), np.arange(64), indexing="ij")
    written = swz64(rows, cols)
    assert np.array_equal(written, desc_read(rows, cols, 64, 2))
    assert len(np.unique(written)) == written.size  # a bijection on the tile


def test_k7_x_codes_round_trip_through_shared_memory():
    """K7's fused instance writes eight codes of row r at column 8c into chunk
    tile c // 8 (8 KB apart) at swz64(r, 8c % 64); each k32 slice the wgmma
    reads (descriptor at tile + 4096·wg + 32·ks) is the code matrix's."""
    rng = np.random.default_rng(0)
    K = 320
    x = torch.from_numpy(rng.standard_normal((128, K)).astype(np.float32) * 2)
    codes = qd.quantize(x, -1)[0].to(torch.int8).numpy()
    kc_n = -(-K // 64)
    smem = np.zeros(kc_n * 8192, np.int8)
    for r in range(128):
        for c in range(K // 8):
            k = 8 * c
            at = (k // 64) * 8192 + swz64(r, k % 64)
            smem[at:at + 8] = codes[r, k:k + 8]
    for wg in range(2):
        for kc in range(kc_n):
            for ks in range(2):
                rows, kk = np.meshgrid(np.arange(64), np.arange(32), indexing="ij")
                got = smem[kc * 8192 + 4096 * wg + desc_read(rows, 32 * ks + kk, 64, 2)]
                k = 64 * kc + 32 * ks + kk
                want = np.where(k < K, codes[64 * wg + rows, np.minimum(k, K - 1)], 0)
                assert np.array_equal(got, want)


def test_k7_output_staging_is_the_tma_box_and_conflict_free():
    """K7's bf16 staging: value (row r, column 8i + 2t4 (+1)) of a consumer's
    64 × 128 tile at box i // 8 (8 KB apart), 128·r + ((i % 8) ^ (r % 8))·16 +
    4·t4: the 128-byte swizzle of the two 64 × 64 boxes the TMA stores, and
    each warp's store of one chunk i hits 32 distinct banks."""
    for i in range(16):
        for w in range(4):
            banks = []
            for half in range(2):
                lanes = np.arange(32)
                g, t4 = lanes >> 2, lanes & 3
                r = 16 * w + g + 8 * half
                at = (i // 8) * 8192 + 128 * r + (((i % 8) ^ (r & 7)) << 4) + 4 * t4
                col = (8 * i + 2 * t4) % 64
                assert np.array_equal(at, (i // 8) * 8192 + swizzle(128 * r + 2 * col, 3))
                banks.append((at // 4) % 32)
            assert all(len(np.unique(b)) == 32 for b in banks)


# ---------------------------------------------------------------------------
# wgmma fragments
# ---------------------------------------------------------------------------


def acc_pos(w, lane, j):
    """(row, column) of value j of a thread's m64nN s32 (or f32) accumulator."""
    g, t4 = lane >> 2, lane & 3
    return 16 * w + g + 8 * ((j % 4) // 2), 8 * (j // 4) + 2 * t4 + (j % 2)


def a_s8_pos(w, lane, reg, byte):
    """(row, column) of byte `byte` of register `reg` of a thread's m64k32 s8
    register A fragment."""
    g, t4 = lane >> 2, lane & 3
    return 16 * w + g + 8 * (reg % 2), 4 * t4 + byte + 16 * (reg // 2)


def pack_p8(acc):
    """flash_int8.cu `pack_p8`'s packing of a thread's 64 codes (its score
    accumulator positions) into 16 registers, as byte lists."""
    pa = []
    for kc in range(4):
        y = [[acc[4 * (4 * kc + c) + e] for e in range(4)] for c in range(4)]
        pa += [[y[0][0], y[0][1], y[1][0], y[1][1]], [y[0][2], y[0][3], y[1][2], y[1][3]],
               [y[2][0], y[2][1], y[3][0], y[3][1]], [y[2][2], y[2][3], y[3][2], y[3][3]]]
    return pa


def v_key(p):
    """flash_int8.cu `v_key`: the key at position p of V's transposed codes."""
    m = p & 31
    half, t, e = m >> 4, (m >> 2) & 3, m & 3
    return (p & ~31) + 16 * half + np.where(e < 2, 2 * t + e, 8 + 2 * t + e - 2)


def test_v_key_is_the_wrappers_permutation():
    p = np.arange(4096)
    assert np.array_equal(v_key(p), fa.v_keys(4096).numpy())
    assert np.array_equal(np.sort(v_key(p)), p)


def test_score_fragments_times_permuted_v_is_p_times_v():
    """Codes held at a 64 × 128 score tile's accumulator positions, packed
    into the s8 A fragments of four 32-key slices, times V's codes in the
    permuted key order, give P·V exactly."""
    rng = np.random.default_rng(1)
    P = rng.integers(0, 128, (64, 128))
    V = rng.integers(-127, 128, (128, 64))
    vt = V[v_key(np.arange(128))].T  # V̂ᵀ: (64 d, 128 positions)
    out = np.zeros((64, 64), np.int64)
    for w in range(4):
        for lane in range(32):
            acc = [P[acc_pos(w, lane, j)] for j in range(64)]
            pa = pack_p8(acc)
            for kc in range(4):
                for reg in range(4):
                    for byte in range(4):
                        row, pos = a_s8_pos(w, lane, reg, byte)
                        out[row] += pa[4 * kc + reg][byte] * vt[:, 32 * kc + pos]
    assert np.array_equal(out, P @ V)


# ---------------------------------------------------------------------------
# the magic-number conversions
# ---------------------------------------------------------------------------


def trunc_rz(y):
    """The low byte of __fadd_rz(y, 2²³): the float32 sum rounded toward
    zero (y >= 0: 2²³ + floor(y), whose spacing is 1), as its bits."""
    s = np.floor(np.asarray(y, np.float32).astype(np.float64) + 2.0**23).astype(np.float32)
    return s.view(np.uint32) & 0xFF


def test_trunc_by_rz_add_at_every_code_boundary():
    ys = [np.float32(0.5), np.float32(127.5)]
    for n in range(1, 128):
        y = np.float32(n)
        for _ in range(6):
            ys += [y]
            y = np.nextafter(y, np.float32(0))
        y = np.float32(n)
        for _ in range(6):
            y = np.nextafter(y, np.float32(200))
            ys += [y]
    ys += list(np.linspace(0.5, 127.5, 200001, dtype=np.float32))
    ys = np.array([y for y in ys if 0.5 <= y <= 127.5], np.float32)
    assert np.array_equal(trunc_rz(ys), np.trunc(ys).astype(np.uint32))


def code_byte(x, scale):
    """qdense.cu / flash_int8.cu `code`: the low byte of the bits of
    x / scale + 1.5·2²³ (float32, to nearest even), clipped to those of
    1.5·2²³ ± 127."""
    q = np.asarray(x, np.float32) / np.float32(scale)
    t = (q.astype(np.float32) + np.float32(12582912.0)).astype(np.float32).view(np.int32)
    return (np.clip(t, 0x4B400000 - 127, 0x4B400000 + 127) & 0xFF).astype(np.uint8)


@pytest.mark.parametrize("a", [None, 0.01])
def test_magic_rint_and_clip_make_quantizes_codes(a):
    """The kernels' quantizer (rint by the magic add, the clip on the bits)
    against `quantize`'s true division, round half to even and clip, on
    values over 40 orders of magnitude, both signs, exact ties (n + 0.5
    steps of the scale) and quotients far past ±127 (the static scale)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal(200000).astype(np.float32) * np.float32(10.0) ** rng.integers(-20, 20, 200000)
    scale = np.float32(a) if a is not None else np.float32(np.float32(np.abs(x).max()) * np.float32(1 / 127))
    ties = ((np.arange(-140, 140) + np.float32(0.5)) * scale).astype(np.float32)
    x = np.concatenate([x, ties, np.float32(0.0) * ties]).astype(np.float32)
    want = qd.quantize(torch.from_numpy(x), None, float(scale))[0].to(torch.int8).numpy().view(np.uint8)
    assert np.array_equal(code_byte(x, scale), want)


# ---------------------------------------------------------------------------
# end to end, in the kernels' arithmetic
# ---------------------------------------------------------------------------


def k8_emulated(q, k, v, scale, kv_len, block):
    """K8's arithmetic on one (b, h) at a time: codes from
    int8_codes_plain's layouts, 128-key tiles, the integer row max of each
    `block` keys, expf, the trunc by the rz add, P·V through the permuted
    V, the fp32 merge of the blocks. Returns (o, p8 of every tile)."""
    q8, k8, vt, consts = fa.int8_codes_plain(q, k, v, scale)
    c_qk, c_v = consts.numpy()
    b, sq, h, _ = q.shape
    skv = k.shape[1]
    kv_end = skv if kv_len is None else kv_len
    o = np.zeros((b * h, sq, 64), np.float32)
    codes = []
    for bh in range(b * h):
        Q, Kc = q8[bh].numpy().astype(np.int64), k8[bh].numpy().astype(np.int64)
        Vt = vt[bh].numpy().astype(np.int64)
        m = np.full(sq, np.float32(-1e30), np.float32)
        l = np.zeros(sq, np.float32)
        acc = np.zeros((sq, 64), np.float32)
        for k0 in range(0, kv_end, block):
            keys = np.arange(k0, min(k0 + block, skv))
            live = keys < kv_end
            S = (Q @ Kc[keys].T).astype(np.int32)
            mx = np.where(live, S, np.iinfo(np.int32).min).max(1)
            mn = np.maximum(m, (mx.astype(np.float32) * c_qk).astype(np.float32))
            al = np.exp((m - mn).astype(np.float32)).astype(np.float32)
            x = (S.astype(np.float32) * c_qk).astype(np.float32) - mn[:, None]
            p = np.where(live, torch.from_numpy(x.astype(np.float32)).exp().numpy(), np.float32(0))
            y = (p * np.float32(127)).astype(np.float32) + np.float32(0.5)
            p8 = trunc_rz(y.astype(np.float32)).astype(np.int64)
            codes.append(p8)
            pos = np.arange(k0, min(k0 + block, skv + 127) // 128 * 128)
            perm_keys = v_key(pos)
            p8_perm = np.zeros((sq, len(pos)), np.int64)
            ok = perm_keys - k0 < p8.shape[1]
            p8_perm[:, ok] = p8[:, (perm_keys - k0)[ok]]
            pv = p8_perm @ Vt[:, pos].T
            acc = (acc * al[:, None]).astype(np.float32) + (pv.astype(np.float32) * c_v).astype(np.float32)
            l = (l * al).astype(np.float32) + p.sum(1, dtype=np.float32)
            m = mn
        o[bh] = acc / l[:, None]
    return torch.from_numpy(o).reshape(b, h, sq, 64).transpose(1, 2), codes


@pytest.mark.parametrize("kv_len", [None, 250])
def test_k8_emulation_makes_the_plain_versions_codes(monkeypatch, kv_len):
    """Two 128-key blocks (the plain version's block patched to 128 to keep
    the input small) and a ragged third: the emulated p8 codes equal those
    the plain version makes from its own scores, bit for bit, and the
    outputs agree to the sum order of l."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 64, 2, 64), (1, 300, 2, 64), (1, 300, 2, 64)))
    monkeypatch.setattr(fa, "_INT8_BLOCK_K", 128)
    got, codes = k8_emulated(q, k, v, 0.125, kv_len, 128)
    want = fa.attention_int8_plain(q, k, v, 0.125, kv_len)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # the plain version's own p8 of the first block of (b, h) = (0, 0)
    (q8, sq_), (k8, sk_) = qd.quantize(q), qd.quantize(k)
    s = torch.einsum("qd,kd->qk", q8[0, :, 0], k8[0, :128, 0]) * (sq_ * sk_ * 0.125)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    assert np.array_equal(codes[0], torch.trunc(p * 127.0 + 0.5).numpy().astype(np.int64))


@pytest.mark.parametrize("static", [False, True])
def test_k7_emulation_is_qdense_plain(static):
    """K7's fused instance in its own arithmetic: the codes through shared
    memory (swz64), the integer products per k32 slice, the epilogue's fp32
    rescale in its order: qdense_plain's output, bit for bit."""
    rng = np.random.default_rng(4)
    M, K, N = 100, 320, 72
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16)
    from faceposegenerator_tpu_torch.ops.quant import quantize_weight

    qw = quantize_weight(torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)))
    a = float(x.float().abs().amax()) / 127.0 if static else None
    codes, sx = qd.quantize(x, -1, a)
    codes = codes.to(torch.int8).numpy()
    smem = np.zeros(5 * 8192, np.int8)
    rows = np.arange(M)[:, None]
    for c in range(K // 8):
        for e in range(8):
            smem[(8 * c // 64) * 8192 + swz64(rows, (8 * c) % 64 + e)] = codes[:, 8 * c + e:8 * c + e + 1]
    acc = np.zeros((M, N), np.int64)
    for kc in range(5):
        for ks in range(2):
            kk = np.arange(32)[None, :]
            A = smem[kc * 8192 + desc_read(rows, 32 * ks + kk, 64, 2)].astype(np.int64)
            acc += A @ qw.q.numpy()[:, 64 * kc + 32 * ks:64 * kc + 32 * ks + 32].astype(np.int64).T
    f = torch.from_numpy(acc.astype(np.float32))
    s = qw.s
    y = f * (torch.tensor(np.float32(a)) * s) if static else (f * sx) * s
    assert torch.equal(y.to(torch.bfloat16), qd.qdense_plain(x, qw.q, qw.s, a))
