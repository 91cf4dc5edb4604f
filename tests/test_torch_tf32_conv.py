"""The 3xTF32 arithmetic of K4's fp32 instance (csrc/gn_conv.cu
`gn_k4_conv_f32`), emulated in plain PyTorch on the CPU, against the JAX
package's K4 at fp32 in interpret mode.

The kernel's arithmetic, as the emulation repeats it: the activation
a = SiLU(x·scale + shift) in fp32 (`_silu_activation`), split in registers
as hi = rna_tf32(a), lo = rna_tf32(a − hi); the weight split the same way by
the pre-pass (`weight_split_plain`); per chunk of 32 input channels, per
tap, per k8 slice, three products a_lo·w_hi, a_hi·w_lo, a_hi·w_hi, each one
wgmma whose 8 exact products of tf32 values are added into the fp32
accumulator and the sum truncated toward zero, as the tensor cores add
(PERF.md, the fp32 attention's findings); with a fresh accumulator per
chunk (`fresh=True`), each chunk's sum added to the running one in fp32
(round to nearest), as an FADD adds it. The gate is the port's fp32 gate (chip_smoke.py phase 11): max abs
err within 1e-4 and mean abs err within 1e-5 of the output's max abs.
One-pass TF32 (operands rounded once, one product) must miss it.

Also here, without JAX: the weight pre-pass's plain layout, and an index
emulation of the consumer's per-lane `ldmatrix` addresses (the tap shift
and the XOR swizzle of the activation halo) that must deliver exactly the
tf32 A fragment of every k8 slice at every tap.

Run with `-s` to see each emulation's error beside the gate.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from faceposegenerator_tpu.ops import fused_gn_conv as jfgc
from faceposegenerator_tpu_torch.ops import fused_gn_conv as fgc
from faceposegenerator_tpu_torch.ops.flash_attention import tf32_round, tf32_split_plain

CASES = {  # (x shape NHWC, Cout, groups): the UNet's K4 widths at a small image, and a ragged Cin
    "64 px, 320 → 32": ((1, 8, 8, 320), 32, 32),
    "64 px, 640 → 16": ((1, 8, 8, 640), 16, 32),
    "ragged: 48 px, 40 → 24": ((1, 6, 8, 40), 24, 8),
}
MAX_ERR, MEAN_ERR = 1e-4, 1e-5
KC = 32  # input channels a chunk of the kernel


def _inputs(shape, cout, seed=3):
    """x = 2·N(0, 1) + 0.5, γ and β unit normal, the weight uniform ±1/√(9·Cin)
    (a conv's default init scale, as chip_smoke.py draws it), HWIO, the bias
    uniform likewise."""
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    bound = (9 * cin) ** -0.5
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    gamma = rng.standard_normal(cin).astype(np.float32)
    beta = rng.standard_normal(cin).astype(np.float32)
    w = rng.uniform(-bound, bound, (3, 3, cin, cout)).astype(np.float32)
    b = rng.uniform(-bound, bound, cout).astype(np.float32)
    return x, gamma, beta, w, b


def _weight(w_hwio):
    """The (Cout, Cin, 3, 3) weight, channels_last as the port keeps it."""
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))).contiguous(
        memory_format=torch.channels_last)


def _add_trunc(acc, p):
    """fp32 acc + p (fp64, exact here), truncated toward zero to fp32."""
    s = acc.double() + p
    f = s.float()
    over = f.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _emulate_3xtf32(x, gamma, beta, w_hwio, b, groups, fresh):
    """y as the kernel computes it (see the module docstring), (N, H, W, Cout)."""
    xt = torch.from_numpy(x)
    a = fgc._silu_activation(xt, torch.from_numpy(gamma), torch.from_numpy(beta), groups, 1e-5)
    n, h, w, cin = a.shape
    ah, al = tf32_split_plain(F.pad(a, (0, 0, 1, 1, 1, 1)))
    wh, wl = fgc.weight_split_plain(_weight(w_hwio)).reshape(2, -1, 9, cin).double()
    cout = wh.shape[0]
    acc = torch.zeros(n * h * w, cout)
    for c0 in range(0, cin, KC):
        part = torch.zeros_like(acc) if fresh else acc
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            th, tl = (t[:, ky:ky + h, kx:kx + w, :].reshape(-1, cin).double() for t in (ah, al))
            for k0 in range(c0, min(c0 + KC, cin), 8):
                k = slice(k0, k0 + 8)
                for pa, pw in ((tl, wh), (th, wl), (th, wh)):
                    part = _add_trunc(part, pa[:, k] @ pw[:, tap, k].T)
        acc = acc + part if fresh else part
    return (acc + torch.from_numpy(b)).reshape(n, h, w, cout).numpy()


def _one_pass_tf32(x, gamma, beta, w_hwio, b, groups):
    """The conv with the activation and the weight rounded once to tf32, one
    product each, fp32 accumulation: what cuDNN computes with TF32 on."""
    xt = torch.from_numpy(x)
    a = fgc._silu_activation(xt, torch.from_numpy(gamma), torch.from_numpy(beta), groups, 1e-5)
    y = F.conv2d(tf32_round(a.permute(0, 3, 1, 2)), tf32_round(_weight(w_hwio)), torch.from_numpy(b), padding=1)
    return y.permute(0, 2, 3, 1).numpy()


def _errs(out, ref):
    err = np.abs(out.astype(np.float64) - ref)
    n = np.abs(ref).max()
    return err.max() / n, err.mean() / n


@pytest.fixture(scope="module")
def jax_refs():
    """Per case: JAX's K4 at fp32 in interpret mode, fp64 numpy."""
    import jax.numpy as jnp

    refs = {}
    for name, (shape, cout, groups) in CASES.items():
        x, gamma, beta, w, b = _inputs(shape, cout)
        y = jfgc.gn_silu_conv3x3(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(w),
                                 jnp.asarray(b), groups, 1e-5, True)
        refs[name] = np.asarray(y).astype(np.float64)
    return refs


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_conv_meets_the_fp32_gate(jax_refs, case):
    """The kernel's arithmetic: a fresh accumulator per 32-channel chunk."""
    shape, cout, groups = CASES[case]
    x, gamma, beta, w, b = _inputs(shape, cout)
    max_rel, mean_rel = _errs(_emulate_3xtf32(x, gamma, beta, w, b, groups, fresh=True), jax_refs[case])
    print(f"\n3xTF32 conv {case}, a fresh accumulator a chunk: max abs err {max_rel:.2e}, mean {mean_rel:.2e} of "
          f"the max abs (gate {MAX_ERR}, {MEAN_ERR})")
    assert max_rel <= MAX_ERR and mean_rel <= MEAN_ERR, (max_rel, mean_rel)


def test_one_chain_of_truncating_adds_keeps_no_margin_at_640_channels(jax_refs):
    """Why the kernel takes a fresh accumulator per chunk: with one chain of
    9·Cin/8 × 3 truncating adds into one accumulator, the error at Cin = 640
    comes within 2× of the fp32 gate (it was over the mean limit when this
    was written), where the fresh accumulator stays ~10× inside it."""
    case = "64 px, 640 → 16"
    shape, cout, groups = CASES[case]
    x, gamma, beta, w, b = _inputs(shape, cout)
    max_rel, mean_rel = _errs(_emulate_3xtf32(x, gamma, beta, w, b, groups, fresh=False), jax_refs[case])
    print(f"\n3xTF32 conv {case}, one chain: max abs err {max_rel:.2e}, mean {mean_rel:.2e} of the max abs")
    assert not (max_rel <= MAX_ERR / 2 and mean_rel <= MEAN_ERR / 2), (max_rel, mean_rel)


def test_one_pass_tf32_misses_the_fp32_gate(jax_refs):
    """The gate tells fp32 from TF32 at the UNet's width."""
    case = "64 px, 320 → 32"
    shape, cout, groups = CASES[case]
    x, gamma, beta, w, b = _inputs(shape, cout)
    max_rel, mean_rel = _errs(_one_pass_tf32(x, gamma, beta, w, b, groups), jax_refs[case])
    print(f"\none-pass TF32 conv {case}: max abs err {max_rel:.2e}, mean {mean_rel:.2e} of the max abs")
    assert not (max_rel <= MAX_ERR and mean_rel <= MEAN_ERR), (max_rel, mean_rel)


def test_weight_split_plain_layout():
    """Plane p, element ((co·3 + ky)·3 + kx)·Cin + ci of the pre-pass's
    output is part p of weight[co, ci, ky, kx]: the kernel's tensor map reads
    it as (Cin, 9, Cout, 2), innermost first. hi and lo are tf32 values (13
    low bits 0) that sum to the weight within 2^-22 relative."""
    rng = np.random.default_rng(0)
    cout, cin = 24, 40
    weight = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3)).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    out = fgc.weight_split_plain(weight)
    assert out.shape == (2, cout, 3, 3, cin) and out.is_contiguous() and out.dtype == torch.float32
    assert not (out.view(torch.int32) & 0x1FFF).any()
    flat = out.reshape(2, -1)
    for co, ci, ky, kx in [(0, 0, 0, 0), (5, 17, 2, 1), (23, 39, 1, 2), (11, 3, 0, 2)]:
        hi, lo = tf32_split_plain(weight[co, ci, ky, kx].reshape(1))
        at = ((co * 3 + ky) * 3 + kx) * cin + ci
        assert flat[0, at] == hi[0] and flat[1, at] == lo[0]
    w_cl = weight.permute(0, 2, 3, 1)
    assert ((out[0] + out[1] - w_cl).abs() <= 2.0**-22 * w_cl.abs()).all()


def _halo_swizzled(tw, tr):
    """The normalisers' activation halo as the kernel lays it out: pixel p of
    the (tr + 2) × (tw + 2) halo at byte 128·p, its 16-byte group g (fp32
    channels 4g..4g + 3 of the chunk) at group g ^ (p % 8). Returns
    {byte offset: (halo pixel, channel)} for every 4-byte word."""
    words = {}
    for p in range((tr + 2) * (tw + 2)):
        for ch in range(KC):
            words[128 * p + 16 * ((ch // 4) ^ (p % 8)) + 4 * (ch % 4)] = (p, ch)
    return words


def _ldmatrix_x4(addrs, words):
    """ldmatrix.m8n8.x4.b16: lanes 8i..8i + 7 give the row addresses of
    matrix i; lane l receives from each matrix the 4 bytes at 4·(l % 4) of
    row l // 4. Returns [lane][matrix] → (halo pixel, channel)."""
    return [[words[addrs[8 * i + lane // 4] + 4 * (lane % 4)] for i in range(4)] for lane in range(32)]


@pytest.mark.parametrize("tw", [64, 32])
def test_ldmatrix_addresses_give_the_tf32_a_fragment(tw):
    """For each consumer warpgroup wg, warp w, tap and k8 slice kk, the
    kernel's per-lane address (pixel m = 64·wg + 16·w + lane % 16 of the
    tile, shifted by the tap; 16-byte group 2·kk + lane // 16, XOR-swizzled
    by the halo pixel's low 3 bits) makes ldmatrix.x4 deliver register j of
    lane l the A element (row, k) = ((g, t), (g + 8, t), (g, t + 4),
    (g + 8, t + 4))[j], g = l // 4, t = l % 4: the tf32 wgmma A fragment
    (csrc/sm90_common.cuh). Each 8-address phase hits 8 distinct 16-byte
    bank groups."""
    tr = 128 // tw
    hw2 = tw + 2
    words = _halo_swizzled(tw, tr)
    for wg in range(2):
        for w in range(4):
            for tap in range(9):
                addrs = []
                for lane in range(32):
                    m = 64 * wg + 16 * w + (lane & 15)
                    half = lane >> 4
                    hp = (m // tw) * hw2 + m % tw + (tap // 3) * hw2 + tap % 3
                    addrs.append(hp * 128)
                for kk in range(4):
                    lane_addrs = []
                    for lane in range(32):
                        hp = addrs[lane] // 128
                        lane_addrs.append(hp * 128 + (((2 * kk + (lane >> 4)) ^ (hp & 7)) << 4))
                    for phase in range(4):
                        banks = {(a % 128) // 16 for a in lane_addrs[8 * phase:8 * phase + 8]}
                        assert len(banks) == 8, (wg, w, tap, kk, phase)
                    got = _ldmatrix_x4(lane_addrs, words)
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        for j, (row, k) in enumerate(((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4))):
                            m = 64 * wg + 16 * w + row
                            hp = (m // tw) * hw2 + m % tw + (tap // 3) * hw2 + tap % 3
                            assert got[lane][j] == (hp, 8 * kk + k), (wg, w, tap, kk, lane, j)
