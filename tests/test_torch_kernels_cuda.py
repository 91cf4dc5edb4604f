"""The CUDA kernels of the port against their plain PyTorch version, on a card.

These tests carry the `cuda` marker and skip without a card; run them on one
with `python -m pytest tests/test_torch_kernels_cuda.py -m cuda`. This file
imports no JAX, so it runs where only the port's dependencies are installed.

Limits: outputs within 2e-2 max and 2e-3 mean absolute error of the fp32
plain version on the same bf16 inputs, gradients within 2e-2 and 2e-3 of
their max abs (a key's dk and dv sum over every query, so they grow with
Sq/Skv); the log-sum-exp within 1e-3. K7 (qdense) makes the same codes as
its plain version, so each output is within 1 bf16 ulp plus 1e-3 relative of
it; K8 (flash_int8) within 2e-2 max and 2e-3 mean of its plain version.
The fp32 instances (flash_*_f32 and gn_silu_conv3x3_f32 in 3xTF32 on the
tensor cores) are held to fp32: outputs within 1e-4 of the output's max abs
and a mean abs error within 1e-5 of it, the log-sum-exp within 1e-5,
gradients the same relative to their max abs; their split pre-passes
(flash_f32_split, gn_conv_f32_split) are bit-exact against their plain
versions;
qdense_f32 and flash_int8_f32 make their plain versions' codes, so each
output is within 1 fp32 ulp + 1e-3 relative of the plain one.
K3 (fused_group_norm) makes the same fp32 statistics as its plain version in
another order: each output within 1 ulp of its dtype + 1e-3 relative + 1e-5
of the output's max abs (the order moves outputs near 0 by ~1e-6 of the
largest) of the plain one. K4 (gn_silu_conv3x3) within 1 bf16 ulp + 1e-3 of
the output's max abs.
"""

import numpy as np
import pytest
import torch

from faceposegenerator_tpu_torch.ops import flash_attention as fa
from faceposegenerator_tpu_torch.ops import fused_gn as fg
from faceposegenerator_tpu_torch.ops import fused_gn_conv as fgc
from faceposegenerator_tpu_torch.ops import qdense as qd
from faceposegenerator_tpu_torch.ops.quant import quantize_weight
from faceposegenerator_tpu_torch.ops.attention import dot_product_attention


def _qkv(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d)))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _close(out, ref, max_err=2e-2, mean_err=2e-3, relative=False):
    err = (out.float() - ref.float()).abs()
    n = ref.float().abs().max().item() if relative else 1.0
    assert err.max().item() <= max_err * n and err.mean().item() <= mean_err * n, (err.max().item(), err.mean().item(), n)


def _close32(out, ref, max_err=1e-4, mean_err=1e-5):
    """The fp32 gate: max and mean abs err within max_err and mean_err of
    the output's max abs."""
    assert out.dtype == torch.float32
    _close(out, ref, max_err, mean_err, relative=True)


def _same_codes(out, ref, mean_err=1e-4):
    """K7 and K8 make their plain versions' codes: each output within 1 ulp
    of its dtype (bf16 or fp32) + 1e-3 relative of the plain one, and the
    mean abs err within `mean_err`."""
    bits = 24 if out.dtype == torch.float32 else 8
    ref = ref.float()
    err = (out.float() - ref).abs()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref.abs().clamp_min(2.0**-126))[1] - bits)
    assert (err <= ulp + 1e-3 * ref.abs()).all() and err.mean().item() <= mean_err, (err.max().item(), err.mean().item())


FWD_CASES = [  # (b, sq, skv, h, d, kv_len)
    (2, 200, 200, 5, 64, None), (2, 130, 77, 3, 64, None), (1, 64, 128, 2, 64, 77),
    (2, 100, 100, 1, 512, None), (1, 64, 96, 2, 128, 50),
    # K1: kv_len inside the first 128-key tile; Sq = 64 (half a CTA idle) and a ragged Sq = 200
    (1, 64, 128, 2, 64, 50), (2, 64, 64, 4, 64, None), (2, 200, 333, 3, 64, 300),
    # ToMe at ratio 0.5 on the CFG batch of 8: L0's self-attention merged to 2048 tokens, and
    # its cross-attention from 2048 queries (tome_ops "xattn") over the 77 text keys
    (16, 2048, 2048, 5, 64, None), (16, 2048, 77, 5, 64, 77),
    # the eval ViTs' self-attention at 224²: DINOv2 L/14 (257 tokens: a third query tile with one
    # row, one key past two full tiles), MAE L/16 (197), CLIP B/32 (50, inside one tile)
    (4, 257, 257, 16, 64, None), (4, 197, 197, 16, 64, None), (8, 50, 50, 12, 64, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,kv_len", FWD_CASES)
def test_cuda_kernels_match_plain(b, sq, skv, h, d, kv_len):
    _card()
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in _qkv(7, b, sq, skv, h, d))
    fa.reset_launch_counts()
    out = dot_product_attention(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    name = "flash_fwd_d64" if d == 64 else "flash_fwd_wide"
    assert fa.LAUNCHES[name] == 1
    ref = fa.attention_plain(q.float(), k.float(), v.float(), d**-0.5, kv_len)
    _close(out, ref)


@pytest.mark.cuda
def test_cuda_rejects_what_no_kernel_takes():
    """fp32 computes on the fp32 kernels; what JAX's flash_supported refuses
    (fp16, head dim 96) raises under impl="flash" and is the plain einsum
    under impl="auto", decided before any launch."""
    _card()
    q = torch.randn(1, 8, 2, 64, device="cuda")
    fa.reset_launch_counts()
    out = dot_product_attention(q, q, q)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd_f32"] == 1 and out.dtype == torch.float32
    _close32(out, fa.attention_plain(q, q, q, 0.125))
    for q in (torch.randn(1, 8, 2, 64, device="cuda").half(),
              torch.randn(1, 8, 2, 96, device="cuda", dtype=torch.bfloat16)):
        with pytest.raises(ValueError):
            dot_product_attention(q, q, q, impl="flash")
        fa.reset_launch_counts()
        out = dot_product_attention(q, q, q)
        assert not any(fa.LAUNCHES.values())
        assert torch.equal(out, fa.attention_plain(q, q, q, q.shape[-1] ** -0.5))
    # K6 and K3 raise on a CUDA tensor they do not take, before any launch:
    # no plain fallback on the card
    fa.reset_launch_counts()
    fg.reset_launch_counts()
    for d, dtype in ((96, torch.bfloat16), (640, torch.bfloat16), (512, torch.float16)):
        q = torch.randn(1, 64, 1, d, device="cuda").to(dtype)
        lse = torch.zeros(1, 1, 64, device="cuda")
        with pytest.raises(ValueError):
            fa.flash_bwd_wide(q, q, q, q, lse, q, d**-0.5)
    q = torch.randn(1, 64, 1, 512, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # an fp16 log-sum-exp
        fa.flash_bwd_wide(q, q, q, q, torch.zeros(1, 1, 64, device="cuda").half(), q, 512**-0.5)
    x = torch.randn(2, 8, 8, 64, device="cuda")
    gamma, beta = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    for bad in (dict(x=x.half()), dict(x=x[..., :60], gamma=gamma[:60], beta=beta[:60]),
                dict(x=torch.randn(1, 4, 4096, device="cuda")), dict(gamma=gamma.double()),
                dict(beta=beta.half()), dict(gamma=torch.ones(64, 2, device="cuda")[:, 0])):
        args = {**dict(x=x, gamma=gamma, beta=beta), **bad}
        with pytest.raises(ValueError):
            fg.fused_group_norm(args["x"], args["gamma"], args["beta"], 8)
    assert not any(fa.LAUNCHES.values()) and not any(fg.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,kv_len", FWD_CASES + [(1, 100, 77, 2, 256, None), (1, 70, 90, 1, 384, 80)])
def test_cuda_f32_forward_matches_plain(b, sq, skv, h, d, kv_len):
    """flash_fwd_f32 through dot_product_attention and with the log-sum-exp."""
    _card()
    q, k, v = (torch.from_numpy(a).cuda() for a in _qkv(8, b, sq, skv, h, d))
    fa.reset_launch_counts()
    out = dot_product_attention(q, k, v, kv_len=kv_len)
    o, lse = fa.flash_fwd_f32(q, k, v, d**-0.5, kv_len, with_lse=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd_f32"] == fa.LAUNCHES["flash_f32_split"] == 2 and sum(fa.LAUNCHES.values()) == 4
    ref, ref_lse = fa.attention_plain_lse(q, k, v, d**-0.5, kv_len)
    _close32(out, ref)
    _close32(o, ref)
    assert (lse - ref_lse).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,kv_len", [(2, 200, 200, 5, 64, None), (1, 130, 128, 2, 64, 77),
                                                 (2, 64, 77, 3, 64, None), (1, 100, 100, 1, 512, None),
                                                 (1, 64, 96, 2, 128, 50), (2, 200, 77, 3, 64, None),
                                                 (1, 90, 70, 2, 256, None)])
def test_cuda_f32_backward_matches_plain(b, sq, skv, h, d, kv_len):
    """The fp32 dK/dV and dQ passes on the fp32 forward's o and lse, through
    FlashAttention and alone; keys at >= kv_end get zero gradients."""
    _card()
    q, k, v = (torch.from_numpy(a).cuda().requires_grad_() for a in _qkv(5, b, sq, skv, h, d))
    do = torch.from_numpy(np.random.default_rng(6).standard_normal((b, sq, h, d)).astype(np.float32)).cuda()
    fa.reset_launch_counts()
    out = dot_product_attention(q, k, v, kv_len=kv_len)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert {n: c for n, c in fa.LAUNCHES.items() if c} == {
        "flash_fwd_f32": 1, "flash_bwd_f32_dkv": 1, "flash_bwd_f32_dq": 1, "flash_f32_split": 2}
    q, k, v = (t.detach() for t in (q, k, v))
    o, lse = fa.attention_plain_lse(q, k, v, d**-0.5, kv_len)
    refs = fa.attention_bwd_plain(q, k, v, o, lse, do, d**-0.5, kv_len)
    for g, r in zip(grads, refs):
        _close32(g, r)
    alone = fa.flash_bwd_f32(q, k, v, o, lse, do, d**-0.5, kv_len)
    for g, r in zip(alone, refs):
        _close32(g, r)
    if kv_len is not None:
        assert grads[1][:, kv_len:].abs().max().item() == 0.0 and grads[2][:, kv_len:].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", [(2, 200, 5, 64), (1, 77, 3, 512), (3, 64, 2, 128)])
def test_cuda_f32_split_matches_plain(b, s, h, d):
    """flash_f32_split writes the tf32 hi/lo planes of `f32_split_plain`
    bit for bit, natural and transposed, from strided views of a fused
    projection."""
    _card()
    qkv = torch.from_numpy(np.random.default_rng(9).standard_normal((b, s, 3, h, d)).astype(np.float32)).cuda()
    q, k, _ = qkv.unbind(2)
    fa.reset_launch_counts()
    got = fa.f32_split([(q, False), (k, True), (q, True)])
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_f32_split"] == 1
    for out, (t, tr) in zip(got, [(q, False), (k, True), (q, True)]):
        assert torch.equal(out, fa.f32_split_plain(t, tr))


BWD_CASES = [  # (b, sq, skv, h, d, kv_len): small and ragged, then a train shape of each kernel
    (2, 200, 200, 5, 64, None), (1, 130, 128, 2, 64, 77), (2, 64, 77, 3, 64, None),
    (8, 1024, 1024, 10, 64, None), (8, 4096, 77, 5, 64, None),
    (1, 100, 100, 1, 512, None), (1, 64, 96, 2, 128, 50), (4, 4096, 4096, 1, 512, None),
    # K5: kv_len inside the first 128-key tile; Sq = 64 and a ragged Sq = 200 over 77 keys
    (1, 64, 128, 2, 64, 50), (2, 64, 64, 4, 64, None), (2, 200, 77, 3, 64, None),
    # the eval ViTs' gradients: GradCAM on DINOv2 (1 × 16 heads × 257², the dK/dV pass's last CTA
    # owning one key row), make_heatmap_fn at batch 4, MAE's and CLIP's lengths
    (1, 257, 257, 16, 64, None), (4, 257, 257, 16, 64, None), (2, 197, 197, 16, 64, None),
    (2, 50, 50, 12, 64, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,kv_len", BWD_CASES)
def test_cuda_lse_and_backward_match_plain(b, sq, skv, h, d, kv_len):
    """K1/K2 with the log-sum-exp, then the K5/K6 pair on the forward's own
    o and lse, against the plain versions in fp32 on the same inputs; keys
    at >= kv_len get zero gradients."""
    _card()
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in _qkv(3, b, sq, skv, h, d))
    do = torch.from_numpy(np.random.default_rng(4).standard_normal((b, sq, h, d)).astype(np.float32))
    do = do.cuda().to(torch.bfloat16)
    scale = d**-0.5
    fwd, bwd, kind = (fa.flash_fwd_d64, fa.flash_bwd_d64, "d64") if d == 64 else \
        (fa.flash_fwd_wide, fa.flash_bwd_wide, "wide")
    fa.reset_launch_counts()
    o, lse = fwd(q, k, v, scale, kv_len, with_lse=True)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.attention_plain_lse(q.float(), k.float(), v.float(), scale, kv_len)
    _close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    grads = bwd(q, k, v, o, lse, do, scale, kv_len)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[f"flash_bwd_{kind}_dkv"] == 1 and fa.LAUNCHES[f"flash_bwd_{kind}_dq"] == 1
    refs = fa.attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale, kv_len)
    for g, r in zip(grads, refs):
        _close(g, r, relative=True)
    if kv_len is not None:
        assert grads[1][:, kv_len:].abs().max().item() == 0.0
        assert grads[2][:, kv_len:].abs().max().item() == 0.0


WIDE_CASES = [  # (b, sq, skv, h, d, kv_len): every head dim, ragged Sq and Skv, kv_len mid-tile, the VAE shape
    (1, 200, 200, 2, 128, None), (2, 70, 130, 1, 256, 77), (1, 130, 64, 3, 384, None), (1, 64, 100, 2, 384, 33),
    (2, 100, 333, 1, 512, 300), (1, 4096, 4096, 1, 512, None),
    # at D = 512: kv_len mid-way through a 32- and a 64-key tile, and fewer keys than one tile
    (1, 160, 256, 2, 512, 150), (2, 96, 20, 1, 512, None),
    # the VAE's mid attention under decode_chunk=2
    (2, 4096, 4096, 1, 512, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "fused qkv views"])
@pytest.mark.parametrize("with_lse", [False, True], ids=["o", "o+lse"])
@pytest.mark.parametrize("b,sq,skv,h,d,kv_len", WIDE_CASES)
def test_cuda_flash_fwd_wide_matches_plain(b, sq, skv, h, d, kv_len, with_lse, strided):
    """K2 at every head dim it takes, with and without kv_len and the
    log-sum-exp, on contiguous tensors and on strided q/k/v views of one
    fused projection (q's rows padded to Skv's count there)."""
    _card()
    rng = np.random.default_rng(sq + skv + d)
    if strided:
        s = max(sq, skv)
        qkv = torch.from_numpy(rng.standard_normal((b, s, 3, h, d)).astype(np.float32)).cuda().to(torch.bfloat16)
        q, k, v = qkv[:, :sq, 0], qkv[:, :skv, 1], qkv[:, :skv, 2]
    else:
        q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in _qkv(sq, b, sq, skv, h, d))
    scale = d**-0.5
    fa.reset_launch_counts()
    out = fa.flash_fwd_wide(q, k, v, scale, kv_len, with_lse=with_lse)
    torch.cuda.synchronize()
    assert {n: c for n, c in fa.LAUNCHES.items() if c} == {"flash_fwd_wide": 1}
    ref, ref_lse = fa.attention_plain_lse(q.float(), k.float(), v.float(), scale, kv_len)
    if with_lse:
        out, lse = out
        assert lse.shape == (b, h, sq) and (lse - ref_lse).abs().max().item() <= 1e-3
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    _close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "fused qkv views"])
@pytest.mark.parametrize("b,sq,skv,h,d,kv_len", WIDE_CASES)
def test_cuda_flash_bwd_wide_matches_plain(b, sq, skv, h, d, kv_len, strided):
    """K6 (two launches for dK/dV, one for dQ) at every head dim it takes,
    on the forward's own o and lse, on contiguous tensors and on strided
    q/k/v views of one fused projection: each gradient against the plain
    version relative to its max abs, zero dk and dv past kv_len, and two
    runs bitwise equal (no atomics)."""
    _card()
    rng = np.random.default_rng(sq + skv + d + 1)
    if strided:
        s = max(sq, skv)
        qkv = torch.from_numpy(rng.standard_normal((b, s, 3, h, d)).astype(np.float32)).cuda().to(torch.bfloat16)
        q, k, v = qkv[:, :sq, 0], qkv[:, :skv, 1], qkv[:, :skv, 2]
    else:
        q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in _qkv(sq + 1, b, sq, skv, h, d))
    do = torch.from_numpy(rng.standard_normal((b, sq, h, d)).astype(np.float32)).cuda().to(torch.bfloat16)
    scale = d**-0.5
    o, lse = fa.flash_fwd_wide(q, k, v, scale, kv_len, with_lse=True)
    fa.reset_launch_counts()
    grads = fa.flash_bwd_wide(q, k, v, o, lse, do, scale, kv_len)
    torch.cuda.synchronize()
    assert {n: c for n, c in fa.LAUNCHES.items() if c} == {"flash_bwd_wide_dkv": 1, "flash_bwd_wide_dq": 1}
    refs = fa.attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale, kv_len)
    for g, r, x in zip(grads, refs, (q, k, v)):
        assert g.shape == x.shape and g.dtype == torch.bfloat16
        _close(g, r, relative=True)
    if kv_len is not None:
        assert grads[1][:, kv_len:].abs().max().item() == 0.0 and grads[2][:, kv_len:].abs().max().item() == 0.0
    for a, again in zip(grads, fa.flash_bwd_wide(q, k, v, o, lse, do, scale, kv_len)):
        assert torch.equal(a, again)


@pytest.mark.cuda
def test_cuda_autograd_goes_through_the_kernels():
    """With a gradient to take, attention runs FlashAttention: one forward
    with the log-sum-exp and both backward passes, on strided q/k/v views."""
    _card()
    qkv = torch.randn(2, 256, 3, 4, 64, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    q, k, v = qkv.unbind(2)
    fa.reset_launch_counts()
    out = dot_product_attention(q, k, v)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert {n: c for n, c in fa.LAUNCHES.items() if c} == {"flash_fwd_d64": 1, "flash_bwd_d64_dkv": 1,
                                                          "flash_bwd_d64_dq": 1}
    ref_in = qkv.detach().float().requires_grad_()
    rq, rk, rv = ref_in.unbind(2)
    fa.attention_plain(rq, rk, rv, 0.125).square().sum().backward()
    assert torch.isfinite(qkv.grad).all()
    cos = torch.nn.functional.cosine_similarity(qkv.grad.float().flatten(), ref_in.grad.flatten(), dim=0)
    assert cos.item() >= 0.99


@pytest.mark.cuda
def test_cuda_d64_kernels_keep_batch_rows_apart():
    """Batch row 1's k and v are 1e3 times batch row 0's scale, over 77 keys
    (a ragged tile): batch row 0's output, lse and gradients match the plain
    version on row 0 alone, which fails if a tile reads past its row's S."""
    _card()
    b, sq, skv, h = 2, 200, 77, 3
    q, k, v = (torch.from_numpy(a).cuda() for a in _qkv(21, b, sq, skv, h, 64))
    k[1] *= 1e3
    v[1] *= 1e3
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    do = torch.from_numpy(np.random.default_rng(22).standard_normal((b, sq, h, 64)).astype(np.float32))
    do = do.cuda().to(torch.bfloat16)
    o, lse = fa.flash_fwd_d64(q, k, v, 0.125, with_lse=True)
    grads = fa.flash_bwd_d64(q, k, v, o, lse, do, 0.125)
    torch.cuda.synchronize()
    r = [t[:1].float() for t in (q, k, v)]
    o_ref, lse_ref = fa.attention_plain_lse(*r, 0.125)
    _close(o[:1], o_ref)
    assert (lse[:1] - lse_ref).abs().max().item() <= 1e-3
    refs = fa.attention_bwd_plain(*r, o[:1].float(), lse[:1], do[:1].float(), 0.125)
    for g, ref in zip(grads, refs):
        _close(g[:1], ref, relative=True)


@pytest.mark.cuda
def test_cuda_flash_bwd_d64_is_deterministic():
    """Two passes with no atomics: two runs on the same inputs give bitwise
    equal dq, dk and dv."""
    _card()
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in _qkv(23, 2, 1024, 1024, 5, 64))
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(24), device="cuda")
    do = do.to(torch.bfloat16)
    o, lse = fa.flash_fwd_d64(q, k, v, 0.125, with_lse=True)
    first = fa.flash_bwd_d64(q, k, v, o, lse, do, 0.125)
    second = fa.flash_bwd_d64(q, k, v, o, lse, do, 0.125)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_d64_kernels_take_strided_fused_qkv_views():
    """q, k and v as strided views of one fused projection (row stride
    3·H·64) at the UNet's largest self-attention, 2 × 4096 tokens × 5 heads:
    forward, lse and gradients against the plain version."""
    _card()
    qkv = torch.from_numpy(np.random.default_rng(25).standard_normal((2, 4096, 3, 5, 64)).astype(np.float32))
    q, k, v = qkv.cuda().to(torch.bfloat16).unbind(2)
    assert q.stride() == (4096 * 960, 960, 64, 1)
    do = torch.from_numpy(np.random.default_rng(26).standard_normal((2, 4096, 5, 64)).astype(np.float32))
    do = do.cuda().to(torch.bfloat16)
    o, lse = fa.flash_fwd_d64(q, k, v, 0.125, with_lse=True)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.attention_plain_lse(q.float(), k.float(), v.float(), 0.125)
    _close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    del o_ref
    grads = fa.flash_bwd_d64(q, k, v, o, lse, do, 0.125)
    torch.cuda.synchronize()
    refs = fa.attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse, do.float(), 0.125)
    for g, ref in zip(grads, refs):
        _close(g, ref, relative=True)


QDENSE_CASES = [  # (lead, K, N, static): ragged M and N, the widest K, the cross k/v rows, the widest
    # fused K (1280) and the narrowest wide one (2560), K not a multiple of 64; from 2048 rows the
    # fused instance (quantize in the GEMM), below it the wide one (qdense_quant first)
    ((130,), 64, 72, False), ((2, 77), 1024, 320, True), ((257,), 320, 960, False),
    ((3, 100), 5120, 1280, False), ((4, 333), 640, 2568, True), ((1232,), 1024, 320, False),
    ((300,), 1280, 392, False), ((2, 150), 2560, 640, True), ((3, 200), 2560, 640, False), ((70,), 96, 40, True),
    ((2100,), 1280, 392, False), ((2, 1030), 320, 968, True), ((4097,), 96, 136, False), ((2048,), 1024, 320, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("lead,k,n,static", QDENSE_CASES)
def test_cuda_qdense_matches_plain(lead, k, n, static):
    _card()
    rng = np.random.default_rng(k + n)
    x = torch.from_numpy(rng.standard_normal((*lead, k)).astype(np.float32)).cuda().to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32) * k**-0.5).cuda()
    qw = quantize_weight(w)
    a = float(x.float().abs().amax()) / 127.0 if static else None
    qd.reset_launch_counts()
    out = qd.qdense_kernel(x, qw.q, qw.s, a)
    torch.cuda.synchronize()
    assert qd.LAUNCHES == {"qdense": 1, "qdense_f32": 0, "qdense_quant": int(qd.is_wide(int(np.prod(lead)), k))}
    assert out.shape == (*lead, n) and out.dtype == torch.bfloat16
    _same_codes(out, qd.qdense_plain(x, qw.q, qw.s, a))


@pytest.mark.cuda
def test_cuda_qdense_rejects_what_the_kernel_does_not_take():
    _card()
    qw = quantize_weight(torch.randn(64, 48, device="cuda"))
    with pytest.raises(ValueError, match="K % 32"):
        qd.qdense_kernel(torch.randn(8, 48, device="cuda", dtype=torch.bfloat16), qw.q, qw.s)
    qw = quantize_weight(torch.randn(64, 64, device="cuda"))
    with pytest.raises(ValueError, match="bf16"):
        qd.qdense_kernel(torch.randn(8, 64, device="cuda").half(), qw.q, qw.s)


@pytest.mark.cuda
@pytest.mark.parametrize("lead,k,n,static", QDENSE_CASES)
def test_cuda_qdense_f32_matches_plain(lead, k, n, static):
    _card()
    rng = np.random.default_rng(k + n + 1)
    x = torch.from_numpy(rng.standard_normal((*lead, k)).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32) * k**-0.5).cuda()
    qw = quantize_weight(w)
    a = float(x.abs().amax()) / 127.0 if static else None
    qd.reset_launch_counts()
    out = qd.qdense_kernel(x, qw.q, qw.s, a)
    torch.cuda.synchronize()
    assert qd.LAUNCHES == {"qdense": 0, "qdense_f32": 1, "qdense_quant": int(qd.is_wide(int(np.prod(lead)), k))}
    assert out.shape == (*lead, n)
    _same_codes(out, qd.qdense_plain(x, qw.q, qw.s, a))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("static", [False, True])
def test_cuda_qdense_quant_matches_quantize(dtype, static):
    """The wide instance's quantize pass writes quantize()'s codes and row
    scales, bit for bit."""
    _card()
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((333, 2560)).astype(np.float32) * 3).cuda().to(dtype)
    a = float(x.float().abs().amax()) / 127.0 if static else None
    codes, sx = qd.quantize_rows(x, a)
    want, want_sx = qd.quantize(x, -1, a)
    assert torch.equal(codes, want.to(torch.int8))
    assert sx is None if static else torch.equal(sx, want_sx.reshape(-1))


INT8_CASES = [  # (b, sq, skv, h, kv_len): odd heads, ragged tiles, masked keys, the UNet's largest,
    # and past one 4096-key block: kv_len in the second block, a third block, the 640² self-attention
    (2, 256, 256, 5, None), (2, 130, 77, 3, None), (1, 64, 128, 2, 77), (2, 200, 333, 4, 300),
    (16, 4096, 4096, 5, None), (16, 4096, 77, 5, None),
    (1, 128, 4224, 2, 4160), (1, 300, 9000, 3, None), (2, 6400, 6400, 5, None), (1, 96, 8300, 2, 4100),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,kv_len", INT8_CASES)
def test_cuda_flash_int8_matches_plain(b, sq, skv, h, kv_len):
    _card()
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in _qkv(11, b, sq, skv, h, 64))
    fa.reset_launch_counts()
    out = dot_product_attention(q, k, v, kv_len=kv_len, impl="flash_int8")
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_int8"] == fa.LAUNCHES["flash_int8_amax"] == fa.LAUNCHES["flash_int8_codes"] == 1
    assert fa.LAUNCHES["flash_fwd_d64"] == 0
    _same_codes(out, fa.attention_int8_plain(q, k, v, 0.125, kv_len))
    # close to exact attention as the JAX test holds it, q and k at half
    # scale: at unit scale over 4096 keys most p sit on the lowest codes of
    # the 1/127 grid and the relative error of the function itself is ~4%
    q, k = q * 0.5, k * 0.5
    out = fa.flash_attention_int8(q, k, v, 0.125, kv_len)
    exact = fa.attention_plain(q.float(), k.float(), v.float(), 0.125, kv_len)
    assert ((out.float() - exact).norm() / exact.norm()).item() < 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,kv_len", INT8_CASES)
def test_cuda_flash_int8_f32_matches_plain(b, sq, skv, h, kv_len):
    _card()
    q, k, v = (torch.from_numpy(a).cuda() for a in _qkv(13, b, sq, skv, h, 64))
    fa.reset_launch_counts()
    out = dot_product_attention(q, k, v, kv_len=kv_len, impl="flash_int8")
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_int8_f32"] == fa.LAUNCHES["flash_int8_amax"] == fa.LAUNCHES["flash_int8_codes"] == 1
    assert sum(fa.LAUNCHES.values()) == 3 and out.dtype == torch.float32
    _same_codes(out, fa.attention_int8_plain(q, k, v, 0.125, kv_len))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("strided", [False, True])
def test_cuda_flash_int8_codes_match_plain(dtype, strided):
    """The amax and codes launches write int8_codes_plain's codes, layouts
    and constants bit for bit, from contiguous tensors or from the strided
    views of a fused q/k/v projection."""
    _card()
    rng = np.random.default_rng(17)
    if strided:
        qkv = torch.from_numpy(rng.standard_normal((2, 333, 3, 3, 64)).astype(np.float32)).cuda().to(dtype)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.from_numpy(a).cuda().to(dtype) for a in _qkv(17, 2, 130, 300, 3, 64))
    q8, k8, vt, ws = fa.int8_codes(q, k, v, 0.125)
    want = fa.int8_codes_plain(q, k, v, 0.125)
    for got, ref in zip((q8, k8, vt, ws[4:6]), want):
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_flash_int8_quantizes_p_against_the_full_row_max():
    """The row max sits in the last 64-key tile: a kernel that quantized p
    against a running max would make other codes and miss the plain version."""
    _card()
    rng = np.random.default_rng(12)
    q = rng.standard_normal((1, 128, 2, 64)).astype(np.float32)
    k = rng.standard_normal((1, 256, 2, 64)).astype(np.float32) * 0.3
    k[:, 200:] = 3.0 * q[:, :56].mean(1, keepdims=True)  # keys the queries align with
    v = rng.standard_normal((1, 256, 2, 64)).astype(np.float32)
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in (q, k, v))
    out = fa.flash_attention_int8(q, k, v, 0.125)
    torch.cuda.synchronize()
    _same_codes(out, fa.attention_int8_plain(q, k, v, 0.125))


def _ulp(ref, bits):
    return torch.ldexp(torch.ones_like(ref), torch.frexp(ref.abs().clamp_min(2.0**-126))[1] - bits)


def _within_ulp(out, ref, rel, of_max):
    """How many outputs are not within 1 ulp of their dtype (8 or 24
    significant bits) + `rel`·|ref| + `of_max`·max |ref| of ref."""
    ref = ref.float()
    bits = 8 if out.dtype == torch.bfloat16 else 24
    slack = rel * ref.abs() + of_max * ref.abs().max()
    return int(((out.float() - ref).abs() > _ulp(ref, bits) + slack).sum())


GN_CASES = [  # (shape, groups, act, dtype): the JAX test's shapes, then main-path shapes
    ((2, 16, 16, 320), 32, "silu", torch.bfloat16), ((2, 8, 8, 64), 8, None, torch.float32),
    ((1, 24, 8, 96), 16, "silu", torch.bfloat16), ((2, 8, 8, 64), 8, "silu", torch.float32),
    ((16, 64, 64, 320), 32, None, torch.bfloat16), ((16, 32, 32, 640), 32, None, torch.bfloat16),
    ((16, 16, 16, 640), 32, "silu", torch.bfloat16), ((8, 64, 64, 512), 32, "silu", torch.bfloat16),
    # K4's GroupNorm+SiLU sites that go to K3 when GN_IMPL alone is pallas
    ((16, 64, 64, 640), 32, "silu", torch.bfloat16), ((16, 32, 32, 320), 32, "silu", torch.bfloat16),
    # K3's cluster plan: images whose chunks the ring holds only in part (the
    # rest read again) in fp32, a tiny one, and S not a multiple of a CTA's rows
    ((16, 64, 64, 320), 32, "silu", torch.float32), ((4, 64, 64, 512), 32, None, torch.float32),
    ((1, 16, 16, 640), 32, "silu", torch.bfloat16), ((3, 37, 29, 320), 32, None, torch.bfloat16),
    ((2, 61, 67, 512), 16, "silu", torch.float32), ((1, 3, 5, 64), 8, None, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16], ids=["fp32 gamma", "bf16 gamma"])
@pytest.mark.parametrize("shape,groups,act,dtype", GN_CASES)
def test_cuda_fused_group_norm_matches_plain(shape, groups, act, dtype, param_dtype):
    """K3 in one launch at every cluster plan: against its plain version
    within 1 ulp + 1e-3 relative + 1e-5 of the max abs, with gamma and beta
    in either dtype, and bitwise equal on a second run."""
    _card()
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = torch.from_numpy((rng.standard_normal(shape) * 3 + 1).astype(np.float32)).cuda().to(dtype)
    gamma, beta = (torch.from_numpy(rng.standard_normal(c).astype(np.float32)).cuda().to(param_dtype) for _ in "gb")
    fg.reset_launch_counts()
    out = fg.fused_group_norm(x, gamma, beta, groups, 1e-6, act)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["fused_group_norm"] == 1 and out.dtype == dtype and out.shape == x.shape
    assert _within_ulp(out, fg.fused_group_norm_plain(x, gamma, beta, groups, 1e-6, act), 1e-3, 1e-5) == 0
    assert torch.equal(out, fg.fused_group_norm(x, gamma, beta, groups, 1e-6, act))


@pytest.mark.cuda
def test_cuda_fused_group_norm_clusters_fit_the_card():
    """At the main paths' GroupNorm shapes the card holds every image's
    cluster of `cluster_plan` at once (cudaOccupancyMaxActiveClusters >= N):
    one wave."""
    import ctypes

    from faceposegenerator_tpu_torch.ops import _build

    _card()
    fn = _build.load("fused_gn").fused_group_norm_clusters
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    for n, s, c in ((16, 4096, 320), (16, 1024, 640), (16, 256, 640), (16, 4096, 640), (16, 1024, 320),
                    (8, 4096, 512), (4, 4096, 512), (1, 256, 640)):
        for item in (2, 4):
            cluster, rows, stages = fg.cluster_plan(n, s, c, item)
            active = ctypes.c_int(0)
            assert fn(n, c, cluster, stages, int(item == 2), ctypes.byref(active)) == 0
            assert active.value >= n, (n, s, c, item, cluster, active.value)


@pytest.mark.cuda
@pytest.mark.parametrize("per_sm", [1, 2])
def test_cuda_wave_clusters_are_the_cards(per_sm):
    """`cluster_plan`'s table of the clusters the card runs at once with
    one CTA an SM (`_WAVE_CLUSTERS`) is what the card reports for K3's
    launch (cudaOccupancyMaxActiveClusters), and with two CTAs an SM the
    card runs at least twice as many, as the plan assumes."""
    import ctypes

    from faceposegenerator_tpu_torch.ops import _build

    _card()
    fn = _build.load("fused_gn").fused_group_norm_clusters
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    cap = min(fg.SMEM_MAX, fg.SM_SMEM // per_sm - 1024)
    stages = max(st for st in range(1, 32) if fg.cluster_smem(320, 2, st) <= cap)
    for cluster, want in fg._WAVE_CLUSTERS.items():
        active = ctypes.c_int(0)
        assert fn(16, 320, cluster, stages, 1, ctypes.byref(active)) == 0
        assert active.value == want if per_sm == 1 else active.value >= 2 * want, (cluster, per_sm, active.value)


def _conv_case(seed, shape, cout, beta_shift=0.0):
    rng = np.random.default_rng(seed)
    n, h, w, cin = shape
    x = torch.from_numpy((rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)).cuda().to(torch.bfloat16)
    gamma = torch.from_numpy(rng.standard_normal(cin).astype(np.float32)).cuda().to(torch.bfloat16)
    beta = torch.from_numpy(rng.standard_normal(cin).astype(np.float32) + beta_shift).cuda().to(torch.bfloat16)
    conv = torch.nn.Conv2d(cin, cout, 3, padding=1, device="cuda", dtype=torch.bfloat16)
    conv.weight.data = conv.weight.data.contiguous(memory_format=torch.channels_last)
    return x, gamma, beta, conv


CONV_CASES = [  # (shape, cout, groups): the JAX test's shapes, ragged widths, then main-path shapes
    ((2, 16, 16, 320), 320, 32), ((1, 8, 8, 64), 96, 8), ((1, 24, 16, 96), 64, 16), ((2, 5, 7, 32), 16, 8),
    ((1, 6, 96, 64), 72, 32), ((2, 64, 64, 320), 320, 32), ((2, 32, 32, 320), 640, 32),
    ((2, 32, 32, 640), 640, 32), ((2, 64, 64, 640), 320, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout,groups", CONV_CASES)
def test_cuda_gn_silu_conv3x3_matches_plain(shape, cout, groups):
    _card()
    x, gamma, beta, conv = _conv_case(sum(shape) + cout, shape, cout)
    fgc.reset_launch_counts()
    out = fgc.gn_silu_conv3x3(x, gamma, beta, conv, groups)
    torch.cuda.synchronize()
    assert fgc.LAUNCHES["gn_silu_conv3x3"] == 1 and out.dtype == torch.bfloat16
    assert out.shape == (*shape[:3], cout)
    ref = fgc.gn_silu_conv3x3_plain(x, gamma, beta, conv.weight, conv.bias, groups)
    assert _within_ulp(out, ref, 0.0, 1e-3) == 0


# K4's fp32 instance at ragged shapes: one image, W not a power of two, Cout
# not a multiple of 160, Cin a multiple of 8 but not of 32
CONV_F32_CASES = CONV_CASES + [((1, 10, 24, 40), 72, 8), ((1, 7, 37, 200), 168, 8), ((1, 33, 20, 72), 24, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout,groups", CONV_F32_CASES)
def test_cuda_gn_silu_conv3x3_f32_matches_plain(shape, cout, groups):
    """One weight pre-pass launch and one conv launch a call."""
    _card()
    x, gamma, beta, conv = _conv_case(sum(shape) + cout + 1, shape, cout)
    x, conv = x.float(), conv.float()
    conv.weight.data = conv.weight.data.contiguous(memory_format=torch.channels_last)
    fgc.reset_launch_counts()
    out = fgc.gn_silu_conv3x3(x, gamma, beta, conv, groups)
    torch.cuda.synchronize()
    assert fgc.LAUNCHES == {"gn_silu_conv3x3": 0, "gn_silu_conv3x3_f32": 1, "gn_conv_f32_split": 1}
    assert out.shape == (*shape[:3], cout)
    _close32(out, fgc.gn_silu_conv3x3_plain(x, gamma, beta, conv.weight, conv.bias, groups))


@pytest.mark.cuda
@pytest.mark.parametrize("cout,cin", [(320, 320), (640, 640), (24, 40)])
def test_cuda_gn_conv_f32_split_matches_plain(cout, cin):
    """The weight pre-pass writes weight_split_plain's bits."""
    _card()
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3)).astype(np.float32)).cuda().contiguous(
        memory_format=torch.channels_last)
    fgc.reset_launch_counts()
    out = fgc.weight_split(w)
    torch.cuda.synchronize()
    assert fgc.LAUNCHES["gn_conv_f32_split"] == 1
    assert torch.equal(out, fgc.weight_split_plain(w))


@pytest.mark.cuda
def test_cuda_gn_silu_conv3x3_is_deterministic():
    """Two calls on the same inputs give the same bits (the statistics fold
    in a fixed order; no atomics anywhere)."""
    _card()
    x, gamma, beta, conv = _conv_case(9, (2, 64, 64, 320), 320)
    first = fgc.gn_silu_conv3x3(x, gamma, beta, conv, 32)
    assert torch.equal(first, fgc.gn_silu_conv3x3(x, gamma, beta, conv, 32))


@pytest.mark.cuda
def test_cuda_from_random_runs_at_its_default_dtype():
    """StableDiffusionPipeline.from_random() with no dtype is fp32: on a
    tiny config its attention runs the fp32 kernel (UNet head dim 64, the
    VAE's 128-wide head), and the images match the plain-attention route."""
    _card()
    from faceposegenerator_tpu_torch.diffusion.sampler import SamplerModels
    from faceposegenerator_tpu_torch.models import clip_text, unet2d, vae
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    models = SamplerModels(
        text_cfg=clip_text.CLIPTextConfig(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
                                          intermediate_size=256),
        unet_cfg=unet2d.UNetConfig(block_out_channels=(64, 128, 128, 128), cross_attention_dim=64, head_dim=64),
        vae_cfg=vae.VAEConfig(block_out_channels=(128, 128, 128, 128)))
    pipe = StableDiffusionPipeline.from_random(seed=0, models=models)
    assert pipe.nets["unet"].conv_in.weight.dtype == torch.float32
    ids = torch.randint(0, 1000, (2, 77), generator=torch.Generator().manual_seed(0))
    fa.reset_launch_counts()
    img = pipe(input_ids=ids, num_inference_steps=2, height=64, width=64, seed=3)
    assert fa.LAUNCHES["flash_fwd_f32"] > 0 and fa.LAUNCHES["flash_fwd_d64"] == fa.LAUNCHES["flash_fwd_wide"] == 0
    assert img.shape == (2, 64, 64, 3) and np.isfinite(img).all()
    plain = StableDiffusionPipeline(pipe.nets, SamplerModels(models.text_cfg, models.unet_cfg, models.vae_cfg,
                                                             attn_impl="reference"))
    want = plain(input_ids=ids, num_inference_steps=2, height=64, width=64, seed=3)
    assert np.abs(img - want).max() <= 1e-3


@pytest.mark.cuda
def test_cuda_gn_silu_conv3x3_pads_after_the_activation():
    """With beta far from 0, SiLU(shift) at the border is far from 0: the
    kernel matches the plain version, and a variant that pads x before the
    activation misses it."""
    _card()
    x, gamma, beta, conv = _conv_case(5, (2, 16, 16, 64), 64, beta_shift=3.0)
    out = fgc.gn_silu_conv3x3(x, gamma, beta, conv, 8)
    ref = fgc.gn_silu_conv3x3_plain(x, gamma, beta, conv.weight, conv.bias, 8)
    assert _within_ulp(out, ref, 0.0, 1e-3) == 0
    scale, shift = fgc.group_scale_shift(x, gamma, beta, 8, 1e-5)
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    a = torch.nn.functional.silu(xp * scale[:, None, None] + shift[:, None, None]).to(x.dtype)
    pad_first = torch.nn.functional.conv2d(a.permute(0, 3, 1, 2).float(), conv.weight.float(),
                                           conv.bias.float()).permute(0, 2, 3, 1).to(x.dtype)
    assert _within_ulp(pad_first, ref, 0.0, 1e-3) > 0


@pytest.mark.cuda
def test_cuda_gn_kernels_reject_what_they_do_not_take():
    _card()
    x, gamma, beta, conv = _conv_case(6, (1, 8, 8, 64), 64)
    with pytest.raises(ValueError, match="bfloat16"):
        fgc.gn_silu_conv3x3(x.float(), gamma, beta, conv, 8)
    conv.weight.data = conv.weight.data.contiguous()
    with pytest.raises(ValueError, match="channels_last"):
        fgc.gn_silu_conv3x3(x, gamma, beta, conv, 8)
    with pytest.raises(ValueError):
        fg.fused_group_norm(x.half(), gamma, beta, 8)
    with pytest.raises(ValueError):
        fg.fused_group_norm(x[..., :60], gamma[:60], beta[:60], 6)


@pytest.mark.cuda
def test_cuda_gn_autograd_runs_the_kernels_forward_only():
    """With a gradient to take, K3 and K4 run forward once each and the
    backward recomputes in plain torch: the gradients match plain autograd."""
    _card()
    x, gamma, beta, conv = _conv_case(7, (2, 16, 16, 64), 64)
    x.requires_grad_()
    fg.reset_launch_counts()
    fgc.reset_launch_counts()
    y = fgc.gn_silu_conv3x3(fg.fused_group_norm(x, gamma, beta, 8, 1e-6, "silu"), gamma, beta, conv, 8)
    (gx,) = torch.autograd.grad(y.float().square().sum(), x)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["fused_group_norm"] == 1 and fgc.LAUNCHES["gn_silu_conv3x3"] == 1
    xr = x.detach().requires_grad_()
    yr = fgc.gn_silu_conv3x3_plain(fg.fused_group_norm_plain(xr, gamma, beta, 8, 1e-6, "silu"), gamma, beta,
                                   conv.weight, conv.bias, 8)
    (gr,) = torch.autograd.grad(yr.float().square().sum(), xr)
    cos = torch.nn.functional.cosine_similarity(gx.float().flatten(), gr.float().flatten(), dim=0)
    assert cos.item() >= 0.99


# per train step at any resolution: 16 UNet transformers × (self + cross)
# attention, the VAE's mid attention in the encode (forward only) and in the
# x̂0 decode, each backward pass once per forward with a gradient
STEP_LAUNCHES = {"flash_fwd_d64": 32, "flash_fwd_wide": 2, "flash_bwd_d64_dkv": 32, "flash_bwd_d64_dq": 32,
                 "flash_bwd_wide_dkv": 1, "flash_bwd_wide_dq": 1}


@pytest.fixture(scope="module")
def sd_train():
    """bf16 SD2.1-base-width nets from seeds with an ArcFace r18, and the bf16 policy."""
    _card()
    from faceposegenerator_tpu_torch.core.precision import Policy
    from faceposegenerator_tpu_torch.models import clip_text, iresnet, unet2d, vae
    from faceposegenerator_tpu_torch.training import idbooth

    models = idbooth.ModelBundle(arcface_cfg=iresnet.config_for("r18"))
    bf16 = torch.bfloat16
    frozen = {"text_encoder": clip_text.CLIPTextModel(models.text_cfg, dtype=bf16, seed=0),
              "unet": unet2d.UNet2DCondition(models.unet_cfg, dtype=bf16, seed=1),
              "vae": vae.AutoencoderKL(models.vae_cfg, dtype=bf16, seed=2),
              "arcface": iresnet.IResNet(models.arcface_cfg, dtype=bf16, seed=3)}
    return models, frozen, Policy(param_dtype=bf16, compute_dtype=bf16)


def _launched():
    return {n: c for n, c in fa.LAUNCHES.items() if c}


@pytest.mark.cuda
def test_cuda_run_identity_one_epoch(sd_train, tmp_path):
    """The driver for one epoch at 128² (2 instance + 2 class images, batch
    1 + prior): every step's launches, a checkpoint and the export."""
    from PIL import Image

    from faceposegenerator_tpu_torch.training import idbooth, idbooth_driver

    models, frozen, policy = sd_train
    rng = np.random.default_rng(0)
    for d in ("inst", "cls"):
        (tmp_path / d).mkdir()
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (128, 128, 3), np.uint8)).save(tmp_path / d / f"{i}.jpg")
    cfg = idbooth.IDBoothConfig(which_loss="triplet_prior", resolution=128, train_batch_size=1, num_train_epochs=1,
                                checkpointing_epochs=1)
    ids = np.arange(77, dtype=np.int32)
    fa.reset_launch_counts()
    trainable, history = idbooth_driver.run_identity(cfg, models, frozen, str(tmp_path / "inst"), str(tmp_path / "out"),
                                                     class_dir=str(tmp_path / "cls"), policy=policy,
                                                     instance_ids=ids, class_ids=ids)
    torch.cuda.synchronize()
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert _launched() == {n: 2 * c for n, c in STEP_LAUNCHES.items()}
    names = set((tmp_path / "out").iterdir())
    assert {tmp_path / "out" / "checkpoint-0-2", tmp_path / "out" / "pytorch_lora_weights.safetensors"} <= names
    assert max(float(b.detach().abs().max()) for b in idbooth.tree_leaves(trainable)[1::2]) > 0


@pytest.mark.cuda
def test_cuda_stacked_step_launches_like_one_step(sd_train):
    """Two identities of 2 + 2 rows at 128² in one stacked step launch a
    step's kernels once (8 rows), and each identity's loss is within 1e-2 of
    its serial loss on the same draws (bf16)."""
    from faceposegenerator_tpu_torch.diffusion.schedulers import make_ddpm
    from faceposegenerator_tpu_torch.training import idbooth, multi_identity

    models, frozen, policy = sd_train
    cfg = idbooth.IDBoothConfig(which_loss="triplet_prior", resolution=128, train_batch_size=2)
    g = torch.Generator(device="cuda").manual_seed(0)
    batches = [{"pixel_values": torch.rand(4, 128, 128, 3, generator=g, device="cuda") * 2 - 1,
                "input_ids": torch.randint(0, 49408, (4, 77), generator=g, device="cuda"),
                "gt_embeds": torch.randn(4, 512, generator=g, device="cuda")} for _ in range(2)]
    draws = [idbooth.draw((4, 16, 16, 4), 4, 1000, g, "cuda") for _ in range(2)]
    loras = [idbooth.init_trainable(4, cfg, models, frozen["unet"]) for _ in range(2)]
    serial = [float(idbooth.make_loss_fn(cfg, models, make_ddpm(), policy)(loras[k], frozen, batches[k],
                                                                           draws=draws[k])[0].detach())
              for k in range(2)]
    opt = idbooth.make_optimizer(cfg, 10)
    trainables = multi_identity.stack_pytrees(loras)
    states = opt.init(trainables)
    step = multi_identity.make_multi_train_step(cfg, models, opt, 2, policy=policy)
    fa.reset_launch_counts()
    trainables, states, metrics = step(trainables, states, frozen,
                                       {k: torch.stack([b[k] for b in batches]) for k in batches[0]}, draws=draws)
    torch.cuda.synchronize()
    assert _launched() == STEP_LAUNCHES
    assert metrics["loss"].shape == (2,) and states["count"] == 1
    for k in range(2):
        assert abs(float(metrics["loss"][k]) - serial[k]) <= 1e-2 * abs(serial[k])


def _fr_tree_err(a, b):
    from faceposegenerator_tpu_torch.core.tree import tree_paths

    want = dict(tree_paths(b))
    scale = max(float(np.abs(v).max()) for v in want.values())
    return max(float(np.abs(v - want[p]).max()) for p, v in tree_paths(a)) / scale


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["AdaFace", "ElasticCosFace"])
def test_cuda_fr_step_matches_the_cpu(head):
    """Two FR steps of IResNet (1, 1, 1, 1) at 16² (fc_scale 1), fp32 with
    TF32 off, on the card against the same steps on the CPU from the same
    weights and draws: the loss within 1e-4 relative, the params within 1e-4
    and the BN statistics (and AdaFace's EMA) within 1e-5 of their tree's max
    abs; no kernel of the port launched."""
    _card()
    from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
    from faceposegenerator_tpu_torch.training import fr

    cfg = fr.FRConfig(loss=head, batch_size=8, num_classes=10)
    bcfg = fr.backbone_config(cfg, depths=(1, 1, 1, 1), fc_scale=1)
    g = torch.Generator().manual_seed(0)
    batch = {"images": torch.rand(8, 16, 16, 3, generator=g) * 2 - 1, "labels": torch.randint(0, 10, (8,), generator=g)}
    draws = [{"dropout": torch.rand(8, 512, generator=g) < 0.6, "margin": torch.randn(8, generator=g)} for _ in range(2)]
    cpu = fr.init_train_state(cfg, 0, "cpu", bcfg)
    card = fr.init_train_state(cfg, 0, "cuda", bcfg)
    card[0]["backbone"].load_state_dict(cpu[0]["backbone"].state_dict())
    with torch.no_grad():
        card[0]["kernel"].copy_(cpu[0]["kernel"])
    fa.reset_launch_counts()
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    results = []
    for params, state in (cpu, card):
        opt = fr.make_optimizer(cfg)
        opt_state, step = opt.init(params), fr.make_train_step(cfg, opt, PARITY_POLICY)
        losses = []
        for d in draws:
            params, state, opt_state, m = step(params, state, opt_state, batch, draws=d)
            losses.append(float(m["loss"]))
        results.append((losses, fr.fr_checkpoint_tree(params, state)))
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    (cpu_losses, cpu_tree), (card_losses, card_tree) = results
    assert all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(card_losses, cpu_losses)), (card_losses, cpu_losses)
    assert _fr_tree_err(card_tree["params"], cpu_tree["params"]) <= 1e-4
    assert _fr_tree_err(card_tree["state"], cpu_tree["state"]) <= 1e-5
    assert all(n == 0 for n in fa.LAUNCHES.values())


@pytest.mark.cuda
def test_cuda_mtcnn_detects_like_the_cpu():
    """The bright-square cascade on graded squares: the card's detections
    (fp32, TF32 off) equal the CPU's in count, boxes and landmarks within
    0.5 px, probabilities within 1e-4."""
    _card()
    from faceposegenerator_tpu_torch.models import mtcnn

    rng = np.random.default_rng(1)
    imgs = np.zeros((4, 96, 96, 3), np.float32)
    for b, (y0, x0, s) in enumerate(((24, 24, 48), (8, 40, 48), (30, 10, 56))):
        yy, xx = np.mgrid[0:s, 0:s]
        imgs[b, y0 : y0 + s, x0 : x0 + s] = (246 + 9 * (yy + 2 * xx) / (3 * (s - 1)))[..., None]
    imgs[3] = rng.uniform(0, 60, (96, 96, 3))
    params = mtcnn.brightness_cascade_params()
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        got = mtcnn.MTCNN(params, min_face_size=40).detect_batch(imgs, landmarks=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    want = mtcnn.MTCNN(params, min_face_size=40, device="cpu").detect_batch(imgs, landmarks=True)
    for b in range(4):
        assert (got[0][b] is None) == (want[0][b] is None), b
        if want[0][b] is not None:
            assert got[0][b].shape == want[0][b].shape
            assert np.abs(got[0][b] - want[0][b]).max() <= 0.5 and np.abs(got[2][b] - want[2][b]).max() <= 0.5
            assert np.abs(got[1][b] - want[1][b]).max() <= 1e-4


@pytest.mark.cuda
def test_cuda_vit_encoder_runs_k1_and_gradcam_k5():
    """A two-layer DINOv2 (head dim 64) at 224², 257 tokens: bf16 features
    with exactly one K1 launch a layer; fp32 (TF32 off) within 1e-4 of the
    CPU port's max abs; a GradCAM probe launching K1 twice (the last layer
    with the log-sum-exp, counted apart) and K5 once, its map finite and in
    [0, 1]."""
    _card()
    from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
    from faceposegenerator_tpu_torch.evaluation.heatmaps import GradCAM, make_dinov2_gradcam_encoder
    from faceposegenerator_tpu_torch.models import dinov2

    cfg = dinov2.DINOv2Config(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256)
    cpu = dinov2.DINOv2(cfg, device="cpu", seed=3)
    model = dinov2.DINOv2(cfg, seed=3)
    model.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 224, 224, 3)).astype(np.float32))
    fa.reset_launch_counts()
    with torch.no_grad():
        feats = model.cls_feature(x.cuda())
    torch.cuda.synchronize()
    assert feats.shape == (2, 128) and torch.isfinite(feats).all()
    assert {k: v for k, v in fa.LAUNCHES.items() if v} == {"flash_fwd_d64": 2}
    assert not any(fa.LSE_LAUNCHES.values())
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            got = model.cls_feature(x.cuda(), PARITY_POLICY).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    want = cpu.cls_feature(x, PARITY_POLICY)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    rng = np.random.default_rng(6)
    cam = GradCAM(make_dinov2_gradcam_encoder(model), rng.standard_normal((300, 128)), rng.standard_normal((300, 128)))
    fa.reset_launch_counts()
    heat, delta = cam.get_map(x[:1].numpy(), 0)
    assert {k: v for k, v in fa.LAUNCHES.items() if v} == {"flash_fwd_d64": 2, "flash_bwd_d64_dkv": 1,
                                                           "flash_bwd_d64_dq": 1}
    assert {k: v for k, v in fa.LSE_LAUNCHES.items() if v} == {"flash_fwd_d64": 1}  # the tapped layer
    assert heat.shape == (16, 16) and np.isfinite(heat).all() and 0.0 <= heat.min() and heat.max() <= 1.0
    assert np.isfinite(delta)
