"""The CUDA kernels of the port against their plain PyTorch version, on a card.

These tests carry the `cuda` marker and skip without a card; run them on one
with `python -m pytest tests/test_torch_kernels_cuda.py -m cuda`. This file
imports no JAX, so it runs where only the port's dependencies are installed.

Limits: outputs within 2e-2 max and 2e-3 mean absolute error of the fp32
plain version on the same bf16 inputs, gradients within 2e-2 and 2e-3 of
their max abs (a key's dk and dv sum over every query, so they grow with
Sq/Skv); the log-sum-exp within 1e-3.
"""

import numpy as np
import pytest
import torch

from faceposegenerator_tpu_torch.ops import flash_attention as fa
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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,sq,skv,h,d,kv_len",
    [(2, 200, 200, 5, 64, None), (2, 130, 77, 3, 64, None), (1, 64, 128, 2, 64, 77),
     (2, 100, 100, 1, 512, None), (1, 64, 96, 2, 128, 50)],
)
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
    _card()
    q = torch.zeros(1, 8, 2, 64, device="cuda")  # fp32: no kernel takes it
    with pytest.raises(ValueError):
        dot_product_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 96, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        dot_product_attention(q, q, q)


BWD_CASES = [  # (b, sq, skv, h, d, kv_len): small and ragged, then a train shape of each kernel
    (2, 200, 200, 5, 64, None), (1, 130, 128, 2, 64, 77), (2, 64, 77, 3, 64, None),
    (8, 1024, 1024, 10, 64, None), (8, 4096, 77, 5, 64, None),
    (1, 100, 100, 1, 512, None), (1, 64, 96, 2, 128, 50), (4, 4096, 4096, 1, 512, None),
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
    assert fa.LAUNCHES == {"flash_fwd_d64": 1, "flash_fwd_wide": 0, "flash_bwd_d64_dkv": 1,
                           "flash_bwd_d64_dq": 1, "flash_bwd_wide_dkv": 0, "flash_bwd_wide_dq": 0}
    ref_in = qkv.detach().float().requires_grad_()
    rq, rk, rv = ref_in.unbind(2)
    fa.attention_plain(rq, rk, rv, 0.125).square().sum().backward()
    assert torch.isfinite(qkv.grad).all()
    cos = torch.nn.functional.cosine_similarity(qkv.grad.float().flatten(), ref_in.grad.flatten(), dim=0)
    assert cos.item() >= 0.99
