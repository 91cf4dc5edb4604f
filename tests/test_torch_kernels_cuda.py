"""The CUDA kernels of the port against their plain PyTorch version, on a card.

These tests carry the `cuda` marker and skip without a card; run them on one
with `python -m pytest tests/test_torch_kernels_cuda.py -m cuda`. This file
imports no JAX, so it runs where only the port's dependencies are installed.
"""

import numpy as np
import pytest
import torch

from faceposegenerator_tpu_torch.ops import flash_attention as fa
from faceposegenerator_tpu_torch.ops.attention import dot_product_attention


def _qkv(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d)))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,sq,skv,h,d,kv_len",
    [(2, 200, 200, 5, 64, None), (2, 130, 77, 3, 64, None), (1, 64, 128, 2, 64, 77),
     (2, 100, 100, 1, 512, None), (1, 64, 96, 2, 128, 50)],
)
def test_cuda_kernels_match_plain(b, sq, skv, h, d, kv_len):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in _qkv(7, b, sq, skv, h, d))
    fa.reset_launch_counts()
    out = dot_product_attention(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    name = "flash_fwd_d64" if d == 64 else "flash_fwd_wide"
    assert fa.LAUNCHES[name] == 1
    ref = fa.attention_plain(q.float(), k.float(), v.float(), d**-0.5, kv_len)
    err = (out.float() - ref).abs()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3


@pytest.mark.cuda
def test_cuda_rejects_what_no_kernel_takes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q = torch.zeros(1, 8, 2, 64, device="cuda")  # fp32: no kernel takes it
    with pytest.raises(ValueError):
        dot_product_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 96, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        dot_product_attention(q, q, q)
