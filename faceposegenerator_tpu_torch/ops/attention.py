"""Scaled dot-product attention in (B, S, H, D) layout (port of
`faceposegenerator_tpu/ops/attention.py:23-75`).

`impl="reference"` is the plain einsum with fp32 softmax (differentiated by
autograd). `"auto"` and `"flash"` send CUDA tensors to hand-written kernels,
chosen by `flash_attention.kernel_for` from the dtype and head dim before any
launch: bf16 at head dim 64 → K1, bf16 at head dim % 128 == 0 → K2, fp32 at
either → their fp32 instance. What JAX's `flash_supported` refuses (another
dtype, another head dim) goes to the plain einsum under `"auto"`, as
`attention.py:72-75` sends it to its einsum, and raises under `"flash"`.
When a gradient is being taken through q, k or v the kernels' inputs go
through `FlashAttention` instead: the forward with the log-sum-exp, then
K5/K6 (or their fp32 instance) backward. CPU tensors take the plain versions
either way.

`impl="flash_int8"` is the JAX `attn=flash_int8` mode (`attention.py:62-68`,
inference only): head dim 64 goes to the int8 kernel K8, and any other head
dim to the exact kernels, as `flash_attention_int8` does in JAX
(flash_attention.py:1284-1288): on the main path that is the VAE's one
512-dim head on K2.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import FlashAttention, attention_plain, flash_attention_int8, flash_fwd, kernel_for


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Non-causal multi-head attention; q: (B, Sq, H, D), k/v: (B, Skv, H, D).
    `kv_len` excludes keys at positions >= kv_len."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "reference":
        return attention_plain(q, k, v, scale, kv_len)
    if impl not in ("auto", "flash", "flash_int8"):
        raise ValueError(f"unknown attention impl {impl!r}")
    d = q.shape[-1]
    if impl == "flash_int8" and d == 64:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            raise ValueError("flash_int8 attention is inference only")
        return flash_attention_int8(q, k, v, scale, kv_len)
    if q.is_cuda and kernel_for(q.dtype, d) is None:
        if impl == "auto":
            return attention_plain(q, k, v, scale, kv_len)
        raise ValueError(f"no attention kernel takes {q.dtype} at head dim {d}; use impl='auto' or 'reference'")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale, kv_len)
    return flash_fwd(q, k, v, scale, kv_len)
