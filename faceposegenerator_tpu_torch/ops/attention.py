"""Scaled dot-product attention in (B, S, H, D) layout (port of
`faceposegenerator_tpu/ops/attention.py:23-75`).

`impl="reference"` is the plain einsum with fp32 softmax (differentiated by
autograd). `"auto"` and `"flash"` send CUDA tensors to hand-written kernels
(head dim 64 → K1, head dim % 128 == 0 → K2) and raise for shapes or dtypes
no kernel takes. When a gradient is being taken through q, k or v they go
through `FlashAttention` instead: K1/K2 with the log-sum-exp forward, K5/K6
backward. CPU tensors take the plain versions either way.

`impl="flash_int8"` is the JAX `attn=flash_int8` mode (`attention.py:62-68`,
inference only): head dim 64 goes to the int8 kernel K8, and any other head
dim to the exact kernels, as `flash_attention_int8` does in JAX
(flash_attention.py:1284-1288): on the main path that is the VAE's one
512-dim head on K2.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import FlashAttention, attention_plain, flash_attention_int8, flash_fwd_d64, flash_fwd_wide


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
    if q.is_cuda and d != 64 and d % 128:
        raise ValueError(f"no attention kernel takes head dim {d}; use impl='reference'")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale, kv_len)
    if d == 64:
        return flash_fwd_d64(q, k, v, scale, kv_len)
    return flash_fwd_wide(q, k, v, scale, kv_len)
