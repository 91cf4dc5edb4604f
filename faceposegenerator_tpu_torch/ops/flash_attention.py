"""Flash-attention forward kernels for the card, their launch counts and
their plain PyTorch version (port of `faceposegenerator_tpu/ops/
flash_attention.py:1084`, `flash_attention`).

Two CUDA kernels in `csrc/flash_fwd.cu` replace the two Pallas kernels of the
sampling path:

  `flash_fwd_d64`   K1, `_fwd_kernel_packed` (flash_attention.py:258): every
                    UNet attention, head dim 64;
  `flash_fwd_wide`  K2, `_fwd_kernel` (flash_attention.py:104): head dim
                    % 128 == 0, the VAE's one 512-dim head.

Both take (B, S, H, D) bf16 tensors whose head dim is contiguous; other
strides are passed to the kernel, so the q/k/v views split out of a fused
projection need no copy. A CPU tensor goes to `attention_plain`; a CUDA
tensor goes to its kernel or raises. Each wrapper adds one to
`LAUNCHES[name]` where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

LAUNCHES = {"flash_fwd_d64": 0, "flash_fwd_wide": 0}
_WIDE_DIMS = (128, 256, 384, 512)
_INT32_MAX = 2**31 - 1
_fns: dict = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, kv_len: Optional[int] = None
) -> torch.Tensor:
    """The kernels' function in plain PyTorch (`ops/attention.py:23-39` of
    the JAX package): fp32 logits and softmax, keys >= kv_len masked to
    -inf, weights rounded to q's dtype before P·V, fp32 accumulation."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_len is not None and kv_len < k.shape[1]:
        logits[..., kv_len:] = float("-inf")
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(q.dtype)


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("flash_fwd"), name)
        n_ints = 4 + (name == "flash_fwd_wide") + 12
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_ints + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, q, k, v, scale: float, kv_len: Optional[int]) -> torch.Tensor:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, S, H, D) tensors")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if k.shape != (b, skv, h, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("q, k and v must lie on one CUDA device")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} takes bf16 tensors, got {t.dtype}")
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name} needs a contiguous head dim and 16-byte aligned rows")
        if max(t.stride()) > _INT32_MAX:
            raise ValueError(f"{name}: strides exceed int32")
    kv_end = skv if kv_len is None else min(skv, int(kv_len))
    if kv_end < 1 or sq < 1:
        raise ValueError("flash attention needs at least one query and one key")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3]]
    head = [b, h, sq, kv_end] + ([d] if name == "flash_fwd_wide" else [])
    err = _fn(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *head, *strides,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return o


def flash_fwd_d64(q, k, v, scale: float, kv_len: Optional[int] = None) -> torch.Tensor:
    """K1: attention at head dim 64 over (B, S, H, 64)."""
    if not q.is_cuda:
        return attention_plain(q, k, v, scale, kv_len)
    if q.shape[-1] != 64:
        raise ValueError(f"flash_fwd_d64 takes head dim 64, got {q.shape[-1]}")
    return _launch("flash_fwd_d64", q, k, v, scale, kv_len)


def flash_fwd_wide(q, k, v, scale: float, kv_len: Optional[int] = None) -> torch.Tensor:
    """K2: attention at head dim 128, 256, 384 or 512 over (B, S, H, D)."""
    if not q.is_cuda:
        return attention_plain(q, k, v, scale, kv_len)
    if q.shape[-1] not in _WIDE_DIMS:
        raise ValueError(f"flash_fwd_wide takes head dim in {_WIDE_DIMS}, got {q.shape[-1]}")
    return _launch("flash_fwd_wide", q, k, v, scale, kv_len)
