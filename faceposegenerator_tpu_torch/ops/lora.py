"""LoRA projection ops (port of `faceposegenerator_tpu/ops/lora.py:23-78`).

LoRA stays factored: y = x·Wᵀ + b + scale·(x·Aᵀ)·Bᵀ with A: (r, in) and
B: (out, r), one adapter shared by the batch; or per-sample adapters, A:
(B, r, in) and B: (B, out, r), where slot b of x rides adapter b, with a
scale that is a number or a (B,) tensor.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from .quant import is_quantized, qdense

Scale = Union[float, torch.Tensor]


def broadcast_scale(scale: Scale, ndim: int) -> Scale:
    """A per-sample scale (B,) shaped to broadcast against a (B, ..., out)
    delta; numbers pass through."""
    if isinstance(scale, torch.Tensor) and scale.dim() == 1:
        return scale.reshape((-1,) + (1,) * (ndim - 1))
    return scale


def lora_delta(x: torch.Tensor, lora_a: torch.Tensor, lora_b: torch.Tensor) -> torch.Tensor:
    """Unscaled (x·Aᵀ)·Bᵀ in x's dtype (fp32 accumulation inside each
    matmul). With per-sample adapters x's leading dim is B: two batched
    rank-r products."""
    if lora_a.dim() == 3:
        xb = x.reshape(x.shape[0], -1, x.shape[-1])
        h = torch.bmm(xb, lora_a.to(x.dtype).transpose(1, 2))
        d = torch.bmm(h, lora_b.to(x.dtype).transpose(1, 2))
        return d.reshape(*x.shape[:-1], d.shape[-1])
    return F.linear(F.linear(x, lora_a.to(x.dtype)), lora_b.to(x.dtype))


def add_delta(y: torch.Tensor, delta: torch.Tensor, scale: Scale, inplace: bool) -> torch.Tensor:
    """y + scale·delta, in place on y if `inplace`. A number rides `alpha`
    (one rounding); a tensor scale multiplies the delta first."""
    if isinstance(scale, torch.Tensor):
        delta = delta * broadcast_scale(scale.to(delta.dtype), delta.dim())
        return y.add_(delta) if inplace else y + delta
    return y.add_(delta, alpha=scale) if inplace else torch.add(y, delta, alpha=scale)


def lora_dense(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    lora_a: Optional[torch.Tensor] = None,
    lora_b: Optional[torch.Tensor] = None,
    scale: Scale = 1.0,
) -> torch.Tensor:
    """Dense layer, w: (out, in) torch-Linear orientation, with an optional
    factored LoRA delta. The bias rides the matmul's epilogue; the delta is
    added in place, so the layer costs one pass over its output.

    `w` may be a `QuantizedWeight` (ops/quant.py): then the base product is
    `qdense` (kernel K7 on the card), the delta on the unquantized x is added
    to it, and the bias after that, all in x's dtype (lora.py:66-78)."""
    if is_quantized(w):
        y = qdense(x, w)
        if lora_a is not None and lora_b is not None:
            add_delta(y, lora_delta(x, lora_a, lora_b), scale, inplace=True)
        return y if b is None else y.add_(b.to(x.dtype))
    y = F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))
    if lora_a is not None and lora_b is not None:
        add_delta(y, lora_delta(x, lora_a, lora_b), scale, inplace=True)
    return y
