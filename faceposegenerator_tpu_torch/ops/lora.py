"""LoRA projection ops (port of `faceposegenerator_tpu/ops/lora.py:23-78`).

LoRA stays factored: y = x·Wᵀ + b + scale·(x·Aᵀ)·Bᵀ with A: (r, in) and
B: (out, r), one adapter shared by the whole batch. Per-sample adapters
(B, r, in) wait for the serving slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .quant import is_quantized, qdense


def lora_delta(x: torch.Tensor, lora_a: torch.Tensor, lora_b: torch.Tensor) -> torch.Tensor:
    """Unscaled (x·Aᵀ)·Bᵀ in x's dtype (fp32 accumulation inside each matmul)."""
    return F.linear(F.linear(x, lora_a.to(x.dtype)), lora_b.to(x.dtype))


def lora_dense(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    lora_a: Optional[torch.Tensor] = None,
    lora_b: Optional[torch.Tensor] = None,
    scale: float = 1.0,
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
            y.add_(lora_delta(x, lora_a, lora_b), alpha=scale)
        return y if b is None else y.add_(b.to(x.dtype))
    y = F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))
    if lora_a is not None and lora_b is not None:
        y.add_(lora_delta(x, lora_a, lora_b), alpha=scale)
    return y
