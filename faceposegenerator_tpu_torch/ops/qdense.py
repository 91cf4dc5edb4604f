"""K7: the fused-quantize int8 dense for the card, its launch count and its
plain PyTorch version (port of `faceposegenerator_tpu/ops/quant_pallas.py:47`,
`_qdense_kernel`, and of the static branch of `quant._qdense_impl`,
quant.py:148-153).

    y = (round(x / sx) · qᵀ) · sx · s     dynamic: sx = max(rowmax|x|, 1e-8) · fl(1/127)
    y = (round(x / a) · qᵀ) · (a · s)     static: one calibrated per-tensor scale a

with q int8 (N, K), s fp32 (N,), int32 accumulation, round half to even,
codes clipped to ±127 and the result rounded once to x's dtype.
`qdense_kernel` takes (..., K) and flattens the leading dimensions. A CPU
tensor goes to `qdense_plain`; a CUDA tensor goes to the kernel
(csrc/qdense.cu: `qdense` for bf16 x, `qdense_f32` for fp32 x, as JAX's
kernel quantizes any x and writes x's dtype) or raises. The wrapper adds one
to `LAUNCHES[name]` where it launches kernel `name`, and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build

LAUNCHES = {"qdense": 0, "qdense_f32": 0}
_EPS = 1e-8
_fns: dict = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# Under jit, XLA rewrites x / 127.0 as x · fl(1/127) (its algebraic
# simplifier inverts a constant divisor), so every activation scale of the
# JAX sampling program is amax · INV127; this is that product, on the CPU and
# the card alike. (Weights are quantized outside jit, by a true division.)
INV127 = float(np.float32(1.0) / np.float32(127.0))


def quantize(x: torch.Tensor, axes=None, a: Optional[float] = None):
    """Symmetric int8 codes of x, as integer-valued fp32 in a new contiguous
    tensor, and their scale: the static `a`, or max(amax|x|, 1e-8)·fl(1/127)
    over `axes` (keepdim; every axis when None). Round half to even of a true
    division, clipped to ±127 (quant.py:119-131)."""
    xf = x.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    if a is None:
        amax = xf.abs().amax() if axes is None else xf.abs().amax(dim=axes, keepdim=True)
        sx = amax.clamp_min(_EPS) * INV127
    else:  # a tensor divisor: CUDA divides by a Python scalar through its reciprocal
        sx = xf.new_full((), a)
    return xf.div_(sx).round_().clamp_(-127, 127), sx


def qdense_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, a: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch. The integer product runs in
    float64, which holds every int32 sum of int8 codes exactly; the rescale
    is fp32 in the JAX package's order."""
    codes, sx = quantize(x, -1, a)
    acc = (codes.double() @ q.double().t()).float()
    y = acc * (sx * s) if a is not None else acc * sx * s
    return y.to(x.dtype)


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = _build.kernel(name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def qdense_kernel(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, a: Optional[float] = None) -> torch.Tensor:
    """x (..., K) · int8 q (N, K)ᵀ with the dynamic (`a` None) or static
    activation quantize; returns (..., N) in x's dtype."""
    if not x.is_cuda:
        return qdense_plain(x, q, s, a)
    K, N = x.shape[-1], q.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"qdense takes bf16 or fp32 activations on the card, got {x.dtype}")
    name = "qdense_f32" if x.dtype == torch.float32 else "qdense"
    if q.dtype != torch.int8 or q.shape != (N, K) or not q.is_contiguous():
        raise ValueError(f"qdense takes a contiguous int8 (N, K) weight, got {q.dtype} {tuple(q.shape)}")
    if s.dtype != torch.float32 or s.shape != (N,) or not s.is_contiguous():
        raise ValueError("qdense takes a contiguous fp32 (N,) weight scale")
    if not (x.is_cuda and q.device == x.device and s.device == x.device):
        raise ValueError("qdense: every tensor must lie on one CUDA device")
    if K % 32 or N % 8:
        raise ValueError(f"qdense takes K % 32 == 0 and N % 8 == 0, got K={K} N={N}")
    lead = x.shape[:-1]
    xm = x.reshape(-1, K)
    if not xm.is_contiguous() or xm.data_ptr() % 16:
        xm = xm.contiguous()
    M = xm.shape[0]
    if M * max(K, N) > 2**31 - 1:
        raise ValueError("qdense: the operands exceed int32 indexing")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x.device) if a is None else None
    if M:
        err = _kernel(name)(xm.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                        None if sx is None else sx.data_ptr(), M, N, K,
                        0.0 if a is None else float(a), torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        LAUNCHES[name] += 1
    return y.reshape(*lead, N)
