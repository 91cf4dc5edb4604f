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
kernel quantizes any x and writes x's dtype) or raises. Up to K = 1280 and
from 2048 rows the kernel quantizes x itself, once per 128-row block; else
(`is_wide`) the `qdense_quant` launch writes the codes and row scales first
(`quantize`'s codes and scale, in int8). In the UNet at 512², per full pass:
the GEGLU outputs at 640 and 1280 channels (K 2560, 5120), every
cross-attention k/v projection (1232 rows of text states under CFG) and
the mid block's ten (1024 rows): 50 of 160 calls; the DeepCache partial
passes' level-0 k/v projections, 10 of 50. The wrapper adds one to
`LAUNCHES[name]` where it launches kernel `name`, and nowhere else, and
where it launches the GEMM, 2·M·N·K FLOPs to `core.flops.count_kernel`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..core.compile import register_counters
from ..core.flops import count_kernel
from . import _build

LAUNCHES = register_counters({"qdense": 0, "qdense_f32": 0, "qdense_quant": 0})
_EPS = 1e-8
FUSED_MAX_K = 1280  # csrc/qdense.cu: the widest K whose 128-row codes the GEMM keeps in shared memory
FUSED_MIN_M = 2048  # below 16 row blocks the fused quantize (a serial phase of each CTA) runs on few SMs
_BM, _BN = 128, 128  # its row block and column tile
_fns: dict = {}
_sms: dict = {}


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


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {  # the C signatures in csrc/qdense.cu
    "qdense": [_P] * 6 + [_I] * 3 + [ctypes.c_float, _I, _I, _P],
    "qdense_f32": [_P] * 6 + [_I] * 3 + [ctypes.c_float, _I, _I, _P],
    "qdense_quant": [_P] * 3 + [_I] * 2 + [ctypes.c_float, _I, _I, _P],
}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = _build.kernel(name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _call(name: str, *args) -> None:
    err = _kernel(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def is_wide(m: int, k: int) -> bool:
    """Whether an (m, k) x takes the wide instance (`qdense_quant`, then
    the GEMM with its codes by TMA)."""
    return k > FUSED_MAX_K or m < FUSED_MIN_M


@functools.lru_cache(maxsize=None)
def run_length(m: int, n: int, k: int, sms: int) -> int:
    """N tiles a CTA sweeps (one CTA an SM): the split of each row block's
    tiles into runs that gives the least time on the busiest SM, waves ×
    (run length + the quantize of the block, K/128 tile times: it reads
    2·128·K bytes where a tile writes 2·128·128), the fewest runs among
    equals; one in the wide instance, which streams its codes per tile."""
    n_tiles, m_blocks = -(-n // _BN), -(-m // _BM)
    if is_wide(m, k):
        return 1

    def cost(r):
        return -(-m_blocks * r // sms) * (-(-n_tiles // r) + k / 128), r

    return -(-n_tiles // min(range(1, n_tiles + 1), key=cost))


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def quantize_rows(x: torch.Tensor, a: Optional[float] = None):
    """What `qdense_quant` writes for x (M, K): int8 codes (M, K) and, for
    the dynamic mode, the row scales (M,) fp32 (None for the static mode).
    A CPU tensor takes `quantize`; a CUDA one, the launch."""
    M, K = x.shape
    if not x.is_cuda:
        codes, sx = quantize(x, -1, a)
        return codes.to(torch.int8), (sx.reshape(M) if a is None else None)
    codes = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x.device) if a is None else None
    if M:
        _call("qdense_quant", x.data_ptr(), codes.data_ptr(), None if sx is None else sx.data_ptr(), M, K,
              0.0 if a is None else float(a), int(a is None), int(x.dtype == torch.float32),
              torch.cuda.current_stream(x.device).cuda_stream)
    return codes, sx


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
    if M:
        codes, sx = quantize_rows(xm, a) if is_wide(M, K) else (None, None)
        _call(name, xm.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
              None if codes is None else codes.data_ptr(), None if sx is None else sx.data_ptr(), M, N, K,
              0.0 if a is None else float(a), run_length(M, N, K, _sm_count(x.device)), int(a is None),
              torch.cuda.current_stream(x.device).cuda_stream)
        count_kernel(name, 2.0 * M * N * K)
    return y.reshape(*lead, N)
