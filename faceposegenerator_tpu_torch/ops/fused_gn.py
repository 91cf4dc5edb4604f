"""K3: GroupNorm(+SiLU) over channels-last tensors for the card, its launch
count, its plain PyTorch version and the autograd Function that joins them
(port of `faceposegenerator_tpu/ops/fused_gn.py`: `_gn_slab_kernel` :76,
via `_gn_slab_call` :132 and `fused_group_norm` :173).

    y = act(x·scale + shift),  scale = γ·rsqrt(var + eps),  shift = β − mean·scale

with mean and var = E[x²] − mean² per (image, group), from fp32 per-channel
sums and sums of squares folded over each group's channels; act is None or
SiLU; y is rounded once to x's dtype. `GN_IMPL=pallas` (read at import, as
in JAX; `gn_impl()`) makes `ops.norms.group_norm` send every shape that
`slab_supported` accepts here. A CPU tensor goes to `fused_group_norm_plain`;
a CUDA tensor goes to the kernel (csrc/fused_gn.cu) or raises. The kernel is
one launch of one thread-block cluster per image; `cluster_plan` sizes it
(the cluster, each CTA's rows and the depth of its ring of chunks).
The wrapper checks the operands, allocates y (nothing else) and makes the
one C call; it adds one to `LAUNCHES["fused_group_norm"]` where it launches
the kernel, and nowhere else.

When a gradient is taken through x, gamma or beta, `FusedGroupNorm` runs the
kernel forward and recomputes the backward with autograd through
`fused_group_norm_plain`, which never dispatches (the JAX backward,
`_fused_gn_bwd` :189-197, recomputes through the dispatching
`norms.group_norm`, which under GN_IMPL=pallas on a TPU would send an
eligible shape back into `fused_group_norm`).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.compile import register_counters, register_route
from . import _build

_GN_IMPL = os.environ.get("GN_IMPL", "xla")  # xla | pallas
_MAX_SLAB_ELEMS = int(os.environ.get("GN_MAX_SLAB_ELEMS", str(64 * 64 * 640)))
_CHUNK_ROWS = 512
# the statistics kernels give each of their 256 threads 16 bytes of a row
_THREADS = 256
# K3's cluster (csrc/fused_gn.cu): shared memory a CTA may use on the card
# (227 KB) and an SM's (228 KB, less 1 KB the hardware keeps per CTA), the
# largest (non-portable) cluster, the bytes of a bulk-copied chunk, and the
# CTAs that keep the card's 132 SMs busy
SMEM_MAX, SM_SMEM, MAX_CLUSTER, CHUNK_BYTES, _FILL_CTAS = 232448, 233472, 16, 16384, 128
# K3's consumer threads (8 warps, as the statistics kernels'), 16 bytes of a row each; one more warp produces
CONSUMERS = _THREADS
# clusters of each size that an H100 SXM runs at once for each CTA an SM it
# holds (its GPCs hold 16-18 SMs); the card's own count
# (`fused_group_norm_clusters`, cudaOccupancyMaxActiveClusters) is held to
# this table by tests/test_torch_kernels_cuda.py and printed by chip_smoke.py
_WAVE_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
_DTYPES = (torch.bfloat16, torch.float32)
LAUNCHES = register_counters({"fused_group_norm": 0})
register_route(lambda: (_GN_IMPL, _MAX_SLAB_ELEMS))  # which GroupNorms go to K3
_fn = None


def gn_impl() -> str:
    return _GN_IMPL


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def slab_supported(n: int, s: int, c: int, num_groups: int) -> bool:
    """Whether the single-read slab kernel serves this (N, S, C) GN. The
    JAX predicate (fused_gn.py:59-73) copied as it is, so that both packages
    route the same ops: its limits are the TPU's VMEM budget."""
    if c % num_groups or s % 8:
        return False
    if c > 640:
        return False
    rows = min(s, _CHUNK_ROWS)
    if s % rows:
        return False
    return s * c <= _MAX_SLAB_ELEMS


def group_scale_shift(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, num_groups: int,
                      eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(image, channel) fp32 scale and shift with normalize(x)·γ + β =
    x·scale + shift, in the kernels' order: per-channel sums and sums of
    squares over the spatial axes, folded over each group's channels, times
    1/(C/G·S); var = E[x²] − mean²."""
    n, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    x32 = x.reshape(n, -1, c).float()
    inv_count = 1.0 / (cg * x32.shape[1])
    mean = x32.sum(1).reshape(n, num_groups, cg).sum(2) * inv_count
    sq = x32.square().sum(1).reshape(n, num_groups, cg).sum(2) * inv_count
    inv = torch.rsqrt(sq - mean.square() + eps)
    scale = inv.repeat_interleave(cg, 1) * gamma.float()
    shift = beta.float() - mean.repeat_interleave(cg, 1) * scale
    return scale, shift


def fused_group_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, num_groups: int = 32,
                           eps: float = 1e-6, act: Optional[str] = None) -> torch.Tensor:
    """K3's function in plain PyTorch, in fp32, rounded once to x's dtype."""
    if act not in (None, "silu"):
        raise ValueError(act)
    n, c = x.shape[0], x.shape[-1]
    scale, shift = group_scale_shift(x, gamma, beta, num_groups, eps)
    y = torch.addcmul(shift[:, None], x.reshape(n, -1, c).float(), scale[:, None])
    if act == "silu":
        y = F.silu(y)
    return y.reshape(x.shape).to(x.dtype)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.kernel("fused_group_norm")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def chunk_rows(c: int, itemsize: int) -> int:
    """Rows of one K3 chunk: as many whole rows as CHUNK_BYTES holds."""
    return max(1, CHUNK_BYTES // (c * itemsize))


def cluster_smem(c: int, itemsize: int, stages: int) -> int:
    """Bytes of shared memory of one K3 CTA over C channels with a ring of
    `stages` chunk slots (csrc/fused_gn.cu `k3_smem`): the slots, then in
    fp32 its partials (2·C), its threads' sums (2 · lanes · C), the scales
    and shifts (2·C), room for the group statistics (2·C), and four 8-byte
    mbarriers a slot."""
    lanes = CONSUMERS // (c * itemsize // 16)
    return stages * chunk_rows(c, itemsize) * c * itemsize + 4 * (6 * c + 2 * lanes * c) + 32 * stages


@functools.lru_cache(maxsize=None)
def cluster_plan(n: int, s: int, c: int, itemsize: int) -> tuple[int, int, int]:
    """(cluster, rows, stages) of K3 over N images of S rows of C channels
    of `itemsize` bytes: one cluster of `cluster` CTAs per image, CTA k
    takes rows [k·rows, min(S, (k + 1)·rows)) in chunks of `chunk_rows`,
    through a ring of `stages` slots (the chunks the ring no longer holds
    after the statistics are read again, from L2 as far as it holds them).
      * The cluster doubles from 1 while the card's SMs idle (fewer than 128
        CTAs in all), never past S, to 8 CTAs, and to 16 only where each
        CTA still takes 256 rows: on an H100, 16-CTA clusters were slower
        than 8-CTA ones at 32²·640 and 16²·640 and faster at 64²
        (perf/torch_k3_plan_sweep.py; PERF.md §6).
      * All N clusters run in one wave: one CTA an SM if the card holds N
        such clusters at once, else two (a cluster left to a second wave
        costs the whole launch its time again).
      * The ring holds all of a CTA's chunks where they fit its share of the
        SM's shared memory (x read once), else as many as fit."""
    cluster = 1
    while cluster < MAX_CLUSTER and cluster < s and n * cluster < _FILL_CTAS:
        if 2 * cluster == MAX_CLUSTER and s < MAX_CLUSTER * 256:
            break
        cluster *= 2
    rows = math.ceil(s / cluster)
    per_sm = 1 if n <= _WAVE_CLUSTERS[cluster] else 2
    cap = min(SMEM_MAX, SM_SMEM // per_sm - 1024)
    stages = math.ceil(rows / chunk_rows(c, itemsize))
    while stages > 1 and cluster_smem(c, itemsize, stages) > cap:
        stages -= 1
    return cluster, rows, stages


def stats_split(n: int, s: int, c: int, itemsize: int) -> tuple[int, int]:
    """(rows per CTA, CTAs per image) of K4's statistics pass: a row of C
    channels is C·itemsize/16 threads wide, so 256 threads cover `lanes`
    rows at once; each CTA takes at least 8 rows per lane, and the grid
    stays near 512 CTAs."""
    lanes = _THREADS // (c * itemsize // 16)
    chunks = max(1, min(math.ceil(s / (8 * lanes)), math.ceil(512 / n)))
    rows = math.ceil(s / chunks)
    return rows, math.ceil(s / rows)


def check_stats_operands(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, num_groups: int,
                         dtypes, name: str) -> None:
    """Raise for what the statistics kernels do not take."""
    c = x.shape[-1]
    if x.dtype not in dtypes:
        raise ValueError(f"{name} takes {dtypes} on the card, got {x.dtype}")
    vec = 16 // x.element_size()
    if c % vec or c // vec > _THREADS or c % num_groups:
        raise ValueError(f"{name} takes C % {vec} == 0, C <= {_THREADS * vec} and C % groups == 0, "
                         f"got C={c}, groups={num_groups}")
    dev = x.get_device()
    for t in (gamma, beta):
        if t.shape != (c,) or t.dtype not in _DTYPES or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous fp32 or bf16 (C,) gamma and beta")
        if t.get_device() != dev:
            raise ValueError(f"{name}: every tensor must lie on one CUDA device")
    if gamma.dtype != beta.dtype:
        raise ValueError(f"{name}: gamma and beta must share a dtype")
    if x.numel() > 2**31 - 1:
        raise ValueError(f"{name}: x exceeds int32 indexing")


def _forward(x, gamma, beta, num_groups, eps, act):
    if not x.is_cuda:
        return fused_group_norm_plain(x, gamma, beta, num_groups, eps, act)
    if act not in (None, "silu"):
        raise ValueError(act)
    check_stats_operands(x, gamma, beta, num_groups, _DTYPES, "fused_group_norm")
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel():
        n, c = x.shape[0], x.shape[-1]
        s = x.numel() // (n * c)
        cluster, rows, stages = cluster_plan(n, s, c, x.element_size())
        err = _kernel()(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), n, s, c, num_groups, eps,
                        act == "silu", cluster, rows, stages, x.dtype == torch.bfloat16,
                        gamma.dtype == torch.bfloat16, torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"fused_group_norm launch failed: CUDA error {err}")
        LAUNCHES["fused_group_norm"] += 1
    return y


class FusedGroupNorm(torch.autograd.Function):
    """K3 forward; the backward recomputes `fused_group_norm_plain` with
    autograd (no kernel, no dispatch), as the JAX custom_vjp recomputes
    through XLA."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, act):
        ctx.save_for_backward(x, gamma, beta)
        ctx.args = (num_groups, eps, act)
        return _forward(x, gamma, beta, num_groups, eps, act)

    @staticmethod
    def backward(ctx, grad):
        return (*recompute_grads(fused_group_norm_plain, ctx, grad), None, None, None)


def recompute_grads(plain, ctx, grad):
    """The gradients of `plain(*saved, *ctx.args)` for the saved inputs that
    need one (None for the others), by autograd through a recomputation."""
    inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [t for t in inputs if t.requires_grad]
    with torch.enable_grad():
        out = plain(*inputs, *ctx.args)
    grads = iter(torch.autograd.grad(out, wanted, grad))
    return [next(grads) if t.requires_grad else None for t in inputs]


def fused_group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, num_groups: int = 32,
                     eps: float = 1e-6, act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm(+SiLU) over (N, ..., C) on K3; see the module docstring."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad or beta.requires_grad):
        return FusedGroupNorm.apply(x, gamma, beta, num_groups, eps, act)
    return _forward(x, gamma, beta, num_groups, eps, act)
