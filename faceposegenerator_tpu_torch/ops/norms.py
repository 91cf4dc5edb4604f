"""Normalisation ops with fp32 statistics (port of
`faceposegenerator_tpu/ops/norms.py:17,78,98,113`).

Layout is channels-last (N, ..., C), as in the JAX package. These are plain
torch, as the JAX package leaves them to XLA, except that `group_norm`
sends the shapes K3 takes to `ops.fused_gn` under GN_IMPL=pallas
(norms.py:38-49).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import fused_gn


def group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm over (N, ..., C) with optional fused SiLU. With
    GN_IMPL=pallas, the shapes `fused_gn.slab_supported` accepts go to K3
    (`fused_gn.fused_group_norm`: the kernel on the card, its plain version
    on the CPU); every other shape, and every shape under GN_IMPL=xla, to
    `group_norm_plain`. JAX routes only on a TPU; the port routes on every
    device, so that the CPU tests exercise the route."""
    if fused_gn.gn_impl() == "pallas":
        n, c = x.shape[0], x.shape[-1]
        if fused_gn.slab_supported(n, x.numel() // max(n * c, 1), c, num_groups):
            return fused_gn.fused_group_norm(x, gamma, beta, num_groups, eps, act)
    return group_norm_plain(x, gamma, beta, num_groups, eps, act)


def group_norm_plain(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm over (N, ..., C) with optional fused SiLU, never routed to
    a kernel; statistics and the affine in fp32, output in x's dtype. As in
    the JAX twin, the statistics fold with gamma/beta into a per-(image,
    channel) scale and shift, so the normalisation is one fused
    multiply-add pass."""
    if act not in (None, "silu"):
        raise ValueError(act)
    n, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xg = x.reshape(n, -1, num_groups, cg)
    var, mean = torch.var_mean(xg.float(), dim=(1, 3), keepdim=True, correction=0)
    scale = torch.rsqrt(var + eps) * gamma.float().reshape(num_groups, cg)
    shift = beta.float().reshape(num_groups, cg) - mean * scale
    out = torch.addcmul(shift, xg, scale)  # fp32 result from x in its own dtype
    if act == "silu":
        F.silu(out, inplace=True)
    return out.reshape(x.shape).to(x.dtype)


def layer_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis, output in x's dtype, rounded once: the
    statistics and the affine in fp32 whatever x's dtype (norms.py:78-86).
    The op on the card takes no bf16 x with fp32 gamma and beta, so a bf16
    x goes through an fp32 copy (an fp32 x through none)."""
    return F.layer_norm(x.float(), (x.shape[-1],), gamma.float(), beta.float(), eps).to(x.dtype)


def batch_norm_inference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Inference-mode BatchNorm over (N, ..., C) with frozen running
    statistics, folded to one fp32 scale and shift; output in x's dtype."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    shift = beta.float() - mean.float() * scale
    return torch.addcmul(shift, x, scale).to(x.dtype)


def batch_norm_train(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    momentum: float = 0.1,
    eps: float = 1e-5,
    group=None,
    global_stats: bool = False,
):
    """Training-mode BatchNorm over (N, ..., C): statistics over every axis
    but the last, in fp32, with var = E[x²] − mean² (norms.py:113-145).
    Returns (out in x's dtype, new running mean, new running var); the
    running variance takes the unbiased n/(n−1) form, momentum weighting the
    batch.

    `group` (a process group, JAX's `axis_name`): the local mean and the
    local E[x²] − mean² are each averaged over the group's ranks, and n in
    the unbiased factor stays the local count, as JAX's pmean does (this is
    not the variance of the union, and not what torch's SyncBatchNorm
    computes). With `global_stats=True` the group's ranks instead sum Σx,
    Σx² and the count: the statistics of the union of their batches, what
    one process computes on the whole batch. Both reductions are
    differentiable; their backward sums the cotangents over the group."""
    x32 = x.float()
    axes = tuple(range(x.dim() - 1))
    n = x.numel() // x.shape[-1]
    if group is not None and global_stats:
        from ..core.mesh import psum

        sums = psum(torch.cat([x32.sum(dim=axes), x32.square().sum(dim=axes)]), group)
        n = n * dist.get_world_size(group)  # equal local batches
        mean, ex2 = sums.chunk(2)
        mean, ex2 = mean / n, ex2 / n
        var = ex2 - mean.square()
    else:
        mean = x32.mean(dim=axes)
        var = x32.square().mean(dim=axes) - mean.square()
        if group is not None:
            from ..core.mesh import psum

            mean, var = (psum(torch.cat([mean, var]), group) / dist.get_world_size(group)).chunk(2)
    unbiased = var * (n / max(n - 1, 1))
    new_mean = (1 - momentum) * running_mean + momentum * mean
    new_var = (1 - momentum) * running_var + momentum * unbiased
    out = (x32 - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return out.to(x.dtype), new_mean, new_var
