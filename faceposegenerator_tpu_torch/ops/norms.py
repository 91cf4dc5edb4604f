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
    """LayerNorm over the last axis, output in x's dtype; the kernel keeps
    its statistics and affine in fp32 whatever x's dtype."""
    return F.layer_norm(x, (x.shape[-1],), gamma.to(x.dtype), beta.to(x.dtype), eps)


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
    axis_name: Optional[str] = None,
):
    """Training-mode BatchNorm over (N, ..., C): statistics over every axis
    but the last, in fp32, with var = E[x²] − mean² (norms.py:113-145).
    Returns (out in x's dtype, new running mean, new running var); the
    running variance takes the unbiased n/(n−1) form, momentum weighting the
    batch. `axis_name` (JAX's cross-replica sync of the statistics) needs
    the mesh, which the port does not have yet."""
    if axis_name is not None:
        raise ValueError("batch_norm_train(axis_name=...) syncs statistics over a mesh, which the port does not "
                         "have yet (ROADMAP.md queue 1, item 9: the data-parallel mesh)")
    x32 = x.float()
    axes = tuple(range(x.dim() - 1))
    mean = x32.mean(dim=axes)
    var = x32.square().mean(dim=axes) - mean.square()
    n = x.numel() // x.shape[-1]
    unbiased = var * (n / max(n - 1, 1))
    new_mean = (1 - momentum) * running_mean + momentum * mean
    new_var = (1 - momentum) * running_var + momentum * unbiased
    out = (x32 - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return out.to(x.dtype), new_mean, new_var
