"""Tensor parallelism of the UNet over the mesh's "model" axis (port of
`faceposegenerator_tpu/parallel/tp.py:42-142`).

The Megatron placement, one rank a slice of every transformer block whose
head count divides the axis:
  - attention q/k/v keep this rank's heads (their out-rows), `out` the same
    in-columns: each rank attends over its heads and its `out` yields a
    partial sum, all-reduced over "model", the bias added once after;
  - the GEGLU ff_in keeps this rank's range of the value rows AND the same
    range of the gate rows (its weight is [value(4h); gate(4h)], so a
    contiguous split would give one rank every value row), ff_out the same
    in-columns, then one all-reduce and the bias;
  - per-call LoRA pairs are sliced as views: B by out-rows on q/k/v, A by
    in-columns on `out`, so `out`'s partial LoRA term joins the same reduce
    exactly once;
  - convolutions, norms, the time embedding and the proj_in/proj_out
    linears stay replicated, and so does every block of a level whose head
    count does not divide the axis, with no reduce (SD2.1's 5/10/20 heads
    at model 2: level 0 stays whole).

JAX places the weights and lets jit insert the two all-reduces a block;
here the placement slices the module's weights in place and marks each
sharded attention and MLP with a `TPSlice`, which the UNet's forward
reads. Under autograd the input of a sharded layer is the identity forward
and an all-reduce backward, and the output's reduce is an identity
backward, so a train step through a sharded UNet gets every rank the full
gradient upstream; `lora_grad_scale` says how to combine the LoRA
gradients over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn as nn

from ..core.mesh import MODEL_AXIS, Mesh


class _CopyToModel(torch.autograd.Function):
    """Identity forward, sum over "model" backward (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over "model" forward, identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass
class TPSlice:
    """This rank's channel range [lo, hi) of a sharded attention (heads ×
    head_dim) or MLP (4·dim), and the mesh whose "model" ranks share it."""

    lo: int
    hi: int
    mesh: Mesh

    @property
    def width(self) -> int:
        return self.hi - self.lo

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_grad_enabled():
            return x
        return _CopyToModel.apply(x, self.mesh.group(MODEL_AXIS))

    def leave(self, partial: torch.Tensor, bias) -> torch.Tensor:
        """Σ over the model ranks of `partial` (in fp32), plus `bias`, in
        `partial`'s dtype."""
        y = _ReduceFromModel.apply(partial.float(), self.mesh.group(MODEL_AXIS))
        if bias is not None:
            y = y + bias.float()
        return y.to(partial.dtype)

    def lora(self, name: str, a: torch.Tensor, b: torch.Tensor):
        """A LoRA pair of the full layer, as views of this rank's slice:
        shared (r, in)/(out, r) or per-sample (B, r, in)/(B, out, r)."""
        if name == "out":
            return a[..., self.lo:self.hi], b
        return a, b[..., self.lo:self.hi, :]


def _transformer_blocks(unet):
    """(dotted path, BasicTransformerBlock) of every transformer block."""
    for name, module in unet.named_modules():
        if type(module).__name__ == "BasicTransformerBlock":
            yield name, module


def _shards(blk, model: int, head_dim: int) -> bool:
    return (blk.attn1.q.weight.shape[1] // head_dim) % model == 0


def tp_sharding_plan(unet, model: int, head_dim: int = None) -> Dict[str, bool]:
    """{transformer block path: sharded?}: a block shards when its head
    count divides the model axis, else it stays whole (tp.py:42-66)."""
    head_dim = head_dim or unet.cfg.head_dim
    return {name: _shards(blk, model, head_dim) for name, blk in _transformer_blocks(unet)}


@torch.no_grad()
def _keep_rows(layer: nn.Linear, rows):
    layer.weight = nn.Parameter(layer.weight[rows].clone(), requires_grad=False)
    if layer.bias is not None:
        layer.bias = nn.Parameter(layer.bias[rows].clone(), requires_grad=False)
    layer.out_features = layer.weight.shape[0]


@torch.no_grad()
def _keep_cols(layer: nn.Linear, lo: int, hi: int):
    layer.weight = nn.Parameter(layer.weight[:, lo:hi].clone(), requires_grad=False)
    layer.in_features = hi - lo


def shard_unet_params_tp(unet, mesh: Mesh, head_dim: int = None):
    """Place a UNet for tensor parallelism over "model", in place: this
    rank keeps its slice of every transformer block that `tp_sharding_plan`
    shards; everything else stays whole. Returns the UNet. Every rank of a
    model row must hold the same weights (`core.mesh.replicate`) and call
    this."""
    m = mesh.model
    if m == 1:
        return unet
    head_dim = head_dim or unet.cfg.head_dim
    j = mesh.model_index
    for _, blk in _transformer_blocks(unet):
        if not _shards(blk, m, head_dim):
            continue
        dim = blk.attn1.q.weight.shape[1]
        lo, hi = j * dim // m, (j + 1) * dim // m
        for attn in (blk.attn1, blk.attn2):
            for proj in (attn.q, attn.k, attn.v):
                _keep_rows(proj, slice(lo, hi))
            _keep_cols(attn.out, lo, hi)
            attn.tp = TPSlice(lo, hi, mesh)
        ff = 4 * dim
        flo, fhi = j * ff // m, (j + 1) * ff // m
        _keep_rows(blk.ff_in, torch.cat([torch.arange(flo, fhi), torch.arange(ff + flo, ff + fhi)]).to(
            blk.ff_in.weight.device))
        _keep_cols(blk.ff_out, flo, fhi)
        blk.tp = TPSlice(flo, fhi, mesh)
    return unet


def lora_grad_scale(unet, unet_lora: dict, model: int) -> dict:
    """A tree of factors in `unet_lora`'s layout: 1.0 for the pairs of a
    sharded attention, whose gradient each model rank holds a part of,
    1/model for the rest, which every model rank holds whole. Scaled by it,
    the gradients summed over the model ranks are the full gradient."""
    from ..core.tree import tree_map_with_path

    def factor(path, leaf):
        attn = unet.get_submodule(".".join(path.split("/")[:-2]))  # .../attn1/q/a → the attention
        return 1.0 if attn.tp is not None else 1.0 / model

    return tree_map_with_path(factor, unet_lora)
