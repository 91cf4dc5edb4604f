"""IResNet, the ArcFace backbone (port of
`faceposegenerator_tpu/models/iresnet.py:49-227`).

Stem conv3x3 → BN → PReLU; four stages of blocks BN → conv3x3 → BN → PReLU
→ conv3x3(stride) → BN [→ SE gate], with a 1×1 conv + BN shortcut where the
shape changes; head BN → flatten → dropout → fc (512·7·7 → 512) → BN1d whose
weight is fixed at 1. The body runs in the policy's compute dtype, NHWC as
in the JAX package, so the flatten before fc is in NHWC order; the head
runs in fp32.

Two modes, as `apply(train=...)`:
  - inference (the frozen ArcFace embedder): BatchNorm uses the running
    statistics; `forward` returns the embedding;
  - training (the FR trainer): batch statistics, dropout on the flattened
    features from a `torch.Generator` (or an explicit keep mask), and
    `forward` returns (embedding, new running statistics) with the
    statistics in the JAX state tree's layout. The module's own running
    statistics change only through `load_state_tree`.

The running mean and variance are parameters that never require grad (JAX
`state`, not `params`): an optimizer takes `trainable_parameters`, which
leaves them out. `remat` recomputes each block in the backward
(`torch.utils.checkpoint`, as `jax.checkpoint` per block).

Input (B, 112, 112, C) in [-1, 1] → (B, num_features) fp32 embedding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..core.precision import DEFAULT_POLICY, Policy
from ..core.tree import tree_paths
from ..ops.norms import batch_norm_inference, batch_norm_train
from .layers import conv2d, materialize

DEPTHS = {
    "r18": (2, 2, 2, 2),
    "r34": (3, 4, 6, 3),
    "r50": (3, 4, 14, 3),
    "r100": (3, 13, 30, 3),
    "r200": (6, 26, 60, 3),
    "r2060": (3, 128, 896, 3),
}
STAGE_PLANES = (64, 128, 256, 512)
STATE_NAMES = ("mean", "var")


@dataclasses.dataclass(frozen=True)
class IResNetConfig:
    """The JAX `IResNetConfig` (iresnet.py:49-66): `dropout` and
    `bn_momentum` act in training mode only; `use_se` adds the SE gate of
    the FR-training backbone (SEModule(planes, 16)); `remat` recomputes each
    block in the backward."""

    depths: Sequence[int] = DEPTHS["r100"]
    num_features: int = 512
    dropout: float = 0.0
    fc_scale: int = 7 * 7
    bn_eps: float = 1e-5
    bn_momentum: float = 0.1
    use_se: bool = False
    se_reduction: int = 16
    in_channels: int = 3
    remat: bool = False


def config_for(name: str, **kw) -> IResNetConfig:
    return IResNetConfig(depths=DEPTHS[name], **kw)


class BatchNorm(nn.Module):
    """Affine and running statistics (JAX params "g", "b"; state "mean", "var")."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.mean = nn.Parameter(torch.empty(c), requires_grad=False)
        self.var = nn.Parameter(torch.empty(c), requires_grad=False)

    def forward(self, x: torch.Tensor, cfg: IResNetConfig, train: bool = False, fixed_weight: bool = False,
                bn_sync=None):
        """Inference: the normalised x. Training: (normalised x, {"mean",
        "var"}: the new running statistics); `bn_sync` = (group,
        global_stats) syncs the statistics over a process group
        (`ops.norms.batch_norm_train`)."""
        gamma = torch.ones_like(self.weight) if fixed_weight else self.weight
        if not train:
            return batch_norm_inference(x, gamma, self.bias, self.mean, self.var, cfg.bn_eps)
        group, global_stats = bn_sync or (None, False)
        out, mean, var = batch_norm_train(x, gamma, self.bias, self.mean, self.var,
                                          momentum=cfg.bn_momentum, eps=cfg.bn_eps, group=group,
                                          global_stats=global_stats)
        return out, {"mean": mean, "var": var}


def prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """max(x, 0) + a·min(x, 0) with a per-channel slope (iresnet.py:132-134)."""
    return torch.where(x > 0, x, x * a.to(x.dtype))


class IBasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, cfg: IResNetConfig):
        super().__init__()
        self.stride = stride
        self.bn1 = BatchNorm(cin)
        self.conv1 = nn.Conv2d(cin, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.prelu = nn.Parameter(torch.empty(planes))
        self.conv2 = nn.Conv2d(planes, planes, 3)
        self.bn3 = BatchNorm(planes)
        if stride != 1 or cin != planes:
            self.down_conv = nn.Conv2d(cin, planes, 1)
            self.down_bn = BatchNorm(planes)
        else:
            self.down_conv = self.down_bn = None
        if cfg.use_se:
            r = max(planes // cfg.se_reduction, 1)
            self.se_fc1 = nn.Conv2d(planes, r, 1)
            self.se_fc2 = nn.Conv2d(r, planes, 1)
        else:
            self.se_fc1 = self.se_fc2 = None

    def forward(self, x, cfg: IResNetConfig, train: bool = False, bn_sync=None):
        """Inference: the block's output. Training: (output, the new running
        statistics of its BatchNorms)."""
        stats = {}

        def bn(name, h):
            out = getattr(self, name)(h, cfg, train, bn_sync=bn_sync)
            if train:
                out, stats[name] = out
            return out

        h = conv2d(bn("bn1", x), self.conv1)
        h = prelu(bn("bn2", h), self.prelu)
        h = bn("bn3", conv2d(h, self.conv2, stride=self.stride))
        if self.se_fc1 is not None:  # SE gate (iresnet.py:185-190)
            a = F.relu(conv2d(h.mean(dim=(1, 2), keepdim=True), self.se_fc1, padding=0))
            h = h * torch.sigmoid(conv2d(a, self.se_fc2, padding=0))
        if self.down_conv is not None:
            x = bn("down_bn", conv2d(x, self.down_conv, stride=self.stride, padding=0))
        return (h + x, stats) if train else h + x


class IResNet(nn.Module):
    """The ArcFace backbone; attribute names follow the JAX (params, state)
    trees, so `bridge.jax_params.load_jax_params(model, params, state)`
    loads them."""

    def __init__(self, cfg: IResNetConfig = IResNetConfig(), *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        device = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        with torch.device("meta"):
            self.conv1 = nn.Conv2d(cfg.in_channels, 64, 3)
            self.bn1 = BatchNorm(64)
            self.prelu1 = nn.Parameter(torch.empty(64))
            cin = 64
            for s, (planes, depth) in enumerate(zip(STAGE_PLANES, cfg.depths)):
                blocks = [IBasicBlock(cin if b == 0 else planes, planes, 2 if b == 0 else 1, cfg)
                          for b in range(depth)]
                setattr(self, f"layer{s + 1}", nn.ModuleList(blocks))
                cin = planes
            self.bn2 = BatchNorm(512)
            self.fc = nn.Linear(512 * cfg.fc_scale, cfg.num_features)
            self.features_bn = BatchNorm(cfg.num_features)
        materialize(self, device, dtype, torch.Generator(device=device).manual_seed(seed))
        with torch.no_grad():  # identity BatchNorms and the PReLU slope of iresnet.py:79-94
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                    m.mean.zero_()
                    m.var.fill_(1.0)
            for name, p in self.named_parameters():
                if name.endswith("prelu") or name == "prelu1":
                    p.fill_(0.25)

    def forward(self, images: torch.Tensor, policy: Policy = DEFAULT_POLICY, return_features: bool = False,
                train: bool = False, generator: Optional[torch.Generator] = None,
                dropout_mask: Optional[torch.Tensor] = None, bn_group=None, bn_global: bool = False):
        """(B, 112, 112, C) → (B, num_features) fp32 embedding; in training
        mode (embedding, new state tree). With `return_features`, the
        flattened post-bn2 feature map (B, 512·7·7) in fp32 comes last, the
        input of CR-FIQA's quality head too (iresnet.py:160-162).

        Training dropout keeps each feature with probability 1 − dropout,
        drawn from `generator` as `rand < keep`, or given as the boolean
        `dropout_mask` (the test's seam for JAX's Bernoulli draws).

        `bn_group` (a process group; JAX's `axis_name`, iresnet.py:137-219)
        syncs every training BatchNorm's statistics over its ranks: their
        averaged local moments, or with `bn_global` the moments of the
        union of their batches (`ops.norms.batch_norm_train`)."""
        cfg = self.cfg
        state = {}
        sync = None if bn_group is None else (bn_group, bn_global)

        def bn(name, module, h, fixed=False):
            out = module(h, cfg, train, fixed_weight=fixed, bn_sync=sync)
            if train:
                out, state[name] = out
            return out

        x = conv2d(images.to(policy.compute_dtype), self.conv1)
        x = prelu(bn("bn1", self.bn1, x), self.prelu1)
        for s in range(4):
            layer_state = []
            for block in getattr(self, f"layer{s + 1}"):
                if cfg.remat and torch.is_grad_enabled():
                    out = checkpoint(block, x, cfg, train, sync, use_reentrant=False)
                else:
                    out = block(x, cfg, train, sync)
                if train:
                    out, block_state = out
                    layer_state.append(block_state)
                x = out
            if train:
                state[f"layer{s + 1}"] = layer_state
        x = bn("bn2", self.bn2, x)
        features = x.float().reshape(x.shape[0], -1)  # NHWC order, as the JAX head flattens
        h = features
        if train and cfg.dropout > 0 and (generator is not None or dropout_mask is not None):
            keep = 1.0 - cfg.dropout
            if dropout_mask is None:
                dropout_mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
            h = torch.where(dropout_mask.to(h.device), h / keep, torch.zeros((), device=h.device))
        h = F.linear(h, self.fc.weight.float(), self.fc.bias.float())
        out = bn("features_bn", self.features_bn, h, fixed=True)
        result = (out, state) if train else (out,)
        if return_features:
            result += (features,)
        return result[0] if len(result) == 1 else result

    def state_tree(self) -> dict:
        """The running statistics in the JAX state tree's layout (the
        module's own tensors, not copies)."""
        def bn(m):
            return {"mean": m.mean, "var": m.var}

        state = {"bn1": bn(self.bn1)}
        for s in range(4):
            state[f"layer{s + 1}"] = [
                {name: bn(getattr(b, name)) for name in ("bn1", "bn2", "bn3", "down_bn")
                 if getattr(b, name) is not None}
                for b in getattr(self, f"layer{s + 1}")]
        state["bn2"] = bn(self.bn2)
        state["features_bn"] = bn(self.features_bn)
        return state

    @torch.no_grad()
    def load_state_tree(self, tree) -> None:
        """Copy a state tree (what training-mode `forward` returns) into the
        running statistics."""
        for path, leaf in tree_paths(tree):
            *owner, name = path.split("/")
            getattr(self.get_submodule(".".join(owner)), name).copy_(leaf)

    def trainable_parameters(self) -> list:
        """Every parameter of the JAX params tree (convolution biases and the
        features BN's weight, which the forward fixes at 1, included), in
        module order; the running statistics are left out."""
        return [p for name, p in self.named_parameters() if name.rsplit(".", 1)[-1] not in STATE_NAMES]
