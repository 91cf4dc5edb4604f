"""IResNet, the ArcFace backbone, inference forward (port of
`faceposegenerator_tpu/models/iresnet.py:147-227` with `train=False`).

Stem conv3x3 → BN → PReLU; four stages of blocks BN → conv3x3 → BN → PReLU
→ conv3x3(stride) → BN, with a 1×1 conv + BN shortcut where the shape
changes; head BN → flatten → fc (512·7·7 → 512) → BN1d whose weight is fixed
at 1. BatchNorm uses the running statistics (the frozen embedder of the
ID-Booth identity loss). The body runs in the policy's compute dtype, NHWC
as in the JAX package, so the flatten before fc is in NHWC order; the head
runs in fp32. Training-mode BatchNorm and the SE variant are not ported.

Input (B, 112, 112, 3) in [-1, 1] → (B, num_features) fp32 embedding.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.precision import DEFAULT_POLICY, Policy
from ..ops.norms import batch_norm_inference
from .layers import conv2d, materialize

DEPTHS = {
    "r18": (2, 2, 2, 2),
    "r34": (3, 4, 6, 3),
    "r50": (3, 4, 14, 3),
    "r100": (3, 13, 30, 3),
    "r200": (6, 26, 60, 3),
}
STAGE_PLANES = (64, 128, 256, 512)


@dataclasses.dataclass(frozen=True)
class IResNetConfig:
    """The inference fields of the JAX `IResNetConfig` (iresnet.py:49-66);
    its dropout, BN momentum, SE and remat fields serve training only."""

    depths: Sequence[int] = DEPTHS["r100"]
    num_features: int = 512
    fc_scale: int = 7 * 7
    bn_eps: float = 1e-5
    in_channels: int = 3


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

    def forward(self, x: torch.Tensor, eps: float, fixed_weight: bool = False) -> torch.Tensor:
        gamma = torch.ones_like(self.weight) if fixed_weight else self.weight
        return batch_norm_inference(x, gamma, self.bias, self.mean, self.var, eps)


def prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """max(x, 0) + a·min(x, 0) with a per-channel slope (iresnet.py:132-134)."""
    return torch.where(x > 0, x, x * a.to(x.dtype))


class IBasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
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

    def forward(self, x, eps: float):
        h = conv2d(self.bn1(x, eps), self.conv1)
        h = prelu(self.bn2(h, eps), self.prelu)
        h = self.bn3(conv2d(h, self.conv2, stride=self.stride), eps)
        if self.down_conv is not None:
            x = self.down_bn(conv2d(x, self.down_conv, stride=self.stride, padding=0), eps)
        return h + x


class IResNet(nn.Module):
    """The frozen ArcFace embedder; attribute names follow the JAX (params,
    state) trees, so `bridge.jax_params.load_jax_params(model, params,
    state)` loads them."""

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
                blocks = [IBasicBlock(cin if b == 0 else planes, planes, 2 if b == 0 else 1) for b in range(depth)]
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

    def forward(self, images: torch.Tensor, policy: Policy = DEFAULT_POLICY, return_features: bool = False):
        """(B, 112, 112, C) → (B, num_features) fp32 embedding; with
        `return_features`, (embedding, the flattened post-bn2 feature map
        (B, 512·7·7) in fp32), the input of CR-FIQA's quality head too
        (iresnet.py:160-162)."""
        eps = self.cfg.bn_eps
        x = conv2d(images.to(policy.compute_dtype), self.conv1)
        x = prelu(self.bn1(x, eps), self.prelu1)
        for s in range(4):
            for block in getattr(self, f"layer{s + 1}"):
                x = block(x, eps)
        x = self.bn2(x, eps)
        features = x.float().reshape(x.shape[0], -1)  # NHWC order, as the JAX head flattens
        x = F.linear(features, self.fc.weight.float(), self.fc.bias.float())
        out = self.features_bn(x, eps, fixed_weight=True)
        return (out, features) if return_features else out
