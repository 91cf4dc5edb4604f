"""MobileFaceNet face embedder, NHWC (port of
`faceposegenerator_tpu/models/mobilefacenet.py`).

`get_mbf` of the reference (blocks (1, 4, 6, 2), scale 2): a conv+BN+PReLU
stem and a grouped 3×3, depthwise bottleneck blocks (1×1 expand → 3×3
depthwise → 1×1 project, residual inside the "res" groups), a 1×1 conv to
512 and the GDC head (7×7 depthwise → flatten → linear → BN). BatchNorm in
inference mode, as in the JAX package (the frozen-embedder use).
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
from .iresnet import BatchNorm, prelu
from .layers import Affine, materialize


@dataclasses.dataclass(frozen=True)
class MBFConfig:
    blocks: Sequence[int] = (1, 4, 6, 2)
    scale: int = 2
    num_features: int = 512
    bn_eps: float = 1e-5


class ConvBN(nn.Module):
    """Bias-free conv (JAX "w", HWIO there, OIHW here; "groups" static) →
    inference BN ("bn" {g, b}; state "mean", "var") → optional PReLU."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int, groups: int = 1, use_prelu: bool = True):
        super().__init__()
        self.groups = groups
        self.w = nn.Parameter(torch.empty(cout, cin // groups, kh, kw))
        self.bn = Affine(cout)
        self.mean = nn.Parameter(torch.empty(cout), requires_grad=False)
        self.var = nn.Parameter(torch.empty(cout), requires_grad=False)
        self.prelu = nn.Parameter(torch.empty(cout)) if use_prelu else None

    def forward(self, x, stride: int = 1, padding: int = 1, eps: float = 1e-5):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.w.to(x.dtype), None, stride, padding, 1, self.groups)
        y = batch_norm_inference(y.permute(0, 2, 3, 1), self.bn.weight, self.bn.bias, self.mean, self.var, eps)
        return prelu(y, self.prelu) if self.prelu is not None else y


class DepthWise(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, residual: bool = False):
        super().__init__()
        self.expand = ConvBN(1, 1, cin, groups)
        self.dw = ConvBN(3, 3, groups, groups, groups=groups)
        self.project = ConvBN(1, 1, groups, cout, use_prelu=False)
        self.residual = residual

    def forward(self, x, stride: int, eps: float):
        h = self.expand(x, 1, 0, eps)
        h = self.dw(h, stride, 1, eps)
        h = self.project(h, 1, 0, eps)
        return x + h if self.residual else h


class MobileFaceNet(nn.Module):
    """(B, 112, 112, 3) [-1, 1] → (B, num_features) fp32 embedding.
    `stages` holds a DepthWise for each "down" entry of the JAX tree and a
    ModuleList for each "res" group; `jax_tree_layout` drops the kind tags."""

    def __init__(self, cfg: MBFConfig = MBFConfig(), *, device=None, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        device = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        c64, c128 = 64 * cfg.scale, 128 * cfg.scale
        plan = [("down", c64, c64, 128), ("res", c64, cfg.blocks[1], 128),
                ("down", c64, c128, 256), ("res", c128, cfg.blocks[2], 256),
                ("down", c128, c128, 512), ("res", c128, cfg.blocks[3], 256)]
        with torch.device("meta"):
            self.stem = ConvBN(3, 3, 3, c64)
            self.stem_dw = ConvBN(3, 3, c64, c64, groups=64)
            self.kinds = [kind for kind, *_ in plan]
            self.stages = nn.ModuleList(
                DepthWise(cin, arg, groups) if kind == "down"
                else nn.ModuleList(DepthWise(cin, cin, groups, residual=True) for _ in range(arg))
                for kind, cin, arg, groups in plan)
            self.sep = ConvBN(1, 1, c128, 512)
            self.gdc = ConvBN(7, 7, 512, 512, groups=512, use_prelu=False)
            self.fc = nn.Linear(512, cfg.num_features, bias=False)
            self.features_bn = BatchNorm(cfg.num_features)
        g = torch.Generator(device=device).manual_seed(seed)
        materialize(self, device, dtype, g)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (ConvBN, BatchNorm)):
                    m.mean.zero_()
                    m.var.fill_(1.0)
                if isinstance(m, BatchNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                if isinstance(m, ConvBN):
                    m.w.normal_(0.0, (2.0 / m.w[0].numel()) ** 0.5, generator=g)
                    if m.prelu is not None:
                        m.prelu.fill_(0.25)

    def jax_tree_layout(self, tree, state):
        """The JAX trees with each stage's ("down" | "res", params) tag and
        the blocks' "residual" flags checked and dropped."""
        stages = []
        for kind, entry, module in zip(self.kinds, tree["stages"], self.stages):
            tag, sub = entry
            if str(tag) != kind:
                raise ValueError(f"stage {len(stages)}: tree has {tag!r}, module {kind!r}")
            blocks = [sub] if kind == "down" else list(sub)
            mods = [module] if kind == "down" else list(module)
            for b, m in zip(blocks, mods):
                if bool(b["residual"]) != m.residual:
                    raise ValueError(f"stage {len(stages)}: residual {bool(b['residual'])} != {m.residual}")
            blocks = [{k: v for k, v in b.items() if k != "residual"} for b in blocks]
            stages.append(blocks[0] if kind == "down" else blocks)
        return dict(tree, stages=stages), state

    def forward(self, images: torch.Tensor, policy: Policy = DEFAULT_POLICY) -> torch.Tensor:
        eps = self.cfg.bn_eps
        x = images.to(policy.compute_dtype)
        x = self.stem(x, 2, 1, eps)
        x = self.stem_dw(x, 1, 1, eps)
        for kind, stage in zip(self.kinds, self.stages):
            if kind == "down":
                x = stage(x, 2, eps)
            else:
                for block in stage:
                    x = block(x, 1, eps)
        x = self.sep(x, 1, 0, eps)
        x = self.gdc(x, 1, 0, eps)  # 7x7 → 1x1
        x = F.linear(x.float().reshape(x.shape[0], -1), self.fc.weight.float())
        h = self.features_bn
        return batch_norm_inference(x, h.weight, h.bias, h.mean, h.var, eps)

