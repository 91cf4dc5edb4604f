"""SimCLRv2 selective-kernel ResNet r50_1x_sk1 (port of
`faceposegenerator_tpu/models/simclr_resnet.py`).

The dgm-eval "simclr" encoder (`dgm_eval/models/simclr.py:16-140`): a 3-conv
stem, selective-kernel (SK) 3×3 units (one conv to 2c, two channel halves
mixed by a softmax gate from their pooled sum) and zero-padded avg-pool
projection shortcuts; features are the 2048-d global average. Inference
BatchNorm (eps 1e-5) folded to a scale and shift; fp32, NHWC; no kernel of
the port runs here.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from .layers import FrozenBatchNorm, conv_nhwc, he_init, materialize, pool_nhwc

BN_EPS = 1e-5
SK_RATIO = 0.0625
LAYERS = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)
STRIDES = (1, 2, 2, 2)


def _w(cout, cin, k):
    return nn.Parameter(torch.empty(cout, cin, k, k))


def _conv(x, w, stride=1):
    """`simclr_resnet._conv`: symmetric (k − 1) / 2 padding."""
    return conv_nhwc(x, w, stride=stride, padding=(w.shape[-1] - 1) // 2)


def _bn(x, bn, relu=True):
    y = bn(x, BN_EPS)
    return F.relu(y) if relu else y


class Stem(nn.Module):
    def __init__(self, c0: int):
        super().__init__()
        self.conv1_w, self.bn1 = _w(c0, 3, 3), FrozenBatchNorm(c0)
        self.conv2_w, self.bn2 = _w(c0, c0, 3), FrozenBatchNorm(c0)
        self.conv3_w, self.bn3 = _w(2 * c0, c0, 3), FrozenBatchNorm(2 * c0)


class SelectiveKernel(nn.Module):
    def __init__(self, width: int, mid: int):
        super().__init__()
        self.main_w, self.main_bn = _w(2 * width, width, 3), FrozenBatchNorm(2 * width)
        self.mix1_w, self.mix1_bn = _w(mid, width, 1), FrozenBatchNorm(mid)
        self.mix2_w = _w(2 * width, mid, 1)

    def forward(self, x, stride):
        m = _bn(_conv(x, self.main_w, stride), self.main_bn)
        c1, c2 = m.chunk(2, dim=-1)
        g = (c1 + c2).mean(dim=(1, 2), keepdim=True)  # (B, 1, 1, c)
        mix = _conv(_bn(_conv(g, self.mix1_w), self.mix1_bn), self.mix2_w)  # (B, 1, 1, 2c)
        gate = torch.softmax(torch.stack(mix.chunk(2, dim=-1)), dim=0)
        return c1 * gate[0] + c2 * gate[1]


class Projection(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv_w, self.bn = _w(cout, cin, 1), FrozenBatchNorm(cout)

    def forward(self, x, stride):
        """Zero-pad right and bottom, 2×2 average pool (the pad counted), 1×1
        conv, BN (`simclr.py:45-58`)."""
        h = F.pad(x, (0, 0, 0, 1, 0, 1))
        h = F.avg_pool2d(h.permute(0, 3, 1, 2), 2, stride).permute(0, 2, 3, 1)
        return _bn(_conv(h, self.conv_w), self.bn, relu=False)


class SKBlock(nn.Module):
    def __init__(self, cin: int, width: int, proj: bool):
        super().__init__()
        cout = width * 4
        self.conv1_w, self.bn1 = _w(width, cin, 1), FrozenBatchNorm(width)
        self.sk = SelectiveKernel(width, max(int(width * SK_RATIO), 32))
        self.conv3_w, self.bn3 = _w(cout, width, 1), FrozenBatchNorm(cout)
        self.proj = Projection(cin, cout) if proj else None

    def forward(self, x, stride):
        short = x if self.proj is None else self.proj(x, stride)
        h = _bn(_conv(x, self.conv1_w), self.bn1)
        h = self.sk(h, stride)
        h = _bn(_conv(h, self.conv3_w), self.bn3, relu=False)
        return F.relu(short + h)


class SimCLRResNet(nn.Module):
    """A frozen evaluation encoder; attribute names follow the JAX tree."""

    def __init__(self, width_multiplier: int = 1, *, device=None, seed: int = 0):
        device = resolve_device(device)
        super().__init__()
        with torch.device("meta"):
            self.stem = Stem(64 * width_multiplier // 2)
            stages, cin = [], 64 * width_multiplier
            for n, width in zip(LAYERS, (w * width_multiplier for w in WIDTHS)):
                stages.append(nn.ModuleList(SKBlock(cin if b == 0 else width * 4, width, b == 0) for b in range(n)))
                cin = width * 4
            self.stages = nn.ModuleList(stages)
        g = torch.Generator(device=device).manual_seed(seed)
        he_init(materialize(self, device, torch.float32, g), g)
        self.requires_grad_(False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) in [0, 1] → (B, 2048), fp32."""
        st = self.stem
        x = _bn(_conv(images.float(), st.conv1_w, stride=2), st.bn1)
        x = _bn(_conv(x, st.conv2_w), st.bn2)
        x = _bn(_conv(x, st.conv3_w), st.bn3)
        x = pool_nhwc(x, "max", 3, 2, 1)
        for stage, stride in zip(self.stages, STRIDES):
            for b, block in enumerate(stage):
                x = block(x, stride if b == 0 else 1)
        return x.mean(dim=(1, 2))
