"""torchvision ResNet-50 feature trunk, the dgm-eval "swav" encoder (port of
`faceposegenerator_tpu/models/resnet50.py`).

A torchvision ResNet-50 with SwAV weights; the representation is the 2048-d
global average pool (`dgm_eval/models/swav.py:200-310`) over 224²
imagenet-normalized inputs. Inference BatchNorm (eps 1e-5) is folded to a
scale and shift, as in JAX. fp32, NHWC; no kernel of the port runs here.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from .layers import ConvBN, he_init, materialize, pool_nhwc, split_conv_bn

BN_EPS = 1e-5
LAYERS = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)
STRIDES = (1, 2, 2, 2)


def _bottleneck(x, p, stride):
    h = p["conv1"](x, BN_EPS)
    h = p["conv2"](h, BN_EPS, stride=stride, padding=1)
    h = p["conv3"](h, BN_EPS, relu=False)
    identity = p["downsample"](x, BN_EPS, stride=stride, relu=False) if "downsample" in p else x
    return F.relu(h + identity)


class ResNet50(nn.Module):
    """A frozen evaluation encoder; attribute names follow the JAX tree."""

    def __init__(self, *, device=None, seed: int = 0):
        device = resolve_device(device)
        super().__init__()
        with torch.device("meta"):
            self.stem = ConvBN(3, 64, 7)
            cin = 64
            for li, (n, width) in enumerate(zip(LAYERS, WIDTHS)):
                cout = width * 4
                blocks = []
                for bi in range(n):
                    block = {"conv1": ConvBN(cin if bi == 0 else cout, width, 1), "conv2": ConvBN(width, width, 3),
                             "conv3": ConvBN(width, cout, 1)}
                    if bi == 0:
                        block["downsample"] = ConvBN(cin, cout, 1)
                    blocks.append(nn.ModuleDict(block))
                setattr(self, f"layer{li + 1}", nn.ModuleList(blocks))
                cin = cout
        g = torch.Generator(device=device).manual_seed(seed)
        he_init(materialize(self, device, torch.float32, g), g)
        self.requires_grad_(False)

    @staticmethod
    def jax_tree_layout(tree, state):
        return split_conv_bn(tree), state

    def forward(self, images: torch.Tensor, tap: Optional[Callable] = None) -> torch.Tensor:
        """images (B, H, W, 3) imagenet-normalized → (B, 2048), fp32. `tap`
        is applied to the last bottleneck's output (the reference GradCAM
        target 'layer4.2')."""
        x = self.stem(images.float(), BN_EPS, stride=2, padding=3)
        x = pool_nhwc(x, "max", 3, 2, 1)
        for li, stride in enumerate(STRIDES):
            for bi, block in enumerate(getattr(self, f"layer{li + 1}")):
                x = _bottleneck(x, block, stride if bi == 0 else 1)
        if tap is not None:
            x = tap(x)
        return x.mean(dim=(1, 2))
