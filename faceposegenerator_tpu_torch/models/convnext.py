"""ConvNeXt feature trunk, the dgm-eval "convnext" encoder (port of
`faceposegenerator_tpu/models/convnext.py`).

timm `convnext_large_in22k`'s forward_features → global average → head LN
(1536-d; `dgm_eval/models/convnext.py:78-84`) over 224² imagenet-normalized
inputs. Stem conv 4×4 stride 4 + LN → four stages of blocks [depthwise
conv 7×7 → LN → MLP (4×, GELU) → γ LayerScale → residual], LN + conv 2×2
stride 2 between stages. LayerNorm statistics and affine in fp32, as JAX's
`ops.norms.layer_norm` applies them; the whole trunk runs in fp32, NHWC; no
kernel of the port runs here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops.lora import lora_dense
from ..ops.norms import layer_norm
from .layers import Affine, conv_nhwc, materialize

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    depths: Sequence[int] = (3, 3, 27, 3)
    dims: Sequence[int] = (192, 384, 768, 1536)  # convnext_large


CONVNEXT_LARGE = ConvNeXtConfig()


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, groups=dim)
        self.norm = Affine(dim)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        dim = x.shape[-1]
        h = conv_nhwc(x, self.conv_dw.weight, self.conv_dw.bias, padding=3, groups=dim)  # "SAME"
        h = layer_norm(h, self.norm.weight, self.norm.bias, LN_EPS)
        h = lora_dense(F.gelu(lora_dense(h, self.fc1.weight, self.fc1.bias)), self.fc2.weight, self.fc2.bias)
        return x + h * self.gamma.to(h.dtype)


class Downsample(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm = Affine(cin)
        self.conv = nn.Conv2d(cin, cout, 2)


class ConvNeXt(nn.Module):
    """A frozen evaluation encoder; attribute names follow the JAX tree."""

    def __init__(self, cfg: ConvNeXtConfig = CONVNEXT_LARGE, *, device=None, seed: int = 0):
        device = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        with torch.device("meta"):
            self.stem_conv = nn.Conv2d(3, cfg.dims[0], 4)
            self.stem_norm = Affine(cfg.dims[0])
            self.head_norm = Affine(cfg.dims[-1])
            for s, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
                if s > 0:
                    setattr(self, f"stage{s}_downsample", Downsample(cfg.dims[s - 1], dim))
                setattr(self, f"stage{s}_blocks", nn.ModuleList(ConvNeXtBlock(dim) for _ in range(depth)))
        materialize(self, device, torch.float32, torch.Generator(device=device).manual_seed(seed))
        with torch.no_grad():  # γ starts at 1e-6 (convnext.py:108)
            for m in self.modules():
                if isinstance(m, ConvNeXtBlock):
                    m.gamma.fill_(1e-6)
        self.requires_grad_(False)

    def forward(self, images: torch.Tensor, tap: Optional[Callable] = None) -> torch.Tensor:
        """images (B, H, W, 3) imagenet-normalized → (B, dims[-1]), fp32.
        `tap` is applied to the last stage's last block output (the
        reference GradCAM target 'stages.3.blocks.2')."""
        cfg = self.cfg
        x = conv_nhwc(images.float(), self.stem_conv.weight, self.stem_conv.bias, stride=4)
        x = layer_norm(x, self.stem_norm.weight, self.stem_norm.bias, LN_EPS)
        for s in range(len(cfg.depths)):
            if s > 0:
                ds = getattr(self, f"stage{s}_downsample")
                x = layer_norm(x, ds.norm.weight, ds.norm.bias, LN_EPS)
                x = conv_nhwc(x, ds.conv.weight, ds.conv.bias, stride=2)
            for block in getattr(self, f"stage{s}_blocks"):
                x = block(x)
        if tap is not None:
            x = tap(x)
        x = x.mean(dim=(1, 2))
        return layer_norm(x, self.head_norm.weight, self.head_norm.bias, LN_EPS)
