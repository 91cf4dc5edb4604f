"""InceptionV3, the pytorch-fid variant (port of
`faceposegenerator_tpu/models/inception_v3.py`).

The dgm-eval registry's default encoder ("inception"; "sinception" is the
same network with SwAV-trained weights): torchvision's InceptionV3 with the
pytorch-fid patches (`dgm_eval/models/inception.py:229-340`): branch average
pools exclude the zero padding, and the last Inception-E block pools with
max. Features are the final global average, 2048-d. Inputs in [0, 1] are
bilinear-resized to 299² without antialias (`F.interpolate`,
align_corners=False: JAX's `jax.image.resize(..., antialias=False)`) and
scaled to [-1, 1]. BatchNorm (eps 1e-3) runs from running statistics. fp32
throughout, NHWC as in JAX; no kernel of the port runs here.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from .layers import ConvBN, he_init, materialize, pool_nhwc, split_conv_bn

BN_EPS = 1e-3

# (name, cin, cout, kernel) of each block's units, the torchvision trunk
_STEM = [("Conv2d_1a_3x3", 3, 32, 3), ("Conv2d_2a_3x3", 32, 32, 3), ("Conv2d_2b_3x3", 32, 64, 3),
         ("Conv2d_3b_1x1", 64, 80, 1), ("Conv2d_4a_3x3", 80, 192, 3)]


def _a_units(cin, pf):
    return [("branch1x1", cin, 64, 1), ("branch5x5_1", cin, 48, 1), ("branch5x5_2", 48, 64, 5),
            ("branch3x3dbl_1", cin, 64, 1), ("branch3x3dbl_2", 64, 96, 3), ("branch3x3dbl_3", 96, 96, 3),
            ("branch_pool", cin, pf, 1)]


_B_UNITS = [("branch3x3", 288, 384, 3), ("branch3x3dbl_1", 288, 64, 1), ("branch3x3dbl_2", 64, 96, 3),
            ("branch3x3dbl_3", 96, 96, 3)]


def _c_units(c7):
    return [("branch1x1", 768, 192, 1), ("branch7x7_1", 768, c7, 1), ("branch7x7_2", c7, c7, (1, 7)),
            ("branch7x7_3", c7, 192, (7, 1)), ("branch7x7dbl_1", 768, c7, 1),
            ("branch7x7dbl_2", c7, c7, (7, 1)), ("branch7x7dbl_3", c7, c7, (1, 7)),
            ("branch7x7dbl_4", c7, c7, (7, 1)), ("branch7x7dbl_5", c7, 192, (1, 7)),
            ("branch_pool", 768, 192, 1)]


_D_UNITS = [("branch3x3_1", 768, 192, 1), ("branch3x3_2", 192, 320, 3), ("branch7x7x3_1", 768, 192, 1),
            ("branch7x7x3_2", 192, 192, (1, 7)), ("branch7x7x3_3", 192, 192, (7, 1)),
            ("branch7x7x3_4", 192, 192, 3)]


def _e_units(cin):
    return [("branch1x1", cin, 320, 1), ("branch3x3_1", cin, 384, 1), ("branch3x3_2a", 384, 384, (1, 3)),
            ("branch3x3_2b", 384, 384, (3, 1)), ("branch3x3dbl_1", cin, 448, 1),
            ("branch3x3dbl_2", 448, 384, 3), ("branch3x3dbl_3a", 384, 384, (1, 3)),
            ("branch3x3dbl_3b", 384, 384, (3, 1)), ("branch_pool", cin, 192, 1)]


def _block(units):
    return nn.ModuleDict({name: ConvBN(cin, cout, k) for name, cin, cout, k in units})


def _a(x, p):
    u = lambda name, h, pad=0: p[name](h, BN_EPS, padding=pad)  # noqa: E731
    b1 = u("branch1x1", x)
    b5 = u("branch5x5_2", u("branch5x5_1", x), 2)
    b3 = u("branch3x3dbl_3", u("branch3x3dbl_2", u("branch3x3dbl_1", x), 1), 1)
    bp = u("branch_pool", pool_nhwc(x, "avg", 3, 1, 1))
    return torch.cat([b1, b5, b3, bp], dim=-1)


def _b(x, p):
    b3 = p["branch3x3"](x, BN_EPS, stride=2)
    bd = p["branch3x3dbl_2"](p["branch3x3dbl_1"](x, BN_EPS), BN_EPS, padding=1)
    bd = p["branch3x3dbl_3"](bd, BN_EPS, stride=2)
    return torch.cat([b3, bd, pool_nhwc(x, "max", 3, 2)], dim=-1)


def _c(x, p):
    u = lambda name, h, pad=0: p[name](h, BN_EPS, padding=pad)  # noqa: E731
    b1 = u("branch1x1", x)
    b7 = u("branch7x7_3", u("branch7x7_2", u("branch7x7_1", x), (0, 3)), (3, 0))
    bd = u("branch7x7dbl_1", x)
    bd = u("branch7x7dbl_3", u("branch7x7dbl_2", bd, (3, 0)), (0, 3))
    bd = u("branch7x7dbl_5", u("branch7x7dbl_4", bd, (3, 0)), (0, 3))
    bp = u("branch_pool", pool_nhwc(x, "avg", 3, 1, 1))
    return torch.cat([b1, b7, bd, bp], dim=-1)


def _d(x, p):
    b3 = p["branch3x3_2"](p["branch3x3_1"](x, BN_EPS), BN_EPS, stride=2)
    b7 = p["branch7x7x3_1"](x, BN_EPS)
    b7 = p["branch7x7x3_3"](p["branch7x7x3_2"](b7, BN_EPS, padding=(0, 3)), BN_EPS, padding=(3, 0))
    b7 = p["branch7x7x3_4"](b7, BN_EPS, stride=2)
    return torch.cat([b3, b7, pool_nhwc(x, "max", 3, 2)], dim=-1)


def _e(x, p, pool: str):
    u = lambda name, h, pad=0: p[name](h, BN_EPS, padding=pad)  # noqa: E731
    b1 = u("branch1x1", x)
    b3 = u("branch3x3_1", x)
    b3 = torch.cat([u("branch3x3_2a", b3, (0, 1)), u("branch3x3_2b", b3, (1, 0))], dim=-1)
    bd = u("branch3x3dbl_2", u("branch3x3dbl_1", x), 1)
    bd = torch.cat([u("branch3x3dbl_3a", bd, (0, 1)), u("branch3x3dbl_3b", bd, (1, 0))], dim=-1)
    # the FIDInceptionE_2 patch (`inception.py:322-333`): max pool in the last block
    bp = pool_nhwc(x, "max", 3, 1, 1) if pool == "max" else pool_nhwc(x, "avg", 3, 1, 1)
    return torch.cat([b1, b3, bd, u("branch_pool", bp)], dim=-1)


class InceptionV3(nn.Module):
    """A frozen evaluation encoder; attribute names follow the JAX tree (each
    JAX unit a `ConvBN`: `jax_tree_layout` splits its conv and BN leaves)."""

    def __init__(self, *, device=None, seed: int = 0):
        device = resolve_device(device)
        super().__init__()
        with torch.device("meta"):
            for name, cin, cout, k in _STEM:
                setattr(self, name, ConvBN(cin, cout, k))
            for name, (cin, pf) in zip(("Mixed_5b", "Mixed_5c", "Mixed_5d"), ((192, 32), (256, 64), (288, 64))):
                setattr(self, name, _block(_a_units(cin, pf)))
            self.Mixed_6a = _block(_B_UNITS)
            for name, c7 in zip(("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"), (128, 160, 160, 192)):
                setattr(self, name, _block(_c_units(c7)))
            self.Mixed_7a = _block(_D_UNITS)
            self.Mixed_7b = _block(_e_units(1280))
            self.Mixed_7c = _block(_e_units(2048))
        g = torch.Generator(device=device).manual_seed(seed)
        he_init(materialize(self, device, torch.float32, g), g)
        self.requires_grad_(False)

    @staticmethod
    def jax_tree_layout(tree, state):
        return split_conv_bn(tree), state

    def forward(self, images: torch.Tensor, resize_input: bool = True, normalize_input: bool = True,
                tap: Optional[Callable] = None) -> torch.Tensor:
        """images (B, H, W, 3) in [0, 1] → (B, 2048) pooled features, fp32.
        `tap` is applied to the Mixed_7c output (the reference GradCAM
        target 'blocks.3.2')."""
        x = images.float()
        if resize_input and tuple(x.shape[1:3]) != (299, 299):
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(299, 299), mode="bilinear", align_corners=False,
                              antialias=False).permute(0, 2, 3, 1)
        if normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_1a_3x3(x, BN_EPS, stride=2)
        x = self.Conv2d_2a_3x3(x, BN_EPS)
        x = self.Conv2d_2b_3x3(x, BN_EPS, padding=1)
        x = pool_nhwc(x, "max", 3, 2)
        x = self.Conv2d_3b_1x1(x, BN_EPS)
        x = self.Conv2d_4a_3x3(x, BN_EPS)
        x = pool_nhwc(x, "max", 3, 2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d):
            x = _a(x, block)
        x = _b(x, self.Mixed_6a)
        for block in (self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = _c(x, block)
        x = _d(x, self.Mixed_7a)
        x = _e(x, self.Mixed_7b, "avg")
        x = _e(x, self.Mixed_7c, "max")
        if tap is not None:
            x = tap(x)
        return x.mean(dim=(1, 2))
