"""RepVGG in deploy mode, NHWC at the API (port of
`faceposegenerator_tpu/models/repvgg.py`): the backbone of the 6DRepNet
head-pose estimator (RepVGG-B1g2). Deploy-mode RepVGG is a plain stack of
3×3 conv + ReLU, the train-time 3×3 / 1×1 / identity branches folded into
one kernel by `fuse_branches`; "g2" puts groups of 2 on every other layer.
The convs are plain torch ops (JAX leaves them to XLA).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RepVGGConfig:
    num_blocks: Sequence[int] = (4, 6, 16, 1)  # B-series
    width_multiplier: Sequence[float] = (2.0, 2.0, 2.0, 4.0)  # B1
    group_every_other: bool = True  # "g2": groups=2 on odd-indexed layers
    groups: int = 2


REPVGG_B1G2 = RepVGGConfig()
BASE_WIDTHS = (64, 128, 256, 512)


def _layer_plan(cfg: RepVGGConfig):
    """[(cin, cout, stride, groups)] of stage 0 and the 4 stages (repvgg.py:34-51)."""
    stage0_out = min(64, int(64 * cfg.width_multiplier[0]))
    widths = [int(64 * cfg.width_multiplier[0])] + [int(b * m) for b, m in zip(BASE_WIDTHS[1:],
                                                                                  cfg.width_multiplier[1:])]
    plan = [(3, stage0_out, 2, 1)]
    cin, layer_idx = stage0_out, 1  # the global conv index of the g2 pattern
    for stage, n in enumerate(cfg.num_blocks):
        for b in range(n):
            grouped = cfg.group_every_other and layer_idx % 2 == 0 and cfg.groups > 1
            plan.append((cin, widths[stage], 2 if b == 0 else 1, cfg.groups if grouped else 1))
            cin = widths[stage]
            layer_idx += 1
    return plan


class RepVGG(nn.Module):
    """`layers[i]`: a 3×3 conv (weight OIHW, bias) with its `stride` and
    `groups`, as the JAX tree {"layers": [{"w", "b", "stride", "groups"}]}
    holds them; random weights N(0, 2/fan_in) and zero biases from `seed`,
    as JAX `init` draws them."""

    def __init__(self, cfg: RepVGGConfig = REPVGG_B1G2, *, device=None, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.layers = nn.ModuleList(nn.Conv2d(cin, cout, 3, stride=s, padding=1, groups=g, device=device, dtype=dtype)
                                    for cin, cout, s, g in _layer_plan(cfg))
        g = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for conv in self.layers:
                fan = conv.weight[0].numel()
                conv.weight.normal_(0.0, (2.0 / fan) ** 0.5, generator=g)
                conv.bias.zero_()

    @property
    def out_features(self) -> int:
        return self.layers[-1].out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, C) fp32 global-average-pooled features."""
        x = x.permute(0, 3, 1, 2)
        for conv in self.layers:
            x = F.relu(F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), stride=conv.stride, padding=1,
                                groups=conv.groups))
        return x.float().mean(dim=(2, 3))


def fuse_branches(
    w3: np.ndarray, bn3: Dict, w1: Optional[np.ndarray], bn1: Optional[Dict],
    bnid: Optional[Dict], groups: int = 1, eps: float = 1e-5,
) -> tuple:
    """Fold RepVGG's train-time branches into one 3×3 conv (OIHW in and
    out): conv3x3 + BN ⊕ conv1x1 + BN (padded) ⊕ identity BN as a conv."""

    def fuse(w, bn):
        std = np.sqrt(bn["var"] + eps)
        scale = bn["g"] / std
        return w * scale[:, None, None, None], bn["b"] - bn["mean"] * scale

    wsum, bsum = fuse(w3, bn3)
    if w1 is not None:
        wf, bf = fuse(np.pad(w1, ((0, 0), (0, 0), (1, 1), (1, 1))), bn1)
        wsum, bsum = wsum + wf, bsum + bf
    if bnid is not None:
        cout, cin_g = w3.shape[:2]
        wid = np.zeros_like(w3)
        for i in range(cout):
            wid[i, i % cin_g, 1, 1] = 1.0
        wf, bf = fuse(wid, bnid)
        wsum, bsum = wsum + wf, bsum + bf
    return wsum, bsum
