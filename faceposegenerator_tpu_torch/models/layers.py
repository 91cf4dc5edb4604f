"""Building blocks shared by the port's models: parameter holders whose
attribute names follow the JAX param trees (so `bridge.jax_params` is a
plain walk), the channels-last conv, and seeded random initialisation."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops.quant import is_quantized, qconv2d


class Affine(nn.Module):
    """GroupNorm / LayerNorm scale and shift (JAX leaves "g" and "b")."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))


def conv2d(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """NHWC in and out. The NCHW view of a contiguous NHWC tensor is
    channels_last, which is what cuDNN wants; no copy is made either way. A
    quantized layer goes to `qconv2d` (unet2d.py:64-72)."""
    if is_quantized(conv.weight):
        return qconv2d(x, conv, stride=stride, padding=padding)
    y = F.conv2d(
        x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), conv.bias.to(x.dtype),
        stride=stride, padding=padding,
    )
    return y.permute(0, 2, 3, 1)


@torch.no_grad()
def materialize(module: nn.Module, device, dtype: torch.dtype, generator) -> nn.Module:
    """Allocate a module built on the meta device on `device` and fill it
    with seeded random weights (uniform ±1/√fan_in for dense and conv layers,
    ones/zeros for norms, N(0, 0.02²) for free parameters such as
    embeddings), in `dtype`. Convolution weights are kept channels_last."""
    device = resolve_device(device)
    module.to_empty(device=device)
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            bound = fan_in**-0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, Affine):
            m.weight.fill_(1.0)
            m.bias.zero_()
        else:
            for p in m.parameters(recurse=False):
                p.normal_(0.0, 0.02, generator=generator)
    module.to(dtype)
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.data = m.weight.data.contiguous(memory_format=torch.channels_last)
    return module
