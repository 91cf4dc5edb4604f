"""Building blocks shared by the port's models: parameter holders whose
attribute names follow the JAX param trees (so `bridge.jax_params` is a
plain walk), the channels-last conv, and seeded random initialisation."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops.norms import batch_norm_inference
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
    return conv_nhwc(x, conv.weight, conv.bias, stride=stride, padding=padding)


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


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias=None, stride: int = 1, padding=0,
              groups: int = 1) -> torch.Tensor:
    """NHWC in and out around `F.conv2d` with an OIHW weight (cast to x's
    dtype); `padding` an int or (pad_h, pad_w), applied on both sides."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                 stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def pool_nhwc(x: torch.Tensor, kind: str, k: int, s: int, padding: int = 0) -> torch.Tensor:
    """Max pooling (padding at -inf), or average pooling that excludes the
    zero padding from its counts (TF / pytorch-fid semantics)."""
    y = x.permute(0, 3, 1, 2)
    if kind == "max":
        y = F.max_pool2d(y, k, s, padding)
    else:
        y = F.avg_pool2d(y, k, s, padding, count_include_pad=False)
    return y.permute(0, 2, 3, 1)


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm from running statistics (JAX leaves "g", "b",
    "mean", "var"), folded to one fp32 scale and shift (`ops.norms`)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.mean = nn.Parameter(torch.empty(c))
        self.var = nn.Parameter(torch.empty(c))

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return batch_norm_inference(x, self.weight, self.bias, self.mean, self.var, eps)


@torch.no_grad()
def he_init(module: nn.Module, generator) -> nn.Module:
    """The JAX CNN encoders' random init (inception_v3.py, resnet50.py,
    simclr_resnet.py `init`): every 4-D weight N(0, 2/fan_in), every
    FrozenBatchNorm the identity (1, 0, 0, 1)."""
    for m in module.modules():
        if isinstance(m, FrozenBatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.mean.zero_()
            m.var.fill_(1.0)
    for p in module.parameters():
        if p.dim() == 4:
            p.normal_(0.0, (2.0 / p[0].numel()) ** 0.5, generator=generator)
    return module


def split_conv_bn(tree):
    """A JAX conv+BN unit {"w", "g", "b", "mean", "var"} as {"conv": {"w"},
    "bn": {"g", "b", "mean", "var"}}, recursively: the layout of the port's
    ConvBN modules, where the JAX unit's two weights ("w" and "g") would
    both name `weight`."""
    if isinstance(tree, dict):
        if set(tree) == {"w", "g", "b", "mean", "var"}:
            return {"conv": {"w": tree["w"]}, "bn": {k: tree[k] for k in ("g", "b", "mean", "var")}}
        return {k: split_conv_bn(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [split_conv_bn(v) for v in tree]
    return tree


class ConvBN(nn.Module):
    """A bias-free conv and its inference BatchNorm (one JAX unit)."""

    def __init__(self, cin: int, cout: int, kernel):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, bias=False)
        self.bn = FrozenBatchNorm(cout)

    def forward(self, x, eps: float, stride: int = 1, padding=0, relu: bool = True):
        y = self.bn(conv_nhwc(x, self.conv.weight, stride=stride, padding=padding), eps)
        return F.relu(y) if relu else y
