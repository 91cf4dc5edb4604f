"""K4: conv3x3(SiLU(GroupNorm(x))) + bias for the card, its launch count,
its plain PyTorch version and the autograd Function that joins them (port of
`faceposegenerator_tpu/ops/fused_gn_conv.py`: `_kernel` :92, via `_call`
:128 and `gn_silu_conv3x3` :163, statistics from `group_scale_shift` :73).

    a = round_to_x_dtype(SiLU(x·scale + shift))      (the GroupNorm affine of K3)
    y = round_to_x_dtype(conv3x3(pad0(a), w) + b)

The padding comes after the activation (`_zero_slab`, :99-101): a border
tap reads 0, not SiLU(shift). w is cast to x's dtype, b is added in fp32.
`GN_CONV_IMPL=pallas` (read at import, as in JAX; `gn_conv_impl()`) makes
the UNet's resblocks send each `conv(silu(gn(x)))` that `supported` accepts
here (`models.unet2d._gn_silu_conv`). A CPU tensor goes to
`gn_silu_conv3x3_plain`; a CUDA tensor goes to the kernel (csrc/gn_conv.cu:
`gn_silu_conv3x3` for bf16 x and weight, `gn_silu_conv3x3_f32` for fp32
ones, as JAX's kernel keeps its slab in x's dtype) or raises. The fp32
kernel runs in 3xTF32 on the tensor cores and reads the weight as tf32 hi
and lo planes, which `gn_conv_f32_split` writes first (one more launch per
fp32 call; `weight_split_plain` is its plain version). The wrappers add one
to `LAUNCHES[name]` where they launch kernel `name`, and nowhere else; the
conv launch also adds its 2·N·H·W·9·Cin·Cout FLOPs to
`core.flops.count_kernel`.

When a gradient is taken through any operand, `GNSiLUConv3x3` runs the
kernel forward and recomputes the backward with autograd through the plain
GroupNorm+SiLU and `F.conv2d`, as the JAX custom_vjp recomputes `_reference`
(:180-204), but without dispatching again.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.flops import count_kernel
from . import _build
from .flash_attention import tf32_split_plain
from .fused_gn import check_stats_operands, group_scale_shift, recompute_grads, stats_split

_IMPL = os.environ.get("GN_CONV_IMPL", "xla")  # xla | pallas
_MAX_C = 640
_ROWS_PER_CHUNK = int(os.environ.get("GN_CONV_ROWS", "8"))  # image rows / chunk
# the kernels' tile of output pixels: a power-of-two width TW of
# _TILE_PIXELS / TW image rows
_TILE_PIXELS = 128
LAUNCHES = {"gn_silu_conv3x3": 0, "gn_silu_conv3x3_f32": 0, "gn_conv_f32_split": 0}
_fns: dict = {}


def gn_conv_impl() -> str:
    return _IMPL


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supported(n: int, h: int, w: int, cin: int, cout: int, num_groups: int) -> bool:
    """The JAX predicate (fused_gn_conv.py:58-71) copied as it is, so that
    both packages route the same ops: its limits are the TPU's VMEM budget."""
    if cin > _MAX_C or cout > _MAX_C or cin % num_groups:
        return False
    hr = min(h, _ROWS_PER_CHUNK)
    if h % hr:
        return False
    # slab + weights + acc must fit scoped VMEM comfortably
    slab = (h + 2) * (w + 2) * cin * 2
    wts = 9 * cin * cout * 2
    acc = hr * w * cout * 4
    return slab + wts + acc < 12 * 1024 * 1024


def _silu_activation(x, gamma, beta, num_groups, eps):
    """round_to_x_dtype(SiLU(x·scale + shift)), NHWC."""
    n, c = x.shape[0], x.shape[-1]
    scale, shift = group_scale_shift(x, gamma, beta, num_groups, eps)
    a = torch.addcmul(shift[:, None], x.reshape(n, -1, c).float(), scale[:, None])
    return F.silu(a).to(x.dtype).reshape(x.shape)


def gn_silu_conv3x3_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """K4's function in plain PyTorch: x (N, H, W, Cin) NHWC, weight (Cout,
    Cin, 3, 3), bias (Cout,); the activation rounded to x's dtype, the conv
    of it with the weight in x's dtype accumulated in fp32 (TF32 off on the
    card: cuDNN would otherwise round the operands to 10 bits), the fp32
    bias added and the sum rounded once to x's dtype."""
    a = _silu_activation(x, gamma, beta, num_groups, eps).permute(0, 3, 1, 2).float()
    w = weight.to(x.dtype).float()
    cudnn = torch.backends.cudnn
    prev, cudnn.allow_tf32 = cudnn.allow_tf32, False
    try:
        y = F.conv2d(a, w, bias.float(), padding=1)
    finally:
        cudnn.allow_tf32 = prev
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _reference(x, gamma, beta, weight, bias, num_groups, eps):
    """What the backward differentiates: the plain GroupNorm+SiLU and conv
    in x's dtype (`_reference`, fused_gn_conv.py:180-185)."""
    a = _silu_activation(x, gamma, beta, num_groups, eps)
    y = F.conv2d(a.permute(0, 3, 1, 2), weight.to(x.dtype), bias.to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1)


_P, _I = ctypes.c_void_p, ctypes.c_int
_CONV_ARGS = [_P] * 8 + [_I] * 6 + [ctypes.c_float] + [_I] * 5 + [_P]
_ARGTYPES = {  # the C signatures in csrc/gn_conv.cu
    "gn_silu_conv3x3": _CONV_ARGS, "gn_silu_conv3x3_f32": _CONV_ARGS, "gn_conv_f32_split": [_P, _P, _I, _P],
}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = _build.kernel(name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def tile_width(w: int) -> int:
    """The kernels' tile width: the power of two ≥ W, in [2, 64] (their
    shared memory holds the halo of 128 pixels at these widths)."""
    return min(64, max(2, 1 << max(0, (w - 1).bit_length())))


def weight_split_plain(weight: torch.Tensor) -> torch.Tensor:
    """`gn_conv_f32_split`'s output in plain PyTorch: the tf32 hi and lo
    planes (`tf32_split_plain`) of a (Cout, Cin, 3, 3) fp32 weight in its
    channels_last memory order, (2, Cout, 3, 3, Cin) contiguous: the
    (Cin, 9, Cout, 2) tensor map of the fp32 kernel, innermost first."""
    return torch.stack(tf32_split_plain(weight.float().permute(0, 2, 3, 1)))


def weight_split(weight: torch.Tensor) -> torch.Tensor:
    """`weight_split_plain` on the card in one `gn_conv_f32_split` launch
    (a channels_last fp32 weight); for a CPU tensor, the plain version."""
    if not weight.is_cuda:
        return weight_split_plain(weight)
    if weight.dtype != torch.float32 or not weight.is_contiguous(memory_format=torch.channels_last) \
            or weight.data_ptr() % 16 or weight.numel() % 4:
        raise ValueError(f"gn_conv_f32_split takes a 16-byte aligned fp32 channels_last weight of 4·k values, "
                         f"got {weight.dtype} {tuple(weight.shape)} strides {weight.stride()}")
    cout, cin = weight.shape[:2]
    out = torch.empty((2, cout, 3, 3, cin), dtype=torch.float32, device=weight.device)
    if weight.numel():
        err = _kernel("gn_conv_f32_split")(weight.data_ptr(), out.data_ptr(), weight.numel(),
                                           torch.cuda.current_stream(weight.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"gn_conv_f32_split launch failed: CUDA error {err}")
        LAUNCHES["gn_conv_f32_split"] += 1
    return out


def _forward(x, gamma, beta, weight, bias, num_groups, eps):
    if not x.is_cuda:
        return gn_silu_conv3x3_plain(x, gamma, beta, weight, bias, num_groups, eps)
    check_stats_operands(x, gamma, beta, num_groups, (torch.bfloat16, torch.float32), "gn_silu_conv3x3")
    name = "gn_silu_conv3x3_f32" if x.dtype == torch.float32 else "gn_silu_conv3x3"
    n, h, w, cin = x.shape
    cout = weight.shape[0]
    if weight.dtype != x.dtype or weight.shape != (cout, cin, 3, 3) \
            or not weight.is_contiguous(memory_format=torch.channels_last) or weight.data_ptr() % 16:
        raise ValueError(f"{name} takes a (Cout, Cin, 3, 3) weight of x's dtype ({x.dtype}) stored channels_last, "
                         f"got {weight.dtype} {tuple(weight.shape)} strides {weight.stride()}")
    if bias.shape != (cout,) or bias.dtype not in (torch.float32, torch.bfloat16) or not bias.is_contiguous():
        raise ValueError("gn_silu_conv3x3 takes a contiguous fp32 or bf16 (Cout,) bias")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("gn_silu_conv3x3: every tensor must lie on one CUDA device")
    if cout % 8:
        raise ValueError(f"gn_silu_conv3x3 takes Cout % 8 == 0, got {cout}")
    tw = tile_width(w)
    tiles = n * -(-h // (_TILE_PIXELS // tw)) * -(-w // tw)
    if tiles > 65535 or n * h * w * max(cin, cout) > 2**31 - 1:
        raise ValueError(f"gn_silu_conv3x3: {tuple(x.shape)} exceeds the kernel's grid or int32 indexing")
    x = x.contiguous()
    rows, chunks = stats_split(n, h * w, cin, x.element_size())
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    part = torch.empty(2 * n * chunks * cin, dtype=torch.float32, device=x.device)
    affine = torch.empty(2 * n * cin, dtype=torch.float32, device=x.device)
    if y.numel():
        # the fp32 kernel reads the weight's tf32 hi/lo planes
        wt = weight_split(weight) if name == "gn_silu_conv3x3_f32" else weight
        err = _kernel(name)(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                        y.data_ptr(), part.data_ptr(), affine.data_ptr(), n, h, w, cin, cout, num_groups,
                        float(eps), rows, chunks, int(gamma.dtype == torch.bfloat16),
                        int(bias.dtype == torch.bfloat16), tw.bit_length() - 1,
                        torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        LAUNCHES[name] += 1
        count_kernel(name, 2.0 * n * h * w * 9 * cin * cout)
    return y


class GNSiLUConv3x3(torch.autograd.Function):
    """K4 forward; the backward recomputes `_reference` with autograd."""

    @staticmethod
    def forward(ctx, x, gamma, beta, weight, bias, num_groups, eps):
        ctx.save_for_backward(x, gamma, beta, weight, bias)
        ctx.args = (num_groups, eps)
        return _forward(x, gamma, beta, weight, bias, num_groups, eps)

    @staticmethod
    def backward(ctx, grad):
        return (*recompute_grads(_reference, ctx, grad), None, None)


def gn_silu_conv3x3(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, conv: nn.Conv2d,
                    num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """conv(silu(group_norm(x))) on K4 for NHWC x and a biased 3×3 `conv`,
    at stride 1 and padding 1 (the port's convs take both from the caller,
    `models.layers.conv2d`); see the module docstring. The caller has
    checked `supported`, as in JAX."""
    if conv.kernel_size != (3, 3) or conv.dilation != (1, 1) or conv.groups != 1 or conv.bias is None:
        raise ValueError(f"gn_silu_conv3x3 takes a biased, ungrouped, undilated 3×3 conv, got {conv}")
    args = (x, gamma, beta, conv.weight, conv.bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return GNSiLUConv3x3.apply(*args, num_groups, eps)
    return _forward(*args, num_groups, eps)
