"""Opt-in w8a8 int8 inference quantization (port of
`faceposegenerator_tpu/ops/quant.py:74-458`).

A quantized layer keeps its `nn.Linear` / `nn.Conv2d` module, and its
`weight` parameter is replaced by a `QuantizedWeight`: `q` int8 in the
layer's own orientation ((out, in) for a dense, OIHW for a conv), `s` fp32
per output channel and an optional static activation scale `a`. The two
matmul primitives dispatch on it: `ops.lora.lora_dense` → `qdense`,
`models.layers.conv2d` → `qconv2d`. Biases, norms and LoRA deltas stay in
the compute dtype.

  - weights: symmetric per-out-channel int8, s = max|w| / 127;
  - activations: symmetric int8 with a dynamic scale (per row for a dense,
    per sample over H, W and C for a conv) or a calibrated static
    per-tensor scale `a`;
  - int32 accumulation, fp32 rescale, cast to the activation dtype.

Every int8 dense runs kernel K7 (`ops.qdense`, csrc/qdense.cu) on the card.
The JAX package runs its convs in XLA outside any Pallas kernel; PyTorch has
no int8 convolution on CUDA, so `qconv2d` runs cuDNN on integer-valued fp32
codes with TF32 allowed: the codes need 7 mantissa bits, TF32 keeps 10, and
the products accumulate in fp32, so the sum is the int32 sum wherever
|sum| < 2²⁴ (bf16 codes would round the conv's output to 8 bits before the
rescale). On the CPU the codes convolve in float64, exact always.

Calibration (`observe_act_scales`, `freeze_act_scales`) keys its records on
the `QuantizedWeight` object, not on execution order, so a DeepCache
partial pass or a cond-only segment observes whatever sites it runs. Over a
mesh, `replicate_act_scales` gives every rank rank 0's static scales, so
that every rank runs the same codes.
"""

from __future__ import annotations

import contextlib
import json
import logging
from typing import Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .qdense import qdense_kernel, quantize

_EPS = 1e-8

# shallow, tiny or range-critical layers stay in the compute dtype (quant.py:256-271)
UNET_SKIP = ("conv_in", "conv_out", "time_embedding", "time_emb_proj")
VAE_SKIP = ("encoder", "quant_conv", "post_quant_conv", "attn", "conv_in", "conv_out")
# IResNet: the stem, the fc head and the SE gates stay out of int8. ("conv1",)
# is an exact path: it skips the top-level stem only, not the blocks' conv1.
IRESNET_SKIP = (("conv1",), "fc", "se_fc1", "se_fc2")


class QuantizedWeight(nn.Module):
    """q: int8 in the layer's orientation; s: fp32 (out,); a: None (dynamic
    activation scales) or a static per-tensor scale, an fp32 value held as a
    Python float so the kernel takes it without a device read."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, a: Optional[float] = None):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)
        self.a = None if a is None else float(np.float32(a))

    @property
    def shape(self):
        return self.q.shape

    def compile_key(self):
        """The static scale, a host number a captured graph bakes in
        (`core.compile.module_fingerprint`)."""
        return self.a


def is_quantized(w) -> bool:
    return isinstance(w, QuantizedWeight)


@torch.no_grad()
def quantize_weight(w: torch.Tensor, act_scale: Optional[float] = None) -> QuantizedWeight:
    """Symmetric per-out-channel int8 (axis 0 in torch orientation):
    q = round(w / s) clipped to ±127, s = max(|w|, 1e-8) / 127 in fp32."""
    wf = w.float()
    s = wf.abs().amax(dim=tuple(range(1, wf.dim())), keepdim=True).clamp_min(_EPS)
    s = s / s.new_full((), 127.0)  # a true division, as JAX's eager quantize (not s · INV127)
    q = torch.round(wf / s).clamp_(-127, 127).to(torch.int8)
    return QuantizedWeight(q, s.reshape(-1).contiguous(), act_scale)


# calibration side channel: QuantizedWeight → running activation amax (a
# 0-d fp32 tensor on the device, so observing never waits on the card)
_CALIB: Optional[dict] = None


def _observe(w: QuantizedWeight, x: torch.Tensor) -> None:
    if _CALIB is not None:
        amax = x.detach().abs().amax().float()
        prev = _CALIB.get(w)
        _CALIB[w] = amax if prev is None else torch.maximum(prev, amax)


def qdense(x: torch.Tensor, w: QuantizedWeight) -> torch.Tensor:
    """x·Wᵀ over a quantized weight, in x's dtype (the caller adds the bias)."""
    _observe(w, x)
    return qdense_kernel(x, w.q, w.s, w.a)


def qdense_fused(x: torch.Tensor, ws: list) -> torch.Tensor:
    """One GEMM over the concatenated (out, in) weights of the fused q/k/v
    projection. Static scales: the members share x, so the max of their
    `a` quantizes it (quant.py:189-206); calibration observes each member."""
    for w in ws:
        _observe(w, x)
    q = torch.cat([w.q for w in ws])
    s = torch.cat([w.s for w in ws])
    a = max(w.a for w in ws) if all(w.a is not None for w in ws) else None
    return qdense_kernel(x, q, s, a)


def _int_conv(codes: torch.Tensor, wq: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """NHWC integer-valued fp32 codes ⊛ int8 OIHW weight codes → the fp32
    integer sums, NHWC (see the module docstring for why this is exact)."""
    x = codes.permute(0, 3, 1, 2)
    if codes.is_cuda:
        cudnn = torch.backends.cudnn
        prev, cudnn.allow_tf32 = cudnn.allow_tf32, True
        try:
            y = F.conv2d(x, wq.to(torch.float32), stride=stride, padding=padding)
        finally:
            cudnn.allow_tf32 = prev
    else:
        y = F.conv2d(x.double(), wq.double(), stride=stride, padding=padding).float()
    return y.permute(0, 2, 3, 1)


def qconv2d(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """NHWC conv over a quantized weight (quant.py:209-249): per-sample
    dynamic activation scales (amax over H, W, C) or the static `a`; the
    rescale acc·sx·s in fp32, cast to x's dtype, then the bias added in x's
    dtype (not in the conv's epilogue, which would change the rounding).
    1×1 kernels keep the conv form, as QUANT_CONV1X1="conv" does in JAX."""
    w = conv.weight
    _observe(w, x)
    codes, sx = quantize(x, (1, 2, 3), w.a)
    y = _int_conv(codes, w.q, stride, padding)
    y = y.mul_(sx).mul_(w.s).to(x.dtype)
    return y.add_(conv.bias.to(x.dtype))


# ---------------------------------------------------------------------------
# module transforms
# ---------------------------------------------------------------------------


def _skipped(path: tuple, skip) -> bool:
    """A string entry matches any path component; a tuple entry matches the
    exact path of the layer (quant.py:274-283). List indices are not path
    components, as in JAX `quantize_tree`."""
    for entry in skip:
        if isinstance(entry, tuple):
            if path == entry:
                return True
        elif entry in path:
            return True
    return False


def _site_path(name: str) -> str:
    """The JAX tree path of a layer's weight leaf, as `save_act_scales`
    writes it: module names are the JAX tree keys, plus the leaf "w"."""
    return "/".join(name.split(".") + ["w"])


def quantize_module(module: nn.Module, skip=(), act_scale: Optional[float] = None) -> list:
    """Replace the weight of every nn.Linear and nn.Conv2d outside `skip`
    with its int8 form, in place; returns the quantized site paths."""
    sites = []
    for name, m in list(module.named_modules()):
        if not isinstance(m, (nn.Linear, nn.Conv2d)) or not isinstance(m.weight, nn.Parameter):
            continue
        if _skipped(tuple(c for c in name.split(".") if not c.isdigit()), skip):
            continue
        qw = quantize_weight(m.weight, act_scale)
        del m.weight  # a registered parameter cannot be reassigned a module
        m.weight = qw
        sites.append(_site_path(name))
    return sites


def quantize_unet(unet: nn.Module, act_scale: Optional[float] = None) -> list:
    """w8a8 UNet: every resnet, attention, GEGLU and resample weight."""
    return quantize_module(unet, UNET_SKIP, act_scale)


def quantize_iresnet(model: nn.Module, act_scale: Optional[float] = None) -> list:
    """w8a8 IResNet body for the embed path (quant.py:319-321): every block
    conv and shortcut; their convs run `qconv2d`."""
    return quantize_module(model, IRESNET_SKIP, act_scale)


def quantize_vae(vae: nn.Module, act_scale: Optional[float] = None) -> list:
    """w8a8 VAE decoder body: its resblock and upsample convs (VAE_SKIP)."""
    return quantize_module(vae, VAE_SKIP, act_scale)


def quantized_sites(modules: Union[nn.Module, dict]) -> dict:
    """{site path: QuantizedWeight}; a dict of modules prefixes each path
    with its key ("unet/…", "vae/…")."""
    if isinstance(modules, dict):
        return {f"{key}/{path}": w for key, mod in modules.items() for path, w in quantized_sites(mod).items()}
    return {_site_path(name[: -len(".weight")]): m for name, m in modules.named_modules()
            if isinstance(m, QuantizedWeight)}


# ---------------------------------------------------------------------------
# static-activation-scale calibration
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def observe_act_scales():
    """Record each quantized site's activation amax during forward passes:

        quantize_unet(unet)
        with observe_act_scales() as calib:
            unet(...)
        freeze_act_scales(unet, calib)
    """
    global _CALIB
    if _CALIB is not None:
        raise RuntimeError("observe_act_scales is not reentrant")
    _CALIB = {}
    try:
        yield _CALIB
    finally:
        _CALIB = None


def freeze_act_scales(modules, calib: dict, margin: float = 1.0) -> list:
    """Set each observed site's static scale to max(amax·margin, 1e-8)/127
    (in double, then fp32, as JAX does), in place. Sites never observed keep
    dynamic scales and are reported; returns their paths."""
    missed = []
    for path, w in quantized_sites(modules).items():
        amax = calib.get(w)
        amax = None if amax is None else float(amax)
        if amax is None or amax <= 0.0:
            missed.append(path)
            continue
        w.a = float(np.float32(max(amax * margin, _EPS) / 127.0))
    if missed:
        logging.getLogger(__name__).warning(
            "freeze_act_scales: %d quantized sites were never observed and stay dynamic: %s",
            len(missed), missed[:8])
    return missed


def save_act_scales(modules, path: str) -> int:
    """Write the static scales as JSON keyed by tree path (the JAX
    package's file format); returns the number of sites saved."""
    scales = {p: w.a for p, w in quantized_sites(modules).items() if w.a is not None}
    with open(path, "w") as f:
        json.dump(scales, f, indent=1, sort_keys=True)
    return len(scales)


def load_act_scales(modules, path: str) -> None:
    """Attach saved static scales, in place. A saved path that matches no
    quantized site raises (layout drift); sites absent from the file stay
    dynamic."""
    with open(path) as f:
        scales = dict(json.load(f))
    sites = quantized_sites(modules)
    unused = sorted(set(scales) - set(sites))
    if unused:
        raise ValueError(f"{len(unused)} saved act scales matched no quantized site "
                         f"(tree layout drift?): {unused[:5]}")
    for p, a in scales.items():
        sites[p].a = float(np.float32(a))


def replicate_act_scales(mesh, modules) -> None:
    """Rank 0's static activation scales (None: dynamic) on every rank of
    `mesh`, in place: one float64 broadcast over the sites in path order.
    The sites must be the same on every rank (every rank quantized)."""
    from ..core.mesh import broadcast_

    sites = quantized_sites(modules)
    if mesh.size == 1 or not sites:  # every rank quantized alike, or none did
        return
    paths = sorted(sites)
    t = torch.tensor([np.nan if sites[p].a is None else sites[p].a for p in paths], dtype=torch.float64,
                     device=mesh.device)
    for p, a in zip(paths, broadcast_(mesh, t).tolist()):
        sites[p].a = None if np.isnan(a) else float(np.float32(a))
