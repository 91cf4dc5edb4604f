"""DINOv2 vision transformer (port of `faceposegenerator_tpu/models/dinov2.py`).

The dgm-eval headline encoder: DINOv2 ViT-L/14 on 224² bicubic-resized,
imagenet-normalized images, feature = the final-LayerNorm CLS token (1024-d;
`Evaluation/dgm-eval/dgm_eval/models/dinov2.py:31-59`). The same module with
`layerscale=False` is the MAE ViT-L/16.

Architecture (ViT + LayerScale, pre-norm): patch-embed conv (stride = patch)
→ prepend CLS → + position embeddings (bicubic-resized to the input grid when
it differs from the trained one) → N × [x += ls1·MHA(LN(x)); x += ls2·MLP(LN(x))]
→ final LN. Input (B, H, W, 3) channels-last as in JAX; the body runs in the
policy's compute dtype with fp32 LayerNorm statistics.

Attention goes through `ops.attention.dot_product_attention`: head dim 64 in
bf16 is K1 on the card (`flash_fwd_d64`), and under a gradient (GradCAM,
`make_heatmap_fn`) K1 with the log-sum-exp then K5. At 224² the sequence is
257 tokens (ViT-L/14) or 197 (MAE ViT-L/16).

The position-embedding resize reproduces `jax.image.resize(method="bicubic")`
exactly: Keys' cubic with a = -0.5, half-pixel centres, and, when it
downsamples (37×37 → 16×16 at 224²), the kernel stretched by in/out
(antialias) with each output's weights normalised to sum to 1. That is not
`F.interpolate(mode="bicubic")` (a = -0.75, no antialias), so the separable
weight matrix is built in numpy (`bicubic_resize_matrix`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.precision import DEFAULT_POLICY, Policy
from ..ops.attention import dot_product_attention
from ..ops.lora import lora_dense
from ..ops.norms import layer_norm
from .layers import Affine, materialize


@dataclasses.dataclass(frozen=True)
class DINOv2Config:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 14
    image_size: int = 518  # training resolution → 37×37 pos-embed grid
    layer_norm_eps: float = 1e-6
    layerscale: bool = True  # False = plain timm ViT (MAE, DeiT)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


VITL14_CONFIG = DINOv2Config()
VITB14_CONFIG = DINOv2Config(hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072)
VITS14_CONFIG = DINOv2Config(hidden_size=384, num_layers=12, num_heads=6, intermediate_size=1536)
# plain timm ViT-L/16, the MAE encoder (`dgm_eval/models/mae.py:34-70`)
MAE_VITL16_CONFIG = DINOv2Config(patch_size=16, image_size=224, layerscale=False)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 at |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=16)
def bicubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of `jax.image.resize(method="bicubic")` along one
    axis (jax/_src/image/scale.py `compute_weight_mat`, antialias on), in
    float64. Cached: callers must not write to it."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)  # stretch the kernel only when downsampling
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    w = _keys_cubic(np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale)  # (n_in, n_out)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T


def interpolate_pos_embed(pos: torch.Tensor, grid: int) -> torch.Tensor:
    """Bicubic-resize the patch position embeddings (1, 1+src², D) to a
    grid×grid layout in fp32 (the CLS position passes through); an exact
    no-op when the sizes match (dinov2.py:108-121)."""
    src = int(round((pos.shape[1] - 1) ** 0.5))
    if src == grid:
        return pos
    w = torch.from_numpy(bicubic_resize_matrix(src, grid)).to(device=pos.device, dtype=torch.float32)
    patch = pos[0, 1:].float().reshape(src, src, -1)
    patch = torch.einsum("ai,bj,ijd->abd", w, w, patch).reshape(1, grid * grid, -1)
    return torch.cat([pos[:, :1], patch.to(pos.dtype)], dim=1)


class DINOv2Layer(nn.Module):
    def __init__(self, d: int, m: int, layerscale: bool):
        super().__init__()
        self.norm1 = Affine(d)
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)
        self.norm2 = Affine(d)
        self.fc1 = nn.Linear(d, m)
        self.fc2 = nn.Linear(m, d)
        if layerscale:
            self.ls1 = nn.Parameter(torch.empty(d))
            self.ls2 = nn.Parameter(torch.empty(d))
        else:
            self.ls1 = self.ls2 = None


def vit_attention(layer, hn: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Multi-head self-attention of one pre-norm ViT layer (q, k, v, out
    Linears) through `dot_product_attention`."""
    b, s, d = hn.shape
    q, k, v = (lora_dense(hn, lin.weight, lin.bias).reshape(b, s, num_heads, d // num_heads)
               for lin in (layer.q, layer.k, layer.v))
    o = dot_product_attention(q, k, v).reshape(b, s, d)
    return lora_dense(o, layer.out.weight, layer.out.bias)


def embed_patches(images: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], patch: int):
    """(B, H, W, 3) → (B, (H/p)·(W/p), D) tokens, row-major as JAX flattens."""
    x = F.conv2d(images.permute(0, 3, 1, 2), weight.to(images.dtype),
                 None if bias is None else bias.to(images.dtype), stride=patch)
    return x.flatten(2).transpose(1, 2)


class DINOv2(nn.Module):
    """A frozen evaluation encoder: its parameters take no gradient (GradCAM
    differentiates through it with respect to an activation or the input).
    Attribute names follow the JAX param tree."""

    def __init__(self, cfg: DINOv2Config = VITL14_CONFIG, *, device=None, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        device = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        with torch.device("meta"):
            self.patch_embed = nn.Conv2d(3, d, cfg.patch_size)
            self.cls_token = nn.Parameter(torch.empty(1, 1, d))
            self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches + 1, d))
            self.layers = nn.ModuleList(DINOv2Layer(d, cfg.intermediate_size, cfg.layerscale)
                                        for _ in range(cfg.num_layers))
            self.final_norm = Affine(d)
        materialize(self, device, dtype, torch.Generator(device=device).manual_seed(seed))
        with torch.no_grad():  # LayerScale starts at 1 (dinov2.py:88-90)
            for layer in self.layers:
                if layer.ls1 is not None:
                    layer.ls1.fill_(1.0)
                    layer.ls2.fill_(1.0)
        self.requires_grad_(False)

    def forward(self, images: torch.Tensor, policy: Policy = DEFAULT_POLICY,
                tap: Optional[Callable] = None) -> torch.Tensor:
        """images (B, H, W, 3) imagenet-normalized, H = W divisible by the
        patch → the final-LN hidden states (B, 1+N, D) in the compute dtype.
        `tap` is applied to the last layer's norm1 output (the reference
        GradCAM target 'blocks.23.norm1')."""
        cfg = self.cfg
        x = images.to(policy.compute_dtype)
        b, h = x.shape[:2]
        grid = h // cfg.patch_size
        x = embed_patches(x, self.patch_embed.weight, self.patch_embed.bias, cfg.patch_size)
        cls = self.cls_token.to(x.dtype).expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + interpolate_pos_embed(self.pos_embed, grid).to(x.dtype)
        last = len(self.layers) - 1
        for li, layer in enumerate(self.layers):
            hn = layer_norm(x, layer.norm1.weight, layer.norm1.bias, cfg.layer_norm_eps)
            if tap is not None and li == last:
                hn = tap(hn)
            o = vit_attention(layer, hn, cfg.num_heads)
            x = x + (layer.ls1.to(o.dtype) * o if layer.ls1 is not None else o)
            hn = layer_norm(x, layer.norm2.weight, layer.norm2.bias, cfg.layer_norm_eps)
            ff = lora_dense(F.gelu(lora_dense(hn, layer.fc1.weight, layer.fc1.bias)),
                            layer.fc2.weight, layer.fc2.bias)
            x = x + (layer.ls2.to(ff.dtype) * ff if layer.ls2 is not None else ff)
        return layer_norm(x, self.final_norm.weight, self.final_norm.bias, cfg.layer_norm_eps)

    def cls_feature(self, images: torch.Tensor, policy: Policy = DEFAULT_POLICY,
                    tap: Optional[Callable] = None) -> torch.Tensor:
        """The dgm-eval representation: the final-LN CLS token, fp32 (hub
        `forward` ≡ transformers `pooler_output`)."""
        return self(images, policy, tap=tap)[:, 0].float()
