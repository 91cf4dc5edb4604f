"""Face Vision Transformer embedder (port of
`faceposegenerator_tpu/models/vit_face.py`).

112² input, 9×9 patch embed (stride = patch → 12×12 = 144 tokens, no cls
token), learned positional embeddings, pre-LN transformer blocks with
ReLU6 MLPs, and the feature head Linear(embed·patches → embed, no bias) →
BN1d(eps 2e-5) → Linear(embed → num_features, no bias) → BN1d. Attention is
the plain matmul–softmax–matmul of the JAX einsums (fp32 logits and
accumulation, the weights cast back to the compute dtype). Training-time
masking replaces a random `mask_ratio` of each sample's tokens with the
learned mask token, from a generator or an explicit (B, N) mask.

Registry: vit_t/s (dim 256/512, depth 12), vit_b (512, 24), vit_l (768, 24),
8 heads, mask ratios 0.1/0.05.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.precision import DEFAULT_POLICY, Policy
from ..ops.norms import batch_norm_inference, layer_norm
from .iresnet import BatchNorm
from .layers import Affine, materialize


@dataclasses.dataclass(frozen=True)
class FaceViTConfig:
    img_size: int = 112
    patch_size: int = 9
    embed_dim: int = 256
    depth: int = 12
    num_heads: int = 8
    mlp_ratio: float = 4.0
    num_features: int = 512
    mask_ratio: float = 0.1
    bn_eps: float = 2e-5

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2


VIT_CONFIGS = {
    "vit_t": FaceViTConfig(embed_dim=256, depth=12, mask_ratio=0.1),
    "vit_s": FaceViTConfig(embed_dim=512, depth=12, mask_ratio=0.1),
    "vit_b": FaceViTConfig(embed_dim=512, depth=24, mask_ratio=0.1),
    "vit_l": FaceViTConfig(embed_dim=768, depth=24, mask_ratio=0.05),
}


def _dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class Block(nn.Module):
    def __init__(self, d: int, m: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.ln1, self.ln2 = Affine(d), Affine(d)
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        self.fc1 = nn.Linear(d, m)
        self.fc2 = nn.Linear(m, d)

    def forward(self, x):
        b, n, d = x.shape
        hd = d // self.num_heads
        h = layer_norm(x, self.ln1.weight, self.ln1.bias)
        q, k, v = _dense(h, self.qkv).reshape(b, n, 3, self.num_heads, hd).unbind(2)  # (b, n, heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        w = torch.softmax(logits * hd**-0.5, dim=-1).to(x.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(x.dtype)
        x = x + _dense(attn.reshape(b, n, d), self.proj)
        h = layer_norm(x, self.ln2.weight, self.ln2.bias)
        h = torch.clamp(_dense(h, self.fc1), 0.0, 6.0)  # ReLU6, the reference's Mlp act
        return x + _dense(h, self.fc2)


class FaceViT(nn.Module):
    """(B, 112, 112, 3) → (B, num_features) fp32 embedding."""

    def __init__(self, cfg: FaceViTConfig = FaceViTConfig(), *, device=None, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        device = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        d, m = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
        with torch.device("meta"):
            self.patch_embed = nn.Conv2d(3, d, cfg.patch_size)
            self.pos_embed = nn.Parameter(torch.empty(cfg.num_patches, d))
            self.mask_token = nn.Parameter(torch.empty(d))
            self.blocks = nn.ModuleList(Block(d, m, cfg.num_heads) for _ in range(cfg.depth))
            self.norm = Affine(d)
            self.head_fc1 = nn.Linear(d * cfg.num_patches, d, bias=False)
            self.head_bn1 = BatchNorm(d)
            self.head_fc2 = nn.Linear(d, cfg.num_features, bias=False)
            self.head_bn2 = BatchNorm(cfg.num_features)
        materialize(self, device, dtype, torch.Generator(device=device).manual_seed(seed))
        with torch.no_grad():
            for bn in (self.head_bn1, self.head_bn2):
                bn.weight.fill_(1.0)
                bn.bias.zero_()
                bn.mean.zero_()
                bn.var.fill_(1.0)

    def forward(self, images: torch.Tensor, policy: Policy = DEFAULT_POLICY, train: bool = False,
                generator: Optional[torch.Generator] = None, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """In training mode with a mask ratio, the tokens where `mask` (B, N)
        is true, or else the `int(N·mask_ratio)` lowest of uniform draws from
        `generator` per sample, become the mask token."""
        cfg = self.cfg
        x = images.to(policy.compute_dtype).permute(0, 3, 1, 2)
        x = F.conv2d(x, self.patch_embed.weight.to(x.dtype), None, cfg.patch_size)
        b = x.shape[0]
        x = x.permute(0, 2, 3, 1).reshape(b, -1, cfg.embed_dim) + self.patch_embed.bias.to(x.dtype)
        x = x + self.pos_embed[None].to(x.dtype)
        if train and cfg.mask_ratio > 0 and (generator is not None or mask is not None):
            if mask is None:
                n = x.shape[1]
                noise = torch.rand(b, n, generator=generator, device=generator.device)
                ranks = torch.argsort(torch.argsort(noise, dim=1), dim=1)
                mask = ranks < int(n * cfg.mask_ratio)
            x = torch.where(mask.to(x.device)[..., None], self.mask_token.to(x.dtype), x)
        for blk in self.blocks:
            x = blk(x)
        x = layer_norm(x, self.norm.weight, self.norm.bias)
        h = F.linear(x.float().reshape(b, -1), self.head_fc1.weight.float())
        bn = self.head_bn1
        h = batch_norm_inference(h, bn.weight, bn.bias, bn.mean, bn.var, cfg.bn_eps)
        h = F.linear(h, self.head_fc2.weight.float())
        bn = self.head_bn2
        return batch_norm_inference(h, bn.weight, bn.bias, bn.mean, bn.var, cfg.bn_eps)
