"""CLIP vision tower, the dgm-eval "clip" encoder (port of
`faceposegenerator_tpu/models/clip_vision.py`).

ln_post(CLS) features of an OpenAI CLIP ViT without the visual projection
(`Evaluation/dgm-eval/dgm_eval/models/clip.py:40-70`, depth=0) over 224²
bicubic-resized, CLIP-normalized images: patch conv (no bias) → [CLS;
patches] + learned positions → pre-LN → N × (LN → MHA → residual, LN → MLP →
residual) → post-LN on the CLS token. Head dim 64: attention is K1 on the
card, at 50 tokens for ViT-B/32 and 257 for ViT-L/14.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.precision import DEFAULT_POLICY, Policy
from ..ops.lora import lora_dense
from ..ops.norms import layer_norm
from .dinov2 import embed_patches, vit_attention
from .layers import Affine, materialize


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 14
    image_size: int = 224
    hidden_act: str = "quick_gelu"  # openai CLIP; open_clip laion uses "gelu"
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


VITL14_CLIP_CONFIG = CLIPVisionConfig()
VITB32_CLIP_CONFIG = CLIPVisionConfig(
    hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072, patch_size=32
)


class CLIPVisionLayer(nn.Module):
    def __init__(self, d: int, m: int):
        super().__init__()
        self.ln1 = Affine(d)
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)
        self.ln2 = Affine(d)
        self.fc1 = nn.Linear(d, m)
        self.fc2 = nn.Linear(m, d)


class CLIPVision(nn.Module):
    """A frozen evaluation encoder (no parameter takes a gradient); attribute
    names follow the JAX param tree."""

    def __init__(self, cfg: CLIPVisionConfig = VITB32_CLIP_CONFIG, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        device = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        with torch.device("meta"):
            self.patch_embed = nn.Parameter(torch.empty(d, 3, cfg.patch_size, cfg.patch_size))
            self.class_embedding = nn.Parameter(torch.empty(d))
            self.pos_embed = nn.Parameter(torch.empty(cfg.num_patches + 1, d))
            self.pre_ln = Affine(d)
            self.layers = nn.ModuleList(CLIPVisionLayer(d, cfg.intermediate_size) for _ in range(cfg.num_layers))
            self.post_ln = Affine(d)
        materialize(self, device, dtype, torch.Generator(device=device).manual_seed(seed))
        self.requires_grad_(False)

    def _act(self, x):
        if self.cfg.hidden_act == "gelu":
            return F.gelu(x)
        if self.cfg.hidden_act == "quick_gelu":
            return x * torch.sigmoid(1.702 * x)
        raise ValueError(self.cfg.hidden_act)

    def forward(self, images: torch.Tensor, policy: Policy = DEFAULT_POLICY,
                tap: Optional[Callable] = None) -> torch.Tensor:
        """images (B, H, W, 3) CLIP-normalized → hidden states (B, 1+N, D).
        `tap` is applied to the last layer's ln1 output (the reference
        GradCAM target 'visual.transformer.resblocks.11.ln_1')."""
        cfg = self.cfg
        x = embed_patches(images.to(policy.compute_dtype), self.patch_embed, None, cfg.patch_size)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)[None]
        x = layer_norm(x, self.pre_ln.weight, self.pre_ln.bias, cfg.layer_norm_eps)
        last = len(self.layers) - 1
        for li, layer in enumerate(self.layers):
            hn = layer_norm(x, layer.ln1.weight, layer.ln1.bias, cfg.layer_norm_eps)
            if tap is not None and li == last:
                hn = tap(hn)
            x = x + vit_attention(layer, hn, cfg.num_heads)
            hn = layer_norm(x, layer.ln2.weight, layer.ln2.bias, cfg.layer_norm_eps)
            x = x + lora_dense(self._act(lora_dense(hn, layer.fc1.weight, layer.fc1.bias)),
                               layer.fc2.weight, layer.fc2.bias)
        return x

    def cls_feature(self, images: torch.Tensor, policy: Policy = DEFAULT_POLICY,
                    tap: Optional[Callable] = None) -> torch.Tensor:
        """ln_post(CLS) in fp32, without the visual projection (depth=0,
        `dgm_eval/models/clip.py:60-70`)."""
        cls = self(images, policy, tap=tap)[:, 0]
        return layer_norm(cls, self.post_ln.weight, self.post_ln.bias, self.cfg.layer_norm_eps).float()
