"""Data2Vec-Vision (BEiT), the dgm-eval "data2vec" encoder (port of
`faceposegenerator_tpu/models/data2vec_vision.py`).

`facebook/data2vec-vision-large`'s `pooler_output`
(`Evaluation/dgm-eval/dgm_eval/models/data2vec.py:35-60`) = LayerNorm(mean of
the patch tokens). BEiT differs from a plain ViT: no absolute position
embeddings; each layer adds a learned relative position bias to its
attention logits (a ((2g−1)²+3, heads) table indexed by a precomputed
(N+1, N+1) map with CLS slots); the key projection has no bias; residuals
are LayerScale-weighted; LN eps 1e-12.

The attention is an explicit einsum with the bias added to fp32 logits, as
in JAX (data2vec_vision.py:9-14): XLA there, plain torch here, no kernel.
The whole encoder runs in fp32, as JAX's `apply` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops.lora import lora_dense
from ..ops.norms import layer_norm
from .dinov2 import embed_patches
from .layers import Affine, materialize


@dataclasses.dataclass(frozen=True)
class Data2VecVisionConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 16
    image_size: int = 224
    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_rel_distance(self) -> int:
        return (2 * self.grid - 1) ** 2 + 3


D2V_LARGE_CONFIG = Data2VecVisionConfig()


def relative_position_index(grid: int) -> np.ndarray:
    """BEiT's (N+1, N+1) relative-distance index with the three CLS slots
    (transformers `Data2VecVisionRelativePositionBias` semantics)."""
    w = grid
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)  # N,N,2
    rel = rel + (w - 1)
    rel[:, :, 0] *= 2 * w - 1
    n = w * w
    num = (2 * w - 1) ** 2 + 3
    idx = np.zeros((n + 1, n + 1), np.int32)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num - 3
    idx[0:, 0] = num - 2
    idx[0, 0] = num - 1
    return idx


class Data2VecLayer(nn.Module):
    def __init__(self, cfg: Data2VecVisionConfig):
        super().__init__()
        d, m = cfg.hidden_size, cfg.intermediate_size
        self.norm1 = Affine(d)
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d, bias=False)  # BEiT: the key has no bias
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)
        self.rel_bias = nn.Parameter(torch.empty(cfg.num_rel_distance, cfg.num_heads))
        self.ls1 = nn.Parameter(torch.empty(d))
        self.norm2 = Affine(d)
        self.fc1 = nn.Linear(d, m)
        self.fc2 = nn.Linear(m, d)
        self.ls2 = nn.Parameter(torch.empty(d))


class Data2VecVision(nn.Module):
    """A frozen evaluation encoder; attribute names follow the JAX tree."""

    def __init__(self, cfg: Data2VecVisionConfig = D2V_LARGE_CONFIG, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        device = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        with torch.device("meta"):
            self.patch_embed = nn.Conv2d(3, d, cfg.patch_size)
            self.cls_token = nn.Parameter(torch.empty(1, 1, d))
            self.layers = nn.ModuleList(Data2VecLayer(cfg) for _ in range(cfg.num_layers))
            self.pooler_norm = Affine(d)
        materialize(self, device, dtype, torch.Generator(device=device).manual_seed(seed))
        with torch.no_grad():  # LayerScale starts at 0.1 (data2vec_vision.py:104-111)
            for layer in self.layers:
                layer.ls1.fill_(0.1)
                layer.ls2.fill_(0.1)
        self.requires_grad_(False)
        self._index = {}

    def _rel_index(self, grid: int, device) -> torch.Tensor:
        key = (grid, str(device))
        if key not in self._index:
            self._index[key] = torch.from_numpy(relative_position_index(grid).reshape(-1)).long().to(device)
        return self._index[key]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) normalized → hidden states (B, 1+N, D), fp32."""
        cfg = self.cfg
        x = embed_patches(images.float(), self.patch_embed.weight, self.patch_embed.bias, cfg.patch_size)
        b, n = x.shape[:2]
        grid = int(round(n**0.5))
        x = torch.cat([self.cls_token.float().expand(b, 1, cfg.hidden_size), x], dim=1)  # no absolute positions
        idx = self._rel_index(grid, x.device)
        nh, hd = cfg.num_heads, cfg.head_dim
        s = x.shape[1]
        for layer in self.layers:
            hn = layer_norm(x, layer.norm1.weight, layer.norm1.bias, cfg.layer_norm_eps)
            q = lora_dense(hn, layer.q.weight, layer.q.bias).reshape(b, s, nh, hd)
            k = lora_dense(hn, layer.k.weight, None).reshape(b, s, nh, hd)
            v = lora_dense(hn, layer.v.weight, layer.v.bias).reshape(b, s, nh, hd)
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd**-0.5
            bias = layer.rel_bias[idx].reshape(s, s, nh).permute(2, 0, 1)
            w = torch.softmax(logits + bias[None].float(), dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", w, v.float()).reshape(b, s, cfg.hidden_size)
            x = x + layer.ls1 * lora_dense(o, layer.out.weight, layer.out.bias)
            hn = layer_norm(x, layer.norm2.weight, layer.norm2.bias, cfg.layer_norm_eps)
            ff = lora_dense(F.gelu(lora_dense(hn, layer.fc1.weight, layer.fc1.bias)),
                            layer.fc2.weight, layer.fc2.bias)
            x = x + layer.ls2 * ff
        return x

    def pooled_feature(self, images: torch.Tensor) -> torch.Tensor:
        """pooler_output: LayerNorm(mean of the patch tokens), fp32 (BEiT
        use_mean_pooling; the dgm-eval data2vec representation)."""
        pooled = self(images)[:, 1:].mean(dim=1)
        return layer_norm(pooled, self.pooler_norm.weight, self.pooler_norm.bias, self.cfg.layer_norm_eps).float()
