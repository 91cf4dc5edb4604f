"""CLIP text encoder, SD2.1's OpenCLIP ViT-H text tower (port of
`faceposegenerator_tpu/models/clip_text.py`).

Causal attention over 77 tokens stays a plain einsum with fp32 softmax, as
in the JAX package (clip_text.py:109-115): no kernel there either.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.precision import DEFAULT_POLICY, Policy
from ..ops.lora import lora_dense
from ..ops.norms import layer_norm
from .layers import Affine, materialize


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    intermediate_size: int = 4096
    max_positions: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"  # exact erf gelu (SD2); "quick_gelu" for SD1.x

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


SD21_TEXT_CONFIG = CLIPTextConfig()


class CLIPLayer(nn.Module):
    def __init__(self, h: int, m: int):
        super().__init__()
        self.ln1 = Affine(h)
        self.q = nn.Linear(h, h)
        self.k = nn.Linear(h, h)
        self.v = nn.Linear(h, h)
        self.out = nn.Linear(h, h)
        self.ln2 = Affine(h)
        self.fc1 = nn.Linear(h, m)
        self.fc2 = nn.Linear(m, h)


def _dense(layer: nn.Linear, x, lora, name, lora_scale):
    la = None if lora is None else lora.get(name)
    return lora_dense(x, layer.weight, layer.bias,
                      lora_a=None if la is None else la["a"],
                      lora_b=None if la is None else la["b"], scale=lora_scale)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = SD21_TEXT_CONFIG, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        device = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        with torch.device("meta"):
            self.token_embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size))
            self.position_embedding = nn.Parameter(torch.empty(cfg.max_positions, cfg.hidden_size))
            self.final_ln = Affine(cfg.hidden_size)
            self.layers = nn.ModuleList(
                CLIPLayer(cfg.hidden_size, cfg.intermediate_size) for _ in range(cfg.num_layers)
            )
        materialize(self, device, dtype, torch.Generator(device=device).manual_seed(seed))

    def _act(self, x):
        if self.cfg.hidden_act == "gelu":
            return F.gelu(x)
        if self.cfg.hidden_act == "quick_gelu":
            return x * torch.sigmoid(1.702 * x)
        raise ValueError(self.cfg.hidden_act)

    def forward(self, input_ids: torch.Tensor, policy: Policy = DEFAULT_POLICY,
                lora: Optional[dict] = None, lora_scale: float = 1.0) -> torch.Tensor:
        """Token ids (B, S) → last_hidden_state (B, S, hidden) (clip_text.py:128)."""
        cfg = self.cfg
        b, s = input_ids.shape
        nh, hd = cfg.num_heads, cfg.head_dim
        x = self.token_embedding[input_ids] + self.position_embedding[None, :s]
        x = x.to(policy.compute_dtype)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        for i, layer in enumerate(self.layers):
            llora = None if lora is None else lora.get(f"layer_{i}")
            hn = layer_norm(x, layer.ln1.weight, layer.ln1.bias, cfg.layer_norm_eps)
            q, k, v = (_dense(getattr(layer, n), hn, llora, n, lora_scale).reshape(b, s, nh, hd)
                       for n in ("q", "k", "v"))
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd**-0.5
            logits = logits.masked_fill(~causal, float("-inf"))
            w = torch.softmax(logits, dim=-1).to(x.dtype)
            attn = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(x.dtype).reshape(b, s, -1)
            x = x + _dense(layer.out, attn, llora, "out", lora_scale)
            hn = layer_norm(x, layer.ln2.weight, layer.ln2.bias, cfg.layer_norm_eps)
            hn = self._act(lora_dense(hn, layer.fc1.weight, layer.fc1.bias))
            x = x + lora_dense(hn, layer.fc2.weight, layer.fc2.bias)
        return layer_norm(x, self.final_ln.weight, self.final_ln.bias, cfg.layer_norm_eps)
