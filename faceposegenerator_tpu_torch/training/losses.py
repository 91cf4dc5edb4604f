"""FR margin-penalty softmax heads (port of
`faceposegenerator_tpu/training/losses.py:26-131`).

ArcFace (additive angular margin), CosFace (additive cosine margin),
ElasticCosFace (a per-sample N(m, std) margin, optionally assigned by
hardness) and AdaFace (a norm-adaptive margin with EMA batch statistics of
the feature norms). Every head: L2-normalised embeddings × column-normalised
kernel → clamped cosine logits, the margin at the label column, scaled by s.
The kernel is (embedding_dim, num_classes). Labels of -1 get no margin.
Heads are plain functions of tensors; AdaFace returns its new EMA state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _l2(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=dim, keepdim=True), min=eps)


def init_kernel(generator: torch.Generator, embedding_dim: int, num_classes: int, kind: str = "normal",
                device=None) -> torch.Tensor:
    """N(0, 0.01²) ("normal"), or uniform in [-1, 1) with unit columns
    ("uniform", AdaFace's)."""
    device = device if device is not None else generator.device
    if kind == "normal":
        return torch.randn(embedding_dim, num_classes, generator=generator, device=device) * 0.01
    k = torch.rand(embedding_dim, num_classes, generator=generator, device=device) * 2 - 1
    return _l2(k, dim=0)


def _cosine(embeddings: torch.Tensor, kernel: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return torch.clamp(_l2(embeddings, dim=1) @ _l2(kernel, dim=0), -1.0 + eps, 1.0 - eps)


def _one_hot_margin(cos: torch.Tensor, labels: torch.Tensor, margin) -> torch.Tensor:
    """`margin` (a number or one per sample) at the label column; rows with
    label -1 get none."""
    oh = F.one_hot(labels.clamp(min=0), cos.shape[1]).to(cos.dtype)
    m = margin if torch.is_tensor(margin) else torch.full(labels.shape, margin, dtype=cos.dtype, device=cos.device)
    return oh * torch.where(labels >= 0, m.to(cos.dtype), torch.zeros((), dtype=cos.dtype, device=cos.device))[:, None]


def arcface_logits(kernel, embeddings, labels, s: float = 64.0, m: float = 0.5) -> torch.Tensor:
    cos = _cosine(embeddings, kernel)
    theta = torch.arccos(cos) + _one_hot_margin(cos, labels, m)
    return torch.cos(theta) * s


def cosface_logits(kernel, embeddings, labels, s: float = 64.0, m: float = 0.35) -> torch.Tensor:
    cos = _cosine(embeddings, kernel)
    return (cos - _one_hot_margin(cos, labels, m)) * s


def elastic_cosface_logits(kernel, embeddings, labels, generator: Optional[torch.Generator] = None,
                           s: float = 64.0, m: float = 0.35, std: float = 0.0125, plus: bool = False,
                           normals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The margin is m + std·N(0, 1), one draw per sample from `generator`
    or given as `normals` (the test's seam for JAX's draws). With `plus`,
    sample j receives sorted_margin[order[j]], order the descending argsort
    of the target cosines: the reference's scatter (losses.py:70-79)."""
    cos = _cosine(embeddings, kernel)
    if normals is None:
        normals = torch.randn(labels.shape, generator=generator, device=generator.device)
    margin = m + std * normals.to(cos.device, cos.dtype)
    if plus:
        target_cos = torch.gather(cos, 1, labels.clamp(min=0)[:, None])[:, 0]
        order = torch.argsort(-target_cos, stable=True)
        margin = torch.sort(margin, stable=True).values[order]
    return (cos - _one_hot_margin(cos, labels, margin)) * s


@dataclasses.dataclass(frozen=True)
class AdaFaceConfig:
    m: float = 0.4
    h: float = 0.333
    s: float = 64.0
    t_alpha: float = 1.0  # the reference's default (train_FR.py:176 uses the defaults)
    eps: float = 1e-3


def adaface_init_state(device=None) -> dict:
    return {"batch_mean": torch.tensor(20.0, device=device), "batch_std": torch.tensor(100.0, device=device)}


def adaface_logits(kernel, embeddings, norms, labels, state: dict, cfg: AdaFaceConfig = AdaFaceConfig(),
                   train: bool = True, batch_norms: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
    """`embeddings` already L2-normalised, `norms` their pre-norm magnitudes.
    Returns (scaled logits, new EMA state); the norms carry no gradient.
    `batch_norms`: the norms of the whole batch when this is one shard of it
    (data-parallel training), whose mean and std the EMA takes."""
    cos = torch.clamp(embeddings @ _l2(kernel, dim=0), -1 + cfg.eps, 1 - cfg.eps)
    safe = torch.clamp(norms, 0.001, 100.0).detach()
    if train:
        whole = safe if batch_norms is None else torch.clamp(batch_norms, 0.001, 100.0).detach()
        mean = whole.mean()
        std = whole.std(correction=1)
        new_state = {
            "batch_mean": cfg.t_alpha * mean + (1 - cfg.t_alpha) * state["batch_mean"],
            "batch_std": cfg.t_alpha * std + (1 - cfg.t_alpha) * state["batch_std"],
        }
    else:
        new_state = state
    scaler = (safe - new_state["batch_mean"]) / (new_state["batch_std"] + cfg.eps)
    scaler = torch.clamp(scaler * cfg.h, -1.0, 1.0)

    oh = F.one_hot(labels.clamp(min=0), cos.shape[1]).to(cos.dtype)
    g_angular = -cfg.m * scaler
    theta = torch.arccos(cos)
    theta_m = torch.clamp(theta + oh * g_angular[:, None], cfg.eps, math.pi - cfg.eps)
    g_add = cfg.m + cfg.m * scaler
    cos_m = torch.cos(theta_m) - oh * g_add[:, None]
    return cos_m * cfg.s, new_state


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, 1, labels[:, None].long()).mean()


HEADS = {"arcface": arcface_logits, "cosface": cosface_logits}
