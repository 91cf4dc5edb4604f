"""CR-FIQA face image quality (port of
`faceposegenerator_tpu/evaluation/fiqa.py`, the reference's
`Evaluation/CR-FIQA/getQualityScore_FR_ID-Booth_12-2024.py`): an IResNet
backbone whose flattened post-bn2 feature map feeds both the embedding fc
and a linear quality head `qs` (512·7·7 → 1). Scores are written as
`path score` lines, at most 10k sampled images, batch 16.

`make_quality_fn_u8` resizes and normalises uint8 images on the card, so
the sweep's `on_images` hook scores a batch without a host round trip (a
bilinear resize on the card where the file path resizes with PIL:
identical at 112²).
"""

from __future__ import annotations

import os
import random
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.precision import DEFAULT_POLICY, Policy


def init_qs_head(fc_in: int = 512 * 49, *, device=None, dtype: torch.dtype = torch.float32, seed: int = 0):
    """The quality head, a linear (fc_in → 1) (JAX {"w": (1, fc_in), "b"}),
    random N(0, 1/fc_in) weights and a zero bias from `seed`, on the card
    unless `device` says otherwise."""
    device = resolve_device(device)
    head = nn.Linear(fc_in, 1, device=device, dtype=dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        head.weight.normal_(0.0, (1.0 / fc_in) ** 0.5, generator=g)
        head.bias.zero_()
    return head


def convert_qs_from_state_dict(sd) -> dict:
    """{"w", "b"} of a CR-FIQA checkpoint's `qs.weight` / `qs.bias`, the
    weight's flatten order permuted from (c, h, w) to (h, w, c) as the
    NHWC backbone flattens (fiqa.py:35-42); load it into `init_qs_head`'s
    layer with `bridge.jax_params.load_jax_params`."""
    w = np.asarray(sd["qs.weight"])
    side = int(round((w.shape[1] // 512) ** 0.5))
    w = w.reshape(1, 512, side, side).transpose(0, 2, 3, 1).reshape(1, -1)
    return {"w": w, "b": np.asarray(sd["qs.bias"])}


def _quality(backbone, qs_head, x, policy):
    emb, feats = backbone(x, policy, return_features=True)
    qs = F.linear(feats, qs_head.weight.float(), qs_head.bias.float())
    return emb, qs[:, 0]


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def make_quality_fn(backbone, qs_head, policy: Policy = DEFAULT_POLICY) -> Callable:
    """(B, 112, 112, 3) in [-1, 1] (array or tensor) → (embedding (B, 512),
    quality (B,)) on the backbone's device; `backbone` a `models.iresnet.IResNet`."""

    @torch.inference_mode()
    def quality(x):
        return _quality(backbone, qs_head, torch.as_tensor(x).to(_device(backbone)).float(), policy)

    return quality


def make_quality_fn_u8(backbone, qs_head, policy: Policy = DEFAULT_POLICY) -> Callable:
    """uint8 (B, H, W, 3) of any size → (embedding, quality), resized to
    112² and normalised to [-1, 1] on the card."""
    from ..ops.image import resize_bilinear

    @torch.inference_mode()
    def quality(x_u8):
        x = torch.as_tensor(x_u8).to(_device(backbone)).float()
        if x.shape[1] != 112 or x.shape[2] != 112:
            x = resize_bilinear(x, (112, 112))
        return _quality(backbone, qs_head, (x / 255.0 - 0.5) / 0.5, policy)

    return quality


def score_images(images_u8, names, quality_fn_u8: Callable, output_path: Optional[str] = None,
                 batch_size: int = 0) -> Dict[str, float]:
    """Score in-memory uint8 images (on the card or the host) without
    touching disk; `batch_size=0` scores them in one call. The scores are
    copied to the host once, at the end."""
    n = len(names)
    if images_u8.shape[0] != n:
        raise ValueError(f"{images_u8.shape[0]} images for {n} names")
    step = batch_size or n
    parts = [quality_fn_u8(images_u8[start: start + step])[1] for start in range(0, n, step)]
    qs_all = torch.cat(parts).cpu().numpy() if parts else np.zeros((0,))
    scores = {str(p): float(s) for p, s in zip(names, qs_all)}
    if output_path:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        with open(output_path, "w") as out:
            for p in names:
                out.write(f"{p} {scores[str(p)]}\n")
    return scores


def score_dataset(image_dir: str, quality_fn: Callable, output_path: str, max_images: int = 10000,
                  batch_size: int = 16, seed: int = 0) -> Dict[str, float]:
    """Score at most `max_images` images sampled under `image_dir` (PIL
    resize to 112², [-1, 1]) and write `path score` lines."""
    from PIL import Image

    paths: List[str] = []
    for root, _, files in os.walk(image_dir):
        for f in files:
            if f.lower().endswith((".jpg", ".jpeg", ".png")):
                paths.append(os.path.join(root, f))
    paths.sort()
    if len(paths) > max_images:
        paths = random.Random(seed).sample(paths, max_images)
    scores: Dict[str, float] = {}
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as out:
        for start in range(0, len(paths), batch_size):
            chunk = paths[start: start + batch_size]
            imgs = [(np.asarray(Image.open(p).convert("RGB").resize((112, 112)), np.float32) / 255.0 - 0.5) / 0.5
                    for p in chunk]
            _, qs = quality_fn(np.stack(imgs))
            for p, s in zip(chunk, torch.as_tensor(qs).cpu().numpy()):
                scores[p] = float(s)
                out.write(f"{p} {float(s)}\n")
    return scores
