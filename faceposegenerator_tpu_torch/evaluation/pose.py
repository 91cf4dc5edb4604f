"""Head pose (6DRepNet) and pose-diversity statistics (port of
`faceposegenerator_tpu/evaluation/pose.py`, the reference's
`Evaluation/PoseEstimation/estimate_head_pose_ID-Booth.ipynb`): a RepVGG
backbone and a linear 6D-rotation head, Gram-Schmidt to a rotation matrix,
Euler angles in degrees; per-image poses aggregated to global and
per-identity pitch/yaw/roll statistics saved as JSON.

`make_pose_fn_u8` pads, resizes and normalises uint8 images on the card, so
the sweep's `on_images` hook scores a batch without a host round trip.
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..models import repvgg

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def rotation_from_ortho6d(poses: torch.Tensor) -> torch.Tensor:
    """(B, 6) continuous rotation representation → (B, 3, 3) by
    Gram-Schmidt, the basis vectors as columns (6DRepNet's
    `compute_rotation_matrix_from_ortho6d`)."""
    a1, a2 = poses[:, :3], poses[:, 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=1, keepdim=True).clamp_min(1e-8)
    b2 = a2 - (b1 * a2).sum(dim=1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=1, keepdim=True).clamp_min(1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=1)
    return torch.stack([b1, b2, b3], dim=-1)


def euler_from_rotation(r: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) → (B, 3) [pitch, yaw, roll] in degrees, with 6DRepNet's
    gimbal-lock branch."""
    sy = torch.sqrt(r[:, 0, 0] ** 2 + r[:, 1, 0] ** 2)
    singular = sy < 1e-6
    x = torch.where(singular, torch.atan2(-r[:, 1, 2], r[:, 1, 1]), torch.atan2(r[:, 2, 1], r[:, 2, 2]))
    y = torch.atan2(-r[:, 2, 0], sy)
    z = torch.where(singular, torch.zeros_like(sy), torch.atan2(r[:, 1, 0], r[:, 0, 0]))
    return torch.stack([x, y, z], dim=1) * (180.0 / math.pi)


class SixDRepNet(nn.Module):
    """The backbone and the 6D head (JAX tree {"backbone", "head": {"w", "b"}})."""

    def __init__(self, cfg: repvgg.RepVGGConfig = repvgg.REPVGG_B1G2, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.backbone = repvgg.RepVGG(cfg, device=device, dtype=dtype, seed=seed)
        feat = self.backbone.out_features
        self.head = nn.Linear(feat, 6, device=device, dtype=dtype)
        g = torch.Generator(device=device).manual_seed(seed + 1)
        with torch.no_grad():
            self.head.weight.normal_(0.0, (1.0 / feat) ** 0.5, generator=g)
            self.head.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 224, 224, 3) ImageNet-normalised → (B, 3) degrees."""
        sixd = F.linear(self.backbone(x), self.head.weight.float(), self.head.bias.float())
        return euler_from_rotation(rotation_from_ortho6d(sixd))


def init_sixdrepnet(cfg: repvgg.RepVGGConfig = repvgg.REPVGG_B1G2, *, device=None, seed: int = 0) -> SixDRepNet:
    """A 6DRepNet with random weights from `seed`, on the card unless
    `device` says otherwise."""
    return SixDRepNet(cfg, device=device, seed=seed)


def _on(model: nn.Module, x) -> torch.Tensor:
    return torch.as_tensor(x).to(next(model.parameters()).device)


def make_pose_fn(model: SixDRepNet) -> Callable:
    """(B, 224, 224, 3) ImageNet-normalised (array or tensor) → (B, 3) degrees on the model's device."""

    @torch.inference_mode()
    def pose(x):
        return model(_on(model, x).float())

    return pose


def make_pose_fn_u8(model: SixDRepNet, pad: int = 30, size: int = 224) -> Callable:
    """uint8 (B, H, W, 3) of any size → (B, 3) degrees, on the card: edge
    pad of `pad` pixels, bilinear resize to `size`², ImageNet normalisation."""
    from ..ops.image import resize_bilinear

    @torch.inference_mode()
    def pose(x_u8):
        x = _on(model, x_u8).float()
        x = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="replicate").permute(0, 2, 3, 1)
        x = resize_bilinear(x, (size, size))
        mean, std = (torch.from_numpy(a).to(x.device) for a in (IMAGENET_MEAN, IMAGENET_STD))
        return model((x / 255.0 - mean) / std)

    return pose


def poses_for_images(images_u8, idents, pose_fn_u8: Callable, batch_size: int = 0) -> Dict[str, List[List[float]]]:
    """Per-identity pose lists of in-memory uint8 images; the results are
    copied to the host once, at the end."""
    n = len(idents)
    step = batch_size or n
    parts = [pose_fn_u8(images_u8[start: start + step]) for start in range(0, n, step)]
    all_poses = torch.cat(parts).cpu().numpy() if parts else np.zeros((0, 3))
    per_id: Dict[str, List[List[float]]] = {}
    for ident, p in zip(idents, all_poses):
        per_id.setdefault(str(ident), []).append([float(v) for v in p])
    return per_id


def aggregate_poses(per_id: Dict[str, List[List[float]]], output_json: Optional[str] = None) -> Dict:
    """Global and per-identity pitch/yaw/roll statistics and the pose
    diversity (the mean over identities of the per-identity std)."""
    all_poses = np.array([p for v in per_id.values() for p in v]) if per_id else np.zeros((0, 3))
    result = {
        "global": {
            "mean": all_poses.mean(0).tolist() if len(all_poses) else [0, 0, 0],
            "std": all_poses.std(0).tolist() if len(all_poses) else [0, 0, 0],
            "count": int(len(all_poses)),
        },
        "per_id": {k: {"mean": np.mean(v, 0).tolist(), "std": np.std(v, 0).tolist(), "poses": v}
                   for k, v in per_id.items()},
    }
    if per_id:
        result["pose_diversity"] = np.array([np.std(v, 0) for v in per_id.values()]).mean(0).tolist()
    if output_json:
        os.makedirs(os.path.dirname(output_json) or ".", exist_ok=True)
        with open(output_json, "w") as f:
            json.dump(result, f, indent=2)
    return result


def preprocess_for_pose(img: np.ndarray, pad: int = 30, size: int = 224) -> np.ndarray:
    """uint8 HWC → edge-padded by `pad` (the reference pads 30 px a side),
    resized by PIL, ImageNet-normalised fp32."""
    from PIL import Image

    padded = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    resized = np.asarray(Image.fromarray(padded).resize((size, size), Image.BILINEAR), np.float32)
    return (resized / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def estimate_dataset_poses(image_root: str, pose_fn: Callable, output_json: Optional[str] = None,
                           batch_size: int = 32) -> Dict:
    """Walk `<root>/<identity>/*.png|jpg`, estimate each image's pose with
    `pose_fn` (ImageNet-normalised batches), and aggregate (the notebook's
    JSON)."""
    from PIL import Image

    per_id: Dict[str, List[List[float]]] = {}
    batch, meta = [], []

    def flush():
        if not batch:
            return
        poses = torch.as_tensor(pose_fn(np.stack(batch))).cpu().numpy()
        for ident, p in zip(meta, poses):
            per_id.setdefault(ident, []).append([float(v) for v in p])
        batch.clear()
        meta.clear()

    for ident in sorted(os.listdir(image_root)):
        folder = os.path.join(image_root, ident)
        if not os.path.isdir(folder):
            continue
        for f in sorted(os.listdir(folder)):
            if not f.lower().endswith((".jpg", ".jpeg", ".png")):
                continue
            batch.append(preprocess_for_pose(np.asarray(Image.open(os.path.join(folder, f)).convert("RGB"))))
            meta.append(ident)
            if len(batch) == batch_size:
                flush()
    flush()
    return aggregate_poses(per_id, output_json)
