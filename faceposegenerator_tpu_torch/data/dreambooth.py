"""DreamBooth dataset with the prior-preservation collate (port of
`faceposegenerator_tpu/data/dreambooth.py`; numpy and PIL on the host).

The reference's `DreamBoothDataset`/`collate_fn` (`train_ID-Booth.py:
233-389`): instance images of one identity with the tokenized instance
prompt and per-image ArcFace embeddings, class (prior) images cycled with
the class prompt, and [instance; class] concatenated into one batch so one
forward pass covers both (`:354-389`). Images are resized so the shorter
side is `resolution`, then cropped at random (or centred) and mapped to
[-1, 1] (`:293-300`).

As in the JAX package: embeddings load from per-image `.npy` (or the
reference's `.pt`) files, falling back to a folder-level file and then to
zeros; the class rows take `class_embed.npy` beside the class folder; the
batches are numpy, NHWC, which the train step takes as they are. The crop
offsets and the shuffles come from `numpy.random.default_rng(seed)`, so the
two packages load the same batches from the same directory and seed.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import numpy as np

from ..core.mesh import host_row_slice


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def list_images(folder: str) -> List[str]:
    exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
    return sorted((f for f in os.listdir(folder) if f.lower().endswith(exts)), key=_natural_key)


class DreamBoothDataset:
    def __init__(
        self,
        instance_dir: str,
        instance_ids: np.ndarray,
        class_dir: Optional[str] = None,
        class_ids: Optional[np.ndarray] = None,
        embeds_dir: Optional[str] = None,
        resolution: int = 512,
        center_crop: bool = False,
        seed: int = 0,
        embed_dim: int = 512,
    ):
        """instance_ids / class_ids: the tokenized (77,) prompts."""
        self.instance_dir = instance_dir
        self.instance_images = list_images(instance_dir)
        if not self.instance_images:
            raise ValueError(f"no instance images in {instance_dir}")
        self.class_dir = class_dir
        self.class_images = list_images(class_dir) if class_dir else []
        self.instance_ids = np.asarray(instance_ids)
        self.class_ids = np.asarray(class_ids) if class_ids is not None else None
        self.embeds_dir = embeds_dir
        self.resolution = resolution
        self.center_crop = center_crop
        self.embed_dim = embed_dim
        self.rng = np.random.default_rng(seed)
        self._length = max(len(self.instance_images), len(self.class_images) or 1)

    def __len__(self):
        return self._length

    def _load_image(self, path: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(path).convert("RGB")
        w, h = img.size
        scale = self.resolution / min(w, h)
        img = img.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
        arr = np.asarray(img, np.float32)
        hh, ww = arr.shape[:2]
        if self.center_crop:
            y0 = (hh - self.resolution) // 2
            x0 = (ww - self.resolution) // 2
        else:
            y0 = self.rng.integers(0, hh - self.resolution + 1)
            x0 = self.rng.integers(0, ww - self.resolution + 1)
        arr = arr[y0: y0 + self.resolution, x0: x0 + self.resolution]
        return (arr / 255.0 - 0.5) / 0.5  # [-1, 1]

    def _load_embed(self, image_name: str) -> np.ndarray:
        """`<embeds_dir>/<stem>.npy` (or the reference's torch `.pt`,
        `train_ID-Booth.py:271,326`), else a folder-level file, else zeros."""
        if self.embeds_dir is None:
            return np.zeros((self.embed_dim,), np.float32)
        stem = os.path.splitext(image_name)[0]
        for cand in (
            os.path.join(self.embeds_dir, stem + ".npy"),
            os.path.join(self.embeds_dir, stem + ".pt"),
            self.embeds_dir + ".npy",
            self.embeds_dir + ".pt",
        ):
            if os.path.exists(cand):
                if cand.endswith(".pt"):
                    import torch

                    e = torch.load(cand, map_location="cpu", weights_only=True).float().numpy()
                else:
                    e = np.load(cand)
                return np.asarray(e, np.float32).reshape(-1)
        return np.zeros((self.embed_dim,), np.float32)

    def _class_embed(self) -> np.ndarray:
        """The fixed class ("average person") embedding beside the class
        folder, zeros without one."""
        cpath = os.path.join(os.path.dirname(self.class_dir) or ".", "class_embed.npy")
        if os.path.exists(cpath):
            return np.asarray(np.load(cpath), np.float32).reshape(-1)
        return np.zeros((self.embed_dim,), np.float32)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        iname = self.instance_images[index % len(self.instance_images)]
        out = {
            "instance_image": self._load_image(os.path.join(self.instance_dir, iname)),
            "instance_ids": self.instance_ids,
            "instance_embed": self._load_embed(iname),
        }
        if self.class_images:
            cname = self.class_images[index % len(self.class_images)]
            out["class_image"] = self._load_image(os.path.join(self.class_dir, cname))
            out["class_ids"] = self.class_ids
            cpath = os.path.join(os.path.dirname(self.class_dir) or ".", "class_embed.npy")
            out["class_embed"] = (np.asarray(np.load(cpath), np.float32).reshape(-1) if os.path.exists(cpath)
                                  else np.zeros_like(out["instance_embed"]))
        return out

    def _instance_row(self, index: int) -> Dict[str, np.ndarray]:
        iname = self.instance_images[index % len(self.instance_images)]
        return {
            "pixel_values": self._load_image(os.path.join(self.instance_dir, iname)),
            "input_ids": self.instance_ids,
            "gt_embeds": self._load_embed(iname),
        }

    def _class_row(self, index: int) -> Dict[str, np.ndarray]:
        cname = self.class_images[index % len(self.class_images)]
        return {
            "pixel_values": self._load_image(os.path.join(self.class_dir, cname)),
            "input_ids": self.class_ids,
            "gt_embeds": self._class_embed(),
        }

    def sharded_batches(self, batch_size: int, num_shards: int = 1, shard_index: int = 0, shuffle: bool = True,
                        drop_last: bool = True, epoch: int = 0, order_seed: int = 0):
        """This host's contiguous rows of each global prior-concat batch
        ([instance × B_g; class × B_g], B_g = batch_size · num_shards),
        loading only the files those rows name. Every host derives the
        global order from (order_seed, epoch), so the shards in host order
        make the single-process batch (`train_ID-Booth.py:890-898`)."""
        if not self.class_images:
            raise ValueError("sharded_batches requires prior preservation (class images)")
        b_global = batch_size * num_shards
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng((order_seed, epoch)).shuffle(order)
        n_full = len(order) // b_global if drop_last else -(-len(order) // b_global)
        for bi in range(n_full):
            idx = order[bi * b_global: (bi + 1) * b_global]
            rows = host_row_slice(2 * b_global, num_shards, shard_index)
            items = [self._instance_row(idx[r]) if r < b_global else self._class_row(idx[r - b_global])
                     for r in range(rows.start, rows.stop)]
            yield {
                "pixel_values": np.stack([it["pixel_values"] for it in items]).astype(np.float32),
                "input_ids": np.stack([it["input_ids"] for it in items]).astype(np.int32),
                "gt_embeds": np.stack([it["gt_embeds"] for it in items]).astype(np.float32),
            }

    def batches(self, batch_size: int, shuffle: bool = True, drop_last: bool = True):
        """Collated prior-concat batches: pixel_values (2B, H, W, 3) =
        [instance; class], input_ids (2B, 77), gt_embeds (2B, F)."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        n_full = len(order) // batch_size if drop_last else -(-len(order) // batch_size)
        for bi in range(n_full):
            idx = order[bi * batch_size: (bi + 1) * batch_size]
            items = [self[i] for i in idx]
            inst_pix = np.stack([it["instance_image"] for it in items])
            inst_ids = np.stack([it["instance_ids"] for it in items])
            inst_emb = np.stack([it["instance_embed"] for it in items])
            if self.class_images:
                cls_pix = np.stack([it["class_image"] for it in items])
                cls_ids = np.stack([it["class_ids"] for it in items])
                cls_emb = np.stack([it["class_embed"] for it in items])
                yield {
                    "pixel_values": np.concatenate([inst_pix, cls_pix]).astype(np.float32),
                    "input_ids": np.concatenate([inst_ids, cls_ids]).astype(np.int32),
                    "gt_embeds": np.concatenate([inst_emb, cls_emb]).astype(np.float32),
                }
            else:
                yield {
                    "pixel_values": inst_pix.astype(np.float32),
                    "input_ids": inst_ids.astype(np.int32),
                    "gt_embeds": inst_emb.astype(np.float32),
                }
