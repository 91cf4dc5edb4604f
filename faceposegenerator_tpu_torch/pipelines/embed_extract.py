"""ArcFace embedding extraction (port of
`faceposegenerator_tpu/pipelines/embed_extract.py:28-289`).

Every image gets its own embedding (the per-image contract the ID-Booth
trainer reads):

  images/<id>/*.jpg → detect (MTCNN) → bbox crop → 112² → [-1,1] →
  IResNet-100 (batched on the card) → ArcFace_embeds/<id>/<image>.npy

Detection failures are listed in `files_without_faces.json`.
`extract_embeddings_streaming` is the fast path: fixed-size batches across
identity folders, the decode of batch i+1 overlapping batch i, and crop,
normalisation and IResNet as one call on the card (`make_crop_embed_fn`).
Its JPEGs decode on the native loader's threads where that loader builds
(`use_native`, `faceposegenerator_tpu_torch.native`), with PIL otherwise,
as in JAX.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.precision import DEFAULT_POLICY, Policy
from ..data.align import bbox_crop_resize, to_arcface_input
from ..data.dreambooth import list_images
from ..ops import quant as quant_ops
from ..ops.image import crop_and_resize, normalize_to_arcface


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def extract_folder_embeddings(
    images_root: str,
    output_root: str,
    embed_fn: Callable,
    detector=None,
    batch_size: int = 32,
) -> Dict[str, List[str]]:
    """Process every identity subfolder of `images_root`.

    embed_fn: (B, 112, 112, 3) [-1,1] fp32 numpy -> (B, 512), numpy or a
    tensor. detector: MTCNN-like `.detect(img)` or None (whole image).
    Returns {"files_without_faces": [...]} and writes per-image .npy files.
    """
    from PIL import Image

    os.makedirs(output_root, exist_ok=True)
    missing: List[str] = []

    for id_folder in sorted(os.listdir(images_root)):
        src = os.path.join(images_root, id_folder)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(output_root, id_folder)
        os.makedirs(dst, exist_ok=True)
        names = list_images(src)
        imgs = [np.asarray(Image.open(os.path.join(src, name)).convert("RGB")) for name in names]
        faces, face_names = [], []
        if detector is not None and imgs:
            # the whole identity folder in one detect call where the sizes
            # agree (`extract_ArcFace_embeds.py:42-52`), else per image
            if hasattr(detector, "detect_batch") and len({im.shape for im in imgs}) == 1:
                boxes_list = detector.detect_batch(np.stack(imgs))[0]
            else:
                boxes_list = [detector.detect(im)[0] for im in imgs]
            for name, img, boxes in zip(names, imgs, boxes_list):
                if boxes is None or len(boxes) == 0:
                    missing.append(os.path.join(id_folder, name))
                    continue
                faces.append(bbox_crop_resize(img, boxes[0], 112))
                face_names.append(name)
        else:
            for name, img in zip(names, imgs):
                faces.append(bbox_crop_resize(img, np.array([0, 0, img.shape[1], img.shape[0]]), 112))
                face_names.append(name)

        for start in range(0, len(faces), batch_size):
            chunk = np.stack(faces[start : start + batch_size])
            embs = _host(embed_fn(to_arcface_input(chunk)))
            for j, name in enumerate(face_names[start : start + batch_size]):
                np.save(os.path.join(dst, os.path.splitext(name)[0] + ".npy"), embs[j])

    with open(os.path.join(output_root, "files_without_faces.json"), "w") as f:
        json.dump(missing, f, indent=2)
    return {"files_without_faces": missing}


def make_crop_embed_fn(model, policy: Optional[Policy] = None, device=None) -> Callable:
    """(images [0, 255] (B, H, W, 3), boxes (B, 4)) → (B, D) fp32 on `device`
    (the card unless "cpu"; the IResNet `model` lives there): the bilinear
    box crop to 112² (`ops.image.crop_and_resize`), ArcFace normalisation and
    the inference forward in one call on the device."""
    policy = policy or DEFAULT_POLICY
    device = resolve_device(device)

    @torch.no_grad()
    def crop_embed(imgs, boxes):
        imgs = torch.as_tensor(imgs).to(device, torch.float32)
        boxes = torch.as_tensor(boxes, dtype=torch.float32).to(device)
        return model(normalize_to_arcface(crop_and_resize(imgs, boxes, 112)), policy)

    return crop_embed


def make_arcface_embed_fn(model, policy: Optional[Policy] = None, device=None) -> Callable:
    """The frozen ArcFace embed function (`prepare_locked_ArcFace_model`):
    (B, 112, 112, 3) [-1, 1] → (B, D) fp32 on `device`."""
    policy = policy or DEFAULT_POLICY
    device = resolve_device(device)

    @torch.no_grad()
    def embed(x):
        return model(torch.as_tensor(x).to(device, torch.float32), policy)

    return embed


def calibrate_embed_quant(model, images, policy: Optional[Policy] = None, margin: float = 1.1):
    """Freeze static activation scales onto an IResNet that `quantize_iresnet`
    quantized, from inference forwards over calibration `images` ((B, 112,
    112, 3) in [-1, 1]; a list runs several batches). The JAX function returns
    a new tree; this sets the scales in place and returns `model`."""
    policy = policy or DEFAULT_POLICY
    device = next(model.parameters()).device
    batches = images if isinstance(images, (list, tuple)) else [images]
    with torch.no_grad(), quant_ops.observe_act_scales() as calib:
        for x in batches:
            model(torch.as_tensor(x).to(device, torch.float32), policy)
    if not calib:
        raise ValueError("no quantized sites observed — quantize_iresnet first")
    quant_ops.freeze_act_scales(model, calib, margin=margin)
    return model


def _decode_files_batch(paths: List[str], native_mod=None, expect_hw=None) -> np.ndarray:
    """JPEG/PNG files → one (B, H, W, 3) [0, 255] fp32 stack. JPEGs of a
    square `expect_hw` go through the native loader's thread-parallel decoder
    when `native_mod` is given (its [-1, 1] output rescaled here); PIL
    decodes otherwise, and where libjpeg rejects a payload
    (embed_extract.py:199-218)."""
    from PIL import Image

    if (
        native_mod is not None
        and expect_hw is not None
        and expect_hw[0] == expect_hw[1]
        and all(p.lower().endswith((".jpg", ".jpeg")) for p in paths)
    ):
        payloads = []
        for p in paths:
            with open(p, "rb") as f:
                payloads.append(f.read())
        out = np.empty((len(paths), expect_hw[0], expect_hw[1], 3), np.float32)
        try:
            native_mod.decode_batch(payloads, out, expect_hw[0], 8)
            return out * 127.5 + 127.5
        except ValueError:
            pass  # a payload libjpeg rejects: PIL below
    return np.stack([np.asarray(Image.open(p).convert("RGB"), np.float32) for p in paths])


def extract_embeddings_streaming(
    images_root: str,
    output_root: str,
    crop_embed_fn: Callable,
    detector,
    batch_size: int = 64,
    use_native: bool = True,
) -> Dict[str, List[str]]:
    """End-to-end streaming extraction: decode → batched MTCNN detect →
    crop + embed on the card, with batch i+1's decode overlapping batch i's
    detect and embed (a one-thread pool). Batches are fixed size and cross
    identity-folder boundaries; the tail batch is padded with its last image.
    All images must share one resolution. Writes per-image `.npy` embeds and
    `files_without_faces.json` like `extract_folder_embeddings`.

    `use_native=True` decodes the JPEGs with the native loader
    (`faceposegenerator_tpu_torch.native`) where it builds, and with PIL
    where it does not, as JAX does (embed_extract.py:235-240)."""
    from concurrent.futures import ThreadPoolExecutor

    native_mod = None
    if use_native:
        from .. import native as native_pkg

        native_mod = native_pkg.load()

    os.makedirs(output_root, exist_ok=True)
    entries: List[tuple] = []  # (id_folder, name, path)
    for id_folder in sorted(os.listdir(images_root)):
        src = os.path.join(images_root, id_folder)
        if not os.path.isdir(src):
            continue
        os.makedirs(os.path.join(output_root, id_folder), exist_ok=True)
        for name in list_images(src):
            entries.append((id_folder, name, os.path.join(src, name)))

    missing: List[str] = []
    if not entries:
        with open(os.path.join(output_root, "files_without_faces.json"), "w") as f:
            json.dump(missing, f, indent=2)
        return {"files_without_faces": missing}

    from PIL import Image

    with Image.open(entries[0][2]) as probe:
        expect_hw = (probe.size[1], probe.size[0])

    batches = [entries[i : i + batch_size] for i in range(0, len(entries), batch_size)]
    pool = ThreadPoolExecutor(max_workers=1)

    def decode(batch):
        return _decode_files_batch([p for _, _, p in batch], native_mod, expect_hw)

    try:
        fut = pool.submit(decode, batches[0])
        for bi, batch in enumerate(batches):
            imgs = fut.result()
            if len(batch) < batch_size:
                pad = batch_size - len(batch)
                imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, axis=0)])
            if imgs.shape[1:3] != expect_hw:
                raise ValueError(
                    "extract_embeddings_streaming needs a uniform image size; "
                    "use extract_folder_embeddings for mixed sizes"
                )
            if bi + 1 < len(batches):
                fut = pool.submit(decode, batches[bi + 1])
            boxes_list = detector.detect_batch(imgs)[0] if detector is not None else [
                np.array([[0, 0, imgs.shape[2], imgs.shape[1]]], np.float32)
            ] * imgs.shape[0]
            boxes = np.zeros((imgs.shape[0], 4), np.float32)
            ok = np.zeros((imgs.shape[0],), bool)
            for j, bl in enumerate(boxes_list):
                if j >= len(batch) or bl is None or len(bl) == 0:
                    if j < len(batch):
                        missing.append(os.path.join(batch[j][0], batch[j][1]))
                    boxes[j] = (0, 0, imgs.shape[2], imgs.shape[1])  # dummy
                else:
                    boxes[j] = bl[0][:4]
                    ok[j] = True
            embs = _host(crop_embed_fn(imgs, boxes))
            for j, (id_folder, name, _) in enumerate(batch):
                if ok[j]:
                    np.save(os.path.join(output_root, id_folder, os.path.splitext(name)[0] + ".npy"), embs[j])
    finally:
        pool.shutdown()

    with open(os.path.join(output_root, "files_without_faces.json"), "w") as f:
        json.dump(missing, f, indent=2)
    return {"files_without_faces": missing}
