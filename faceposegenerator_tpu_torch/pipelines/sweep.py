"""The multi-identity synthesis sweep: prompt grid × identities × model
variants (port of `faceposegenerator_tpu/pipelines/sweep.py`, itself the
behaviour of the reference's `inference_ID-Booth.py`).

The prompt grid comes from the gender dict, a pose coin flip, age phases
and backgrounds (`:17-45,113-134`, the same `random.Random(seed)` draws as
JAX, so the strings are identical); the identity index seeds the noise, so
the three model variants (DreamBooth, PortraitBooth, ID-Booth) see the same
latents (`:111`); each identity gets a PNG tree and a 3-model comparison
grid (`:144-156`).

All prompts of an identity run as batched pipeline calls. With
`pack_variants=True` the variants' prompts share batches: each slot rides
its variant's adapter (per-sample adapters) and its prompt's noise
(`sampler.per_prompt_noise`, keyed by (identity, prompt)), so a
(variant, prompt) pair gets the same image whichever batch it lands in.

Batch i+1 is queued on the card before batch i's images are waited for:
each batch's uint8 images are copied to pinned host memory behind it on the
stream, and only that copy's event is waited on, so PNG encoding (PIL, on a
thread pool) and the `on_images` hooks of batch i overlap the card's work
on batch i+1. `on_images` gets the images on the card.
"""

from __future__ import annotations

import json
import os
import random
from concurrent.futures import ThreadPoolExecutor
from itertools import product
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

BACKGROUNDS = [
    "", "forest", "city street", "beach", "office", "bus", "laboratory",
    "factory", "construction site", "hospital", "night club",
]
AGE_PHASES = ["", "young", "middle-aged", "old"]
DEFAULT_NEGATIVE = (
    "cartoon, cgi, render, illustration, painting, drawing, black and white, "
    "bad body proportions, landscape"
)
MODEL_VARIANTS = ("DreamBooth", "PortraitBooth", "ID-Booth")
GRID_IMAGES = 7  # images per variant in a comparison grid


def build_prompt_combinations(
    add_age: bool = False,
    add_background: bool = True,
    num_prompts: int = 21,
) -> List[tuple]:
    """The (age, background) grid of `inference_ID-Booth.py:33-45`."""
    bgs = [f"{b} background" if b else "" for b in BACKGROUNDS]
    if add_age and add_background:
        return list(product(AGE_PHASES, bgs))
    if add_background:
        if num_prompts == 100:
            return [("", b) for b in bgs[1:] * 10]
        return [("", b) for b in [""] + bgs[1:] * 2]
    if add_age:
        return [(a, "") for a in AGE_PHASES * 6]
    return [("", "")] * num_prompts


def build_prompts(
    identity: str,
    gender_dict: Dict[str, str],
    combinations: Sequence[tuple],
    num_prompts: int = 21,
    add_gender: bool = True,
    add_pose: bool = True,
    seed: int = 0,
) -> List[str]:
    """Per-identity prompts: "face portrait photo of [age] <gender> sks
    person[, <bg>]" with a 50% "portrait"→"side-portrait" coin flip
    (`inference_ID-Booth.py:113-134`)."""
    rng = random.Random(seed)
    if len(combinations) > num_prompts:
        picks = rng.sample(list(combinations), min(num_prompts, len(combinations)))
    else:
        picks = list(combinations)[:num_prompts]
    gender = gender_dict.get(identity, "person") if add_gender else ""
    prompts = []
    for age, bg in picks:
        subject = " ".join(x for x in [age, gender, "sks person"] if x)
        prompt = f"face portrait photo of {subject}"
        if add_pose and rng.random() < 0.5:
            prompt = prompt.replace("portrait", "side-portrait")
        if bg:
            prompt += f", {bg}"
        prompts.append(prompt)
    return prompts


def save_image_grid(images: np.ndarray, path: str, per_row: Optional[int] = None):
    """Tile (N, H, W, 3) images ([0, 1] float or uint8) into one PNG grid,
    `per_row` to a row (all N by default), written with PIL."""
    from PIL import Image

    images = np.asarray(images)
    if images.dtype != np.uint8:
        images = (np.clip(images, 0.0, 1.0) * 255).astype(np.uint8)
    n, h, w, _ = images.shape
    per_row = per_row or n
    rows = -(-n // per_row)
    grid = np.zeros((rows * h, per_row * w, 3), np.uint8)
    for i, img in enumerate(images):
        r, c = divmod(i, per_row)
        grid[r * h: (r + 1) * h, c * w: (c + 1) * w] = img
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(grid).save(path)


def _write_pngs(images: np.ndarray, paths: List[str]):
    from PIL import Image

    for img, path in zip(images, paths):
        Image.fromarray(img).save(path)


class _HostCopy:
    """A batch's uint8 images copied to the host behind the card's queued
    work: on the card, into pinned memory without blocking, with an event to
    wait on; on the CPU, the tensor itself."""

    def __init__(self, images: torch.Tensor):
        self.device_images = images
        if images.device.type == "cuda":
            self.host = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
            self.host.copy_(images, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = images, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def run_sweep(
    pipe,
    lora_root: str,
    output_root: str,
    gender_dict_path: Optional[str] = None,
    identities: Optional[List[str]] = None,
    models_to_test: Sequence[str] = MODEL_VARIANTS,
    checkpoint: str = "checkpoint-31-6400",
    num_prompts: int = 21,
    num_inference_steps: int = 30,
    guidance_scale: float = 5.0,
    use_negative_prompt: bool = True,
    batch_size: int = 8,
    seed: int = 0,
    on_images=None,
    write_pngs: bool = True,
    write: bool = True,
    writer_threads: int = 8,
    pack_variants: bool = False,
    variant_loras: Optional[Dict[str, dict]] = None,
    height: int = 512,
    width: int = 512,
    deepcache_interval: int = 1,
    deepcache_depth: int = 1,
    tome_ratio: float = 0.0,
    cfg_interval=None,
):
    """The full sweep with `pipe`, a `StableDiffusionPipeline` with a
    tokenizer; LoRA checkpoints live at
    `<lora_root>/<model>/<identity>/<checkpoint>`. A variant without a
    checkpoint runs the base model (in both modes: JAX's unpacked mode keeps
    the previous variant's adapter there).

    Unpacked, each variant's prompts run in batches of `batch_size` with the
    identity index as seed, and `on_images(model, identity, names, images)`
    sees each batch, `names[i]` "<identity>_<prompt:03d>.png".
    `pack_variants=True` packs all variants' prompts of an identity into
    ⌈V·P/B⌉ batches (3 × 21 at batch 8: 8 batches, 1 pad slot, against 9
    batches and 3 ragged tails unpacked) with per-sample adapters and
    `per_prompt_noise`; `on_images(None, identity, names, images)` then
    sees each mixed batch, `names[i]` "<model>/<identity>_<prompt:03d>.png"
    or None for a pad slot. `variant_loras` gives adapter trees by variant
    name in place of checkpoint directories (packed mode; a variant missing
    from both gets the zero adapter). `images` are uint8 on the card.
    `write_pngs=False` writes the comparison grids but not the PNG tree;
    `write=False` writes no file at all (a data-parallel run's ranks other
    than 0).
    """
    from ..diffusion.lora_io import load_lora_safetensors, zero_lora
    from ..diffusion.sampler import per_prompt_noise

    gender_dict = {}
    if gender_dict_path and os.path.exists(gender_dict_path):
        with open(gender_dict_path) as f:
            gender_dict = json.load(f)
    if identities is None:
        first = os.path.join(lora_root, models_to_test[0])
        identities = sorted(os.listdir(first)) if os.path.isdir(first) else []
    combos = build_prompt_combinations()
    negative = DEFAULT_NEGATIVE if use_negative_prompt else ""
    device = pipe.device
    call_kw = dict(num_inference_steps=num_inference_steps, guidance_scale=guidance_scale, height=height,
                   width=width, output_type="pt_u8", deepcache_interval=deepcache_interval,
                   deepcache_depth=deepcache_depth, tome_ratio=tome_ratio, cfg_interval=cfg_interval)

    writers = ThreadPoolExecutor(max_workers=max(writer_threads, 1))
    write_futs = []
    grid_firsts: Dict[str, Dict[str, list]] = {}
    # the one batch queued on the card and not yet handled on the host:
    # (identity, [(model or None, prompt index)] per slot, model or None
    # for a packed batch, its _HostCopy)
    pending = None

    def drain():
        nonlocal pending
        if pending is None:
            return
        identity, slots, model_name, copy = pending
        pending = None
        if on_images is not None:
            if model_name is None:
                names = [None if m is None else f"{m}/{identity}_{p:03d}.png" for m, p in slots]
            else:
                names = [f"{identity}_{p:03d}.png" for _, p in slots]
            on_images(model_name, identity, names, copy.device_images)
        imgs = copy.numpy()  # waits for this batch's copy only, not the next batch
        firsts = grid_firsts.setdefault(identity, {})
        sel, paths = [], []
        for i, (m, p) in enumerate(slots):
            if m is None:
                continue  # a pad slot
            sel.append(i)
            paths.append(os.path.join(output_root, m, identity, f"{identity}_{p:03d}.png"))
            have = firsts.setdefault(m, [])
            if len(have) < GRID_IMAGES:
                have.append(imgs[i])
        if write and write_pngs and paths:
            write_futs.append(writers.submit(_write_pngs, imgs[sel], paths))

    def variant_tree(model_name, identity):
        if variant_loras and model_name in variant_loras:
            return variant_loras[model_name]
        ckpt = os.path.join(lora_root, model_name, identity, checkpoint)
        if os.path.isdir(ckpt):
            return load_lora_safetensors(ckpt, pipe.nets["unet"], pipe.nets["text_encoder"],
                                         dtype=pipe.policy.param_dtype)
        return zero_lora(pipe.nets["unet"], pipe.nets["text_encoder"], dtype=pipe.policy.param_dtype)

    def run_identity_packed(identity: str, id_number: int, prompts: List[str]):
        nonlocal pending
        from ..core.tree import tree_map

        trees = []
        for model_name in models_to_test:
            tree = variant_tree(model_name, identity)
            trees.append({"unet": tree.get("unet"), "text_encoder": tree.get("text_encoder")})
            os.makedirs(os.path.join(output_root, model_name, identity), exist_ok=True)
        stacked = tree_map(lambda *xs: torch.stack(xs), *trees)  # (V, ...) leaves
        tok = pipe.tokenize(prompts)  # (P, 77)
        neg = pipe.tokenize([negative])  # (1, 77)
        items = [(vi, pi) for vi in range(len(models_to_test)) for pi in range(len(prompts))]
        n_pad = (-len(items)) % batch_size
        padded = items + [items[-1]] * n_pad  # pad slots run the last item again
        for start in range(0, len(padded), batch_size):
            chunk = padded[start: start + batch_size]
            vi = torch.tensor([v for v, _ in chunk], device=device)
            pis = [p for _, p in chunk]
            images = pipe(
                input_ids=tok[pis], negative_input_ids=neg.expand(len(chunk), -1),
                lora=tree_map(lambda leaf: leaf[vi], stacked),
                lora_scale=torch.ones(len(chunk), dtype=torch.float32, device=device),
                noise_override=per_prompt_noise(id_number, pis, num_inference_steps, height // 8, width // 8, device),
                **call_kw,
            )
            first_pad = len(chunk) - (n_pad if start + batch_size >= len(padded) else 0)
            slots = [(models_to_test[v] if i < first_pad else None, p) for i, (v, p) in enumerate(chunk)]
            copy = _HostCopy(images)
            drain()  # the previous batch's host work, behind this batch on the card
            pending = (identity, slots, None, copy)

    try:
        for identity in identities:
            id_number = int("".join(c for c in identity if c.isdigit()) or 0)
            prompts = build_prompts(identity, gender_dict, combos, num_prompts, seed=seed)
            if pack_variants:
                run_identity_packed(identity, id_number, prompts)
                continue
            for model_name in models_to_test:
                ckpt = os.path.join(lora_root, model_name, identity, checkpoint)
                if os.path.isdir(ckpt):
                    pipe.load_lora_weights(ckpt)
                else:
                    pipe.unload_lora_weights()
                os.makedirs(os.path.join(output_root, model_name, identity), exist_ok=True)
                for start in range(0, len(prompts), batch_size):
                    chunk = prompts[start: start + batch_size]
                    images = pipe(chunk, negative_prompt=[negative] * len(chunk), seed=id_number, **call_kw)
                    copy = _HostCopy(images)
                    drain()
                    pending = (identity, [(model_name, start + i) for i in range(len(chunk))], model_name, copy)
        drain()
        for identity, firsts in (grid_firsts.items() if write else ()):
            per_model = [np.stack(firsts[m]) for m in models_to_test if m in firsts]
            if per_model:
                save_image_grid(np.concatenate(per_model),
                                os.path.join(output_root, "comparison_grids", f"{identity}.png"),
                                per_row=min(GRID_IMAGES, len(per_model[0])))
    finally:
        for f in write_futs:
            f.result()  # surface writer errors; return only once the files are written
        writers.shutdown()
