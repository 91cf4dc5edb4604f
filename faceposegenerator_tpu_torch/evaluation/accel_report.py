"""Quality report for the opt-in acceleration modes (port of
`faceposegenerator_tpu/evaluation/accel_report.py:48-258`).

Renders the same (prompt, seed) set through the exact path and each
candidate mode and reports, per mode: per-image PSNR against the exact
output (and min/mean), ArcFace cosine(exact, mode) per image when an
embedder is given, the fraction of bit-identical images, and the wall time
of the batch (one measurement: indicative, not a benchmark).

Mode specs are composable strings:

    deepcache=3          DeepCache interval 3 (depth 1); "3:2" sets depth
    tome=0.5             ToMe ratio 0.5; "0.5:attn,xattn,mlp" sets the ops
    cfg_interval=5:20    guidance only at step indices [5, 20)
    quantize=w8a8        int8 UNet; w8a8:static[:N] adds calibrated static
                         activation scales (N-step calibration); w8a8,vae
                         (pipeline mode "w8a8+vae") also quantizes the VAE
                         decoder body
    parallel=8:0.1       Picard window 8, tolerance 0.1: refused, as the
                         port has no parallel sampler yet
    attn=flash_int8      the int8 attention kernel (K8)
    scheduler=dpm:20     DPM-Solver++ at 20 steps; bare "dpm" keeps the
                         report's step count
    deepcache=3+cfg_interval=5:20+quantize=w8a8     composition
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch


def parse_mode(spec: str):
    """"deepcache=3+quantize=w8a8" -> (call_kwargs, quantize_mode)."""
    kwargs: dict = {}
    quantize = None
    for part in spec.split("+"):
        key, _, val = part.partition("=")
        key = key.strip()
        if not val:
            raise ValueError(f"mode part {part!r} needs key=value")
        if key == "deepcache":
            iv, _, depth = val.partition(":")
            kwargs["deepcache_interval"] = int(iv)
            if depth:
                kwargs["deepcache_depth"] = int(depth)
        elif key == "tome":
            ratio, _, ops = val.partition(":")
            kwargs["tome_ratio"] = float(ratio)
            if ops:
                # '+' separates modes, so ToMe's op list uses commas here
                kwargs["tome_ops"] = ops.replace(",", "+")
        elif key == "cfg_interval":
            lo, _, hi = val.partition(":")
            kwargs["cfg_interval"] = (int(lo), int(hi))
        elif key == "quantize":
            # '+' separates modes, so "w8a8+vae" is spelled w8a8,vae here
            quantize = val.replace(",", "+")
        elif key == "parallel":
            raise ValueError(f"{spec!r}: the port has no parallel sampler yet")
        elif key == "attn":
            # pipeline-level (SamplerModels.attn_impl), popped by compare_modes
            if val not in ("auto", "flash", "flash_int8", "reference"):
                raise ValueError(f"unknown attn impl {val!r} in {spec!r}")
            kwargs["attn_impl"] = val
        elif key == "scheduler":
            kind, _, steps = val.partition(":")
            if kind not in ("ddpm", "dpm"):
                raise ValueError(f"unknown scheduler {kind!r} in {spec!r}")
            kwargs["scheduler_kind"] = kind  # pipeline-level, popped
            if steps:
                kwargs["num_inference_steps"] = int(steps)
        else:
            raise ValueError(f"unknown mode key {key!r} in {spec!r}")
    return kwargs, quantize


def _sibling_pipe(pipe, quantize: Optional[str], calib_kw: Optional[dict] = None,
                  attn_impl: Optional[str] = None, scheduler_kind: Optional[str] = None):
    """A pipeline on `pipe`'s networks and LoRA, optionally quantized.
    Quantizing changes the modules in place, so a quantized sibling takes a
    copy of the networks and `pipe` stays exact.

    `quantize` may carry a `:static[:N]` suffix ("w8a8:static:8"): after
    quantizing, `calibrate_quant` runs N steps (default 4) on the report's
    own prompts (`calib_kw`)."""
    from ..pipelines.txt2img import StableDiffusionPipeline

    models = pipe.models
    if attn_impl is not None:
        models = dataclasses.replace(models, attn_impl=attn_impl)
    nets = copy.deepcopy(pipe.nets) if quantize else dict(pipe.nets)
    p = StableDiffusionPipeline(nets, models, pipe.policy, pipe.scheduler_config, tokenizer=pipe.tokenizer)
    p.scheduler_kind = scheduler_kind or pipe.scheduler_kind
    p.lora, p.lora_scale = pipe.lora, pipe.lora_scale
    if quantize:
        base, _, static = quantize.partition(":")
        p.quantize(base)
        if static:
            tag, _, n = static.partition(":")
            if tag != "static":
                raise ValueError(f"unknown quantize suffix {static!r}")
            p.calibrate_quant(steps=int(n) if n else 4, **(calib_kw or {}))
    return p


def make_embed_fn_u8(arcface, policy=None):
    """uint8 (B, H, W, 3) images of any square size (numpy or a tensor) →
    L2-normalised ArcFace embeddings (B, F) on the card: resize to 112²,
    normalise to [-1, 1], the port's IResNet."""
    from ..core.precision import DEFAULT_POLICY
    from ..ops.image import normalize_to_arcface, resize_bilinear

    policy = policy or DEFAULT_POLICY
    device = arcface.conv1.weight.device

    @torch.inference_mode()
    def embed(x_u8):
        x = torch.as_tensor(x_u8, device=device).float()
        if x.shape[1] != 112 or x.shape[2] != 112:
            x = resize_bilinear(x, (112, 112))
        emb = arcface(normalize_to_arcface(x), policy)
        return emb / emb.norm(dim=-1, keepdim=True)

    return embed


def _psnr(exact_u8: np.ndarray, got_u8: np.ndarray):
    """Per-image PSNR in dB; None where bit-identical (infinite)."""
    diff = exact_u8.astype(np.float64) - got_u8.astype(np.float64)
    mse = (diff * diff).mean(axis=(1, 2, 3))
    out = []
    for m in mse:
        out.append(None if m == 0.0 else round(10.0 * np.log10(255.0 ** 2 / m), 2))
    return out, mse


def compare_modes(pipe, modes: Sequence[str], *, prompts: Optional[List[str]] = None, input_ids=None,
                  seed: int = 0, num_inference_steps: int = 30, guidance_scale: float = 5.0, height: int = 512,
                  width: int = 512, embed_fn=None, seed_floor: bool = False) -> dict:
    """Render (prompts, seed) exact and under each mode spec; see the module
    docstring for the report. `embed_fn` (from `make_embed_fn_u8`) adds the
    identity-cosine rows. `seed_floor=True` adds `report["seed_floor"]`: the
    PSNR between the exact output and a second exact render at seed + 1,
    the PSNR of unrelated samples of the same model; a mode's PSNR means
    something only above it. With `embed_fn` the floor also holds the two
    renders' identity cosine, which a mode's cosine must likewise beat."""
    gen_kw = dict(num_inference_steps=num_inference_steps, guidance_scale=guidance_scale, height=height,
                  width=width, seed=seed, output_type="u8")
    if input_ids is not None:
        gen_kw["input_ids"] = torch.as_tensor(input_ids)
    else:
        if prompts is None:
            raise ValueError("pass prompts or input_ids")
        gen_kw["prompt"] = list(prompts)

    t0 = time.perf_counter()
    exact = np.asarray(pipe(**gen_kw))
    exact_s = time.perf_counter() - t0
    emb_exact = embed_fn(exact).cpu().numpy() if embed_fn is not None else None

    report = {
        "config": {"steps": num_inference_steps, "guidance_scale": guidance_scale, "height": height,
                   "width": width, "seed": seed, "n_images": int(exact.shape[0]),
                   "scheduler": pipe.scheduler_kind},
        "exact": {"batch_s": round(exact_s, 3)},
        "modes": {},
    }
    if seed_floor:
        other = np.asarray(pipe(**{**gen_kw, "seed": seed + 1}))
        fl_psnr, _ = _psnr(exact, other)
        fl_finite = [v for v in fl_psnr if v is not None]
        report["seed_floor"] = {
            "psnr_min": min(fl_finite) if fl_finite else None,
            "psnr_mean": round(float(np.mean(fl_finite)), 2) if fl_finite else None,
            "seeds": [seed, seed + 1],
        }
        if emb_exact is not None:  # the identity cosine of unrelated samples: parity-all's identity floor
            cos = (emb_exact * embed_fn(other).cpu().numpy()).sum(axis=-1)
            report["seed_floor"]["identity_cos_min"] = round(float(cos.min()), 4)
            report["seed_floor"]["identity_cos_mean"] = round(float(cos.mean()), 4)
    calib_kw = dict(height=height, width=width, guidance_scale=guidance_scale)
    if input_ids is not None:
        calib_kw["input_ids"] = torch.as_tensor(input_ids)
    else:
        calib_kw["prompt"] = list(prompts)
    for spec in modes:
        call_kwargs, quantize = parse_mode(spec)
        p = _sibling_pipe(pipe, quantize, calib_kw, attn_impl=call_kwargs.pop("attn_impl", None),
                          scheduler_kind=call_kwargs.pop("scheduler_kind", None))
        t0 = time.perf_counter()
        # scheduler=dpm:N overrides the report's step count for this mode
        got = np.asarray(p(**{**gen_kw, **call_kwargs}))
        mode_s = time.perf_counter() - t0
        psnr, mse = _psnr(exact, got)
        finite = [v for v in psnr if v is not None]
        entry = {
            "batch_s": round(mode_s, 3),
            "psnr_db": psnr,
            "psnr_min": min(finite) if finite else None,
            "psnr_mean": round(float(np.mean(finite)), 2) if finite else None,
            "identical_frac": round(float((mse == 0.0).mean()), 3),
        }
        if emb_exact is not None:
            cos = (emb_exact * embed_fn(got).cpu().numpy()).sum(axis=-1)
            entry["identity_cos"] = [round(float(c), 4) for c in cos]
            entry["identity_cos_min"] = round(float(cos.min()), 4)
            entry["identity_cos_mean"] = round(float(cos.mean()), 4)
        report["modes"][spec] = entry
    return report
