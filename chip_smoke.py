"""Drive the PyTorch port's txt2img main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final result line:
  1. environment: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: every kernel under faceposegenerator_tpu_torch/csrc, with nvcc;
  3. kernels against plain: each kernel at every shape the main path gives
     it, bf16 unit-normal inputs from a seed, against its plain PyTorch
     version in fp32 on the same inputs (max abs err <= 2e-2, mean <= 2e-3),
     timed beside that plain version, `scaled_dot_product_attention` (the
     library yardstick, used nowhere in the port) and the card's bound;
  4. pipeline: StableDiffusionPipeline.from_random at SD2.1-base widths in
     bf16 with a rank-4 UNet LoRA, first against its own plain-attention path
     on a small input, then 3 requests at batch 8, 512², 30 DDPM steps,
     CFG 5.0, swapping the LoRA before the third; each request must launch
     the d=64 kernel 960 times and the wide kernel once.
The line before the last is a JSON object with one entry per kernel; the
last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

MAX_ERR, MEAN_ERR = 2e-2, 2e-3
# (name, B, H, Sq, Skv, D, launches per request) at the main-path op point:
# batch 8 under CFG is 16 UNet rows; 30 steps; the VAE decodes 8 images.
SHAPES = [
    ("self L0", 16, 5, 4096, 4096, 64, 150),
    ("self L1", 16, 10, 1024, 1024, 64, 150),
    ("self L2", 16, 20, 256, 256, 64, 150),
    ("self mid", 16, 20, 64, 64, 64, 30),
    ("cross L0", 16, 5, 4096, 77, 64, 150),
    ("cross L1", 16, 10, 1024, 77, 64, 150),
    ("cross L2", 16, 20, 256, 77, 64, 150),
    ("cross mid", 16, 20, 64, 77, 64, 30),
    ("vae mid", 8, 1, 4096, 4096, 512, 1),
]
# dense bf16 tensor-core FLOP/s and memory bytes/s, from NVIDIA's data sheets
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H100 NVL": (835e12, 3.9e12), "H100": (989e12, 3.35e12)}


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    fail(f"no peak rates known for {name!r}")


def time_ms(fn, torch, target_ms: float = 200.0) -> float:
    """Mean device time of fn() over repeated launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    n = max(3, min(100, int(target_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def check_kernels(torch, fa, card):
    import torch.nn.functional as F

    peak_flops, peak_bw = peaks(card)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, b, h, sq, skv, d, per_req in SHAPES:
        kernel = fa.flash_fwd_d64 if d == 64 else fa.flash_fwd_wide
        name = "flash_fwd_d64" if d == 64 else "flash_fwd_wide"
        if sq == skv:  # self-attention: strided views of one fused q/k/v projection
            qkv = torch.randn(b, sq, 3, h, d, generator=g, device="cuda").to(torch.bfloat16)
            q, k, v = qkv.unbind(2)
        else:
            q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(torch.bfloat16)
            k, v = (torch.randn(b, skv, h, d, generator=g, device="cuda").to(torch.bfloat16) for _ in "kv")
        scale = d**-0.5
        out = kernel(q, k, v, scale)
        torch.cuda.synchronize()
        ref = fa.attention_plain(q.float(), k.float(), v.float(), scale)
        err = (out.float() - ref).abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        del ref, err
        ms = time_ms(lambda: kernel(q, k, v, scale), torch)
        plain_ms = time_ms(lambda: fa.attention_plain(q, k, v, scale), torch)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), torch)
        flops = 4.0 * b * h * sq * skv * d
        nbytes = 2.0 * b * h * d * (2 * sq + 2 * skv)  # q, k, v read once, o written once
        bound_ms = 1e3 * max(flops / peak_flops, nbytes / peak_bw)
        row = dict(kernel=name, shape=label, B=b, H=h, Sq=sq, Skv=skv, D=d, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by="operations" if flops / peak_flops >= nbytes / peak_bw else "bytes",
                   max_abs_err=max_err, mean_abs_err=mean_err, launches_per_request=per_req)
        print("kernel " + json.dumps(row), flush=True)
        rows.append(row)
        if not (max_err <= MAX_ERR and mean_err <= MEAN_ERR):
            fail(f"{name} at {label}: max abs err {max_err} mean {mean_err}")
        del q, k, v, out
        torch.cuda.empty_cache()
    return rows


def make_lora(unet, seed, torch):
    """A rank-4 UNet LoRA with nonzero B."""
    from faceposegenerator_tpu_torch.models.unet2d import init_lora

    g = torch.Generator(device="cuda").manual_seed(seed)
    tree = init_lora(unet, rank=4, generator=g, dtype=torch.bfloat16)

    def fill_b(node):
        if isinstance(node, dict):
            if "b" in node and "a" in node:
                node["b"] = (torch.randn(node["b"].shape, generator=g, device="cuda") * 0.05).to(torch.bfloat16)
            else:
                for v in node.values():
                    fill_b(v)
        elif isinstance(node, list):
            for v in node:
                fill_b(v)

    fill_b(tree)
    return {"unet": tree, "text_encoder": None}


def run_pipeline(torch, fa, card_line):
    import numpy as np

    from faceposegenerator_tpu_torch.diffusion.sampler import SamplerModels
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    t0 = time.time()
    pipe = StableDiffusionPipeline.from_random(seed=0, dtype=torch.bfloat16)
    loras = [make_lora(pipe.nets["unet"], s, torch) for s in (10, 11)]
    pipe.set_lora(loras[0])
    torch.cuda.synchronize()
    print(f"pipeline: built at SD2.1-base widths in bf16 in {time.time() - t0:.1f} s", flush=True)

    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 49408, (8, 77), generator=g)

    # the kernel path against the plain-attention path on a small input
    small = dict(input_ids=ids[:2], num_inference_steps=2, height=128, width=128, seed=5)
    img_k = pipe(**small)
    plain = StableDiffusionPipeline(pipe.nets, SamplerModels(attn_impl="reference"), pipe.policy)
    plain.set_lora(loras[0])
    img_p = plain(**small)
    diff = np.abs(img_k - img_p)
    print(f"pipeline: kernels vs plain attention at 2×128², 2 steps, bf16: image diff max "
          f"{diff.max():.3e} mean {diff.mean():.3e} (limits 1e-1, 1e-2)", flush=True)
    if not (diff.max() <= 1e-1 and diff.mean() <= 1e-2):
        fail("the kernel path and the plain-attention path disagree")

    fa.reset_launch_counts()
    images, secs = [], []
    for r, seed in enumerate((0, 1, 2)):
        if r == 2:
            pipe.set_lora(loras[1])
        before = dict(fa.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.time()
        img = pipe(input_ids=ids, num_inference_steps=30, guidance_scale=5.0, height=512, width=512, seed=seed)
        secs.append(time.time() - t0)
        d64 = fa.LAUNCHES["flash_fwd_d64"] - before["flash_fwd_d64"]
        wide = fa.LAUNCHES["flash_fwd_wide"] - before["flash_fwd_wide"]
        print(f"request {r}: seed {seed}, {secs[-1]:.3f} s, {8 / secs[-1]:.3f} img/s, "
              f"launches d64 {d64} wide {wide} ({card_line})", flush=True)
        if img.shape != (8, 512, 512, 3):
            fail(f"image shape {img.shape}")
        if not (np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0):
            fail("images not finite or outside [0, 1]")
        if d64 != 960 or wide != 1:
            fail(f"request {r} launched d64 {d64} and wide {wide} times, expected 960 and 1")
        images.append(img)
    launches = dict(fa.LAUNCHES)
    if float(np.abs(images[0] - images[1]).max()) < 1e-3:
        fail("images do not differ between seeds")
    if float(np.abs(images[1] - images[2]).max()) < 1e-3:
        fail("images do not change with the LoRA and seed")
    print(f"pipeline: bs8 512² 30-step DDPM CFG 5.0: {secs} s per request; steady "
          f"{min(secs[1:]):.3f} s = {8 / min(secs[1:]):.3f} img/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB ({card_line})", flush=True)
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    try:
        from faceposegenerator_tpu_torch.ops import _build
        from faceposegenerator_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        fail(f"the port package is not importable here: {e}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card_line, flush=True)
    card = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {card}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    t0 = time.time()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.time() - t0:.1f} s", flush=True)
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    rows = check_kernels(torch, fa, card)
    launches = run_pipeline(torch, fa, card_line)

    kernels = []
    for name, replaces in (
        ("flash_fwd_d64", "faceposegenerator_tpu/ops/flash_attention.py:258"),
        ("flash_fwd_wide", "faceposegenerator_tpu/ops/flash_attention.py:104"),
    ):
        mine = [r for r in rows if r["kernel"] == name]
        top = max(mine, key=lambda r: r["bound_ms"])  # the shape with the most work
        if launches[name] == 0:
            fail(f"{name} was not launched on the main path")
        kernels.append(dict(
            name=name, route="cuda", source="faceposegenerator_tpu_torch/csrc/flash_fwd.cu",
            replaces=replaces, launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine), ms=top["ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"], library_ms=top["library_ms"],
            shape=top["shape"],
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
