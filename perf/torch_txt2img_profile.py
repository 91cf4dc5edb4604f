"""Where one txt2img request of the PyTorch port spends its device time.

    python3 perf/torch_txt2img_profile.py [--preset turbo|latency] [--attn flash_int8] [--dtype fp32]
                                          [--tome RATIO] [--decode-chunk N]
    GN_IMPL=pallas GN_CONV_IMPL=pallas python3 perf/torch_txt2img_profile.py [--dtype fp32]

Builds the pipeline as chip_smoke.py does (SD2.1-base widths, bf16, random
weights, rank-4 UNet LoRA), serves one warm-up request at batch 8, 512², 30
DDPM steps, CFG 5.0, then traces one more with torch.profiler. With
`--preset turbo` the pipeline first takes `get_preset("turbo").apply` (dpm,
w8a8+vae, 8 calibration steps at 8×512²) and the requests run its 12 steps
and sampling kwargs; `--attn flash_int8` serves them with the int8
attention. With GN_IMPL and GN_CONV_IMPL at pallas (read when the port is
imported) the requests run the fused GroupNorm configuration: K3 and K4.
With `--dtype fp32` the pipeline is `from_random()` at its default dtype
(fp32 weights and compute, TF32 off) with an fp32 LoRA, and the requests
run 10 steps, as chip_smoke.py's fp32 request does: the fp32 attention
(flash_f32_split, flash_fwd_f32); with the two GroupNorm variables at pallas
as well, chip_smoke.py's fused fp32 request (K3's and K4's fp32 instances,
K4's weight pre-pass gn_conv_f32_split). `--preset latency` serves its op
point, batch 1 (DPM++ 20, DeepCache-3, guidance (3, 13)); `--tome 0.5`
merges L0's tokens with ToMe (`tome_ratio`), `--decode-chunk 2` decodes 2
images at a time, as chip_smoke.py's phase 12 requests do.
Prints the request's wall time, the device's busy and idle share, device
time by category of kernel and the top kernels, and writes the full table
as torch_txt2img_profile[_turbo|_latency][_flash_int8][_fused_gn][_fp32][_tome][_chunk].txt to the output
directory (`out` below).
Needs a CUDA card.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CATEGORIES = [  # first match wins; matched against the kernel's name
    ("int8 dense K7 (qdense)", r"qdense|row_scale"),
    ("int8 attention K8 (flash_int8)", r"flash_int8"),
    ("attention K1 (flash_fwd_d64)", r"flash_fwd_d64"),
    ("gather, scatter, sort (ToMe)", r"gather|scatter|sort"),
    ("attention K2 (flash_fwd_wide)", r"flash_fwd_wide"),
    ("attention fp32 (flash_fwd_f32)", r"flash_fwd_f32"),
    ("attention fp32 split (flash_f32_split)", r"flash_f32_split"),
    ("GroupNorm+SiLU K3 (fused_group_norm)", r"gn_k3_"),
    ("GN+SiLU→conv3x3 K4 (gn_silu_conv3x3)", r"gn_k4_"),
    ("K4 fp32 weight split (gn_conv_f32_split)", r"gn_conv_f32_split"),
    ("convolution", r"conv|fprop|implicit|winograd|nchw|nhwc"),
    ("matmul", r"gemm|cutlass|xmma|sm90_|matmul|cublas|nvjet"),
    ("normalisation and softmax", r"norm|welford|softmax|reduce"),
    ("elementwise, copies, concat", r"elementwise|vectorized|copy|cat|index|fill|unrolled|gelu|silu"),
]


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    import argparse

    import chip_smoke
    from faceposegenerator_tpu_torch.diffusion.sampler import SamplerModels
    from faceposegenerator_tpu_torch.ops.fused_gn import gn_impl
    from faceposegenerator_tpu_torch.ops.fused_gn_conv import gn_conv_impl
    from faceposegenerator_tpu_torch.pipelines.presets import get_preset
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["turbo", "latency"], default=None)
    ap.add_argument("--attn", choices=["auto", "flash_int8"], default="auto")
    ap.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16")
    ap.add_argument("--tome", type=float, default=0.0)
    ap.add_argument("--decode-chunk", type=int, default=None)
    args = ap.parse_args()
    fp32 = args.dtype == "fp32"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    pipe = StableDiffusionPipeline.from_random(seed=0, models=SamplerModels(attn_impl=args.attn),
                                               **({} if fp32 else {"dtype": torch.bfloat16}))
    pipe.set_lora(chip_smoke.make_lora(pipe.nets["unet"], 10, torch, torch.float32 if fp32 else None))
    batch = 1 if args.preset == "latency" else 8
    ids = torch.randint(0, 49408, (batch, 77), generator=torch.Generator().manual_seed(1))
    steps, kw = (10 if fp32 else 30), {}
    if args.preset:
        preset = get_preset(args.preset)
        calib = torch.randint(0, 49408, (8, 77), generator=torch.Generator().manual_seed(2))
        steps, kw = preset.steps, preset.apply(pipe, input_ids=calib)
    if args.tome:
        kw["tome_ratio"] = args.tome
    if args.decode_chunk:
        kw["decode_chunk"] = args.decode_chunk
    gn = f"GN_IMPL={gn_impl()} GN_CONV_IMPL={gn_conv_impl()}"
    print(f"preset {args.preset}, attention {args.attn}, {args.dtype}, {gn}: batch {batch}, {steps} steps, "
          f"kwargs {kw}", flush=True)

    def request(seed):
        torch.cuda.synchronize()
        t0 = time.time()
        pipe(input_ids=ids, num_inference_steps=steps, guidance_scale=5.0, height=512, width=512, seed=seed, **kw)
        torch.cuda.synchronize()
        return time.time() - t0

    warm = request(0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = request(1)

    by_kernel = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] += e.time_range.elapsed_us() / 1e3
    busy = sum(by_kernel.values())
    if busy == 0:
        print("FAIL: the profiler saw no device time", file=sys.stderr)
        return 1
    by_cat = defaultdict(float)
    for name, ms in by_kernel.items():
        cat = next((c for c, rx in CATEGORIES if re.search(rx, name, re.I)), "other")
        by_cat[cat] += ms
    wall_ms = 1e3 * wall
    print(f"request: warm-up {warm:.3f} s, profiled {wall:.3f} s; device busy {busy:.1f} ms = "
          f"{100 * busy / wall_ms:.1f}% of wall, idle {100 * (1 - busy / wall_ms):.1f}% ({card})")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:32s} {ms:9.1f} ms  {100 * ms / busy:5.1f}% of device time")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    print("top kernels:")
    for name, ms in top[:15]:
        print(f"  {ms:9.1f} ms  {name[:110]}")
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    fused = "fused_gn" if gn_impl() == gn_conv_impl() == "pallas" else None
    suffix = "".join(f"_{x}" for x in (args.preset, None if args.attn == "auto" else args.attn, fused,
                                        "fp32" if fp32 else None, "tome" if args.tome else None,
                                        "chunk" if args.decode_chunk else None) if x)
    (out / f"torch_txt2img_profile{suffix}.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    print(json.dumps({"card": card, "preset": args.preset, "attn": args.attn, "dtype": args.dtype, "gn": gn,
                      "batch": batch, "tome": args.tome, "decode_chunk": args.decode_chunk, "wall_ms": wall_ms,
                      "device_busy_ms": busy,
                      "idle_share": 1 - busy / wall_ms, "by_category_ms": dict(by_cat)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
