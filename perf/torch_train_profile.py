"""Where one ID-Booth train step of the PyTorch port spends its device time.

    python3 perf/torch_train_profile.py
    GN_IMPL=pallas GN_CONV_IMPL=pallas python3 perf/torch_train_profile.py
    python3 perf/torch_train_profile.py --text-lora

Builds the train op point as chip_smoke.py does (SD2.1-base widths, ArcFace
r100, random bf16 frozen weights, fp32 rank-4 LoRA, batch 4 with prior
preservation = 8 images of 512², triplet_prior), runs two warm-up steps,
times ten more with the host clock around a synchronised step (min, median
and max: the step is partly host-bound, so it varies between processes),
then traces one with torch.profiler. Prints the step's wall time, the device's busy and
idle share, device time by category of kernel and the top kernels, and
writes the full table as torch_train_profile[_fused_gn].txt to the output
directory (`out` below).
With GN_IMPL and GN_CONV_IMPL at pallas (read when the port is imported) the
steps run the fused GroupNorm configuration: K3 and K4 forward. With
`--text-lora` the step also trains the text encoder's LoRA
(`train_text_encoder=True`: CLIP runs with its gradient), written as
torch_train_profile_text_lora.txt. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
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
    ("attention fwd K1 (flash_fwd_d64)", r"flash_fwd_d64"),
    ("attention fwd K2 (flash_fwd_wide)", r"flash_fwd_wide"),
    ("attention bwd K5 (flash_bwd_d64_*)", r"flash_bwd_d64"),
    ("attention bwd K6 (flash_bwd_wide_*)", r"flash_bwd_wide"),
    ("GroupNorm+SiLU K3 (fused_group_norm)", r"gn_k3_"),
    ("GN+SiLU→conv3x3 K4 (gn_silu_conv3x3)", r"gn_k4_"),
    ("convolution (fwd and bwd)", r"conv|fprop|dgrad|wgrad|implicit|winograd|nchw|nhwc"),
    ("matmul", r"gemm|cutlass|xmma|sm90_|matmul|cublas|nvjet"),
    ("normalisation and softmax (fwd and bwd)", r"norm|welford|softmax|reduce"),
    ("optimizer (AdamW)", r"adam|multi_tensor|foreach"),
    ("elementwise, copies, concat", r"elementwise|vectorized|copy|cat|index|fill|unrolled|gelu|silu"),
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--text-lora", action="store_true", help="train the text encoder's LoRA too")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from faceposegenerator_tpu_torch.core.rng import train_step_generator
    from faceposegenerator_tpu_torch.ops.fused_gn import gn_impl
    from faceposegenerator_tpu_torch.ops.fused_gn_conv import gn_conv_impl
    from faceposegenerator_tpu_torch.training import idbooth

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    gn = f"GN_IMPL={gn_impl()} GN_CONV_IMPL={gn_conv_impl()}" + (" text LoRA" if args.text_lora else "")
    print(card, gn, flush=True)
    policy, models, frozen, cfg = chip_smoke.build_train_op_point(torch)
    cfg = cfg.replace(train_text_encoder=args.text_lora)
    trainable = idbooth.init_trainable(4, cfg, models, frozen["unet"], frozen["text_encoder"])
    optimizer = idbooth.make_optimizer(cfg, total_steps=1000)
    opt_state = optimizer.init(trainable)
    step = idbooth.make_train_step(cfg, models, optimizer, policy=policy)
    batch = chip_smoke.make_train_batch(torch, 8, 512, seed=5)
    count = [0]

    def run():
        nonlocal trainable, opt_state
        torch.cuda.synchronize()
        t0 = time.time()
        trainable, opt_state, metrics = step(trainable, opt_state, frozen, batch,
                                             train_step_generator(cfg.seed, count[0], "cuda"))
        float(metrics["loss"])
        torch.cuda.synchronize()
        count[0] += 1
        return time.time() - t0

    warm = [run() for _ in range(2)]
    timed = sorted(run() for _ in range(10))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()

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
    steady_ms = 1e3 * timed[len(timed) // 2]
    print(f"step: warm-up {warm} s; 10 untraced steps min {timed[0]:.3f} median {steady_ms / 1e3:.3f} max "
          f"{timed[-1]:.3f} s = {4e3 / steady_ms:.3f} train img/s at the median; traced {wall:.3f} s; "
          f"device busy {busy:.1f} ms = {100 * busy / steady_ms:.1f}% of the median step, idle "
          f"{100 * (1 - busy / steady_ms):.1f}% ({card})")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:42s} {ms:9.1f} ms  {100 * ms / busy:5.1f}% of device time")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    print("top kernels:")
    for name, ms in top[:20]:
        print(f"  {ms:9.1f} ms  {name[:110]}")
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    suffix = ("_fused_gn" if gn_impl() == gn_conv_impl() == "pallas" else "") + ("_text_lora" if args.text_lora else "")
    (out / f"torch_train_profile{suffix}.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=80))
    print(json.dumps({"card": card, "gn": gn, "untraced_step_ms": [1e3 * t for t in timed],
                      "median_step_ms": steady_ms,
                      "traced_step_ms": 1e3 * wall,
                      "device_busy_ms": busy, "idle_share": 1 - busy / steady_ms,
                      "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "by_category_ms": dict(by_cat)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
