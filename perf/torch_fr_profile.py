"""Where the FR train step and the MTCNN detect of the PyTorch port spend
their time on the card.

    python3 perf/torch_fr_profile.py

The FR step at chip_smoke.py phase 15's bench op point (iresnet50 +
AdaFace, batch 128, 112², 1000 classes, fp32 params, bf16 compute): two
warm-up steps, ten timed with the host clock around a synchronised step
(min, median, max), one traced with torch.profiler: the device's busy and
idle share, device time by category of kernel, the top kernels. Then one
`MTCNN.detect_batch` of 64 textured bright-square images of 250² (the embed
bench's batch, `chip_smoke._textured_face`), timed and traced the same way:
its device busy share says how host-bound the cascade is. The full tables go
to chiprun_out/torch_fr_profile_{step,detect}.txt. Needs a CUDA card.
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
    ("convolution (fwd and bwd)", r"conv|fprop|dgrad|wgrad|implicit|winograd|nchw|nhwc"),
    ("matmul", r"gemm|cutlass|xmma|sm90_|matmul|cublas|nvjet"),
    ("reductions (BatchNorm statistics, norms, softmax)", r"norm|welford|softmax|reduce"),
    ("optimizer (SGD foreach)", r"multi_tensor|foreach"),
    ("elementwise, copies, casts", r"elementwise|vectorized|copy|cat|index|fill|unrolled|where"),
]


def _profile(torch, fn, warm, n):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        return time.time() - t0

    warm_s = [run() for _ in range(warm)]
    timed = sorted(run() for _ in range(n))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    by_kernel = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] += e.time_range.elapsed_us() / 1e3
    return warm_s, timed, wall, by_kernel, prof


def _report(label, card, warm_s, timed, wall, by_kernel, prof, per_s):
    busy = sum(by_kernel.values())
    if busy == 0:
        print("FAIL: the profiler saw no device time", file=sys.stderr)
        sys.exit(1)
    by_cat = defaultdict(float)
    for name, ms in by_kernel.items():
        by_cat[next((c for c, rx in CATEGORIES if re.search(rx, name, re.I)), "other")] += ms
    med = 1e3 * timed[len(timed) // 2]
    print(f"{label}: warm-up {[round(s, 3) for s in warm_s]} s; {len(timed)} untraced: min {timed[0]:.4f} median "
          f"{med / 1e3:.4f} max {timed[-1]:.4f} s ({per_s / med * 1e3:.1f} img/s at the median); traced "
          f"{wall:.4f} s; device busy {busy:.1f} ms = {100 * busy / med:.1f}% of the median, idle "
          f"{100 * (1 - busy / med):.1f}% ({card})", flush=True)
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:52s} {ms:9.2f} ms  {100 * ms / busy:5.1f}% of device time")
    print("top kernels:")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:9.2f} ms  {name[:110]}")
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"torch_fr_profile_{label}.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    return {"median_ms": med, "untraced_ms": [1e3 * t for t in timed], "device_busy_ms": busy,
            "idle_share": 1 - busy / med, "by_category_ms": dict(by_cat)}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from faceposegenerator_tpu_torch.core.precision import DEFAULT_POLICY
    from faceposegenerator_tpu_torch.core.rng import train_step_generator
    from faceposegenerator_tpu_torch.models import mtcnn
    from faceposegenerator_tpu_torch.training import fr

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    op = chip_smoke.FR_BENCH
    cfg = fr.FRConfig(network=op["network"], loss="AdaFace", batch_size=op["batch"], num_classes=op["classes"])
    params, state = fr.init_train_state(cfg, 0, "cuda")
    opt = fr.make_optimizer(cfg)
    opt_state, step = opt.init(params), fr.make_train_step(cfg, opt, DEFAULT_POLICY)
    g = torch.Generator(device="cuda").manual_seed(12)
    batch = {"images": torch.rand(op["batch"], op["res"], op["res"], 3, generator=g, device="cuda") * 2 - 1,
             "labels": torch.randint(0, op["classes"], (op["batch"],), generator=g, device="cuda")}
    count = [0]

    def one_step():
        nonlocal params, state, opt_state
        params, state, opt_state, m = step(params, state, opt_state, batch,
                                           train_step_generator(0, count[0], "cuda"))
        count[0] += 1

    torch.cuda.reset_peak_memory_stats()
    rows = {"step": _report("step", card, *_profile(torch, one_step, 2, 10), op["batch"])}
    rows["step"]["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del params, state, opt_state
    torch.cuda.empty_cache()

    rng = np.random.default_rng(14)
    emb = chip_smoke.EMBED_BENCH
    imgs = np.stack([chip_smoke._textured_face(rng, emb["res"], int(rng.integers(60, 120)))
                     for _ in range(emb["batch"])]).astype(np.float32)
    det = mtcnn.MTCNN(mtcnn.brightness_cascade_params())
    rows["detect"] = _report("detect", card, *_profile(torch, lambda: det.detect_batch(imgs), 1, 3), emb["batch"])
    print(json.dumps({"card": card, **rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
