"""Run phase 18 of chip_smoke.py alone on one CUDA card: distribution
(`core/dist.py`, `core/mesh.py`, `parallel/tp.py`, the data-parallel
sampler and trainers, the pod rehearsal). It builds the kernels, writes
phase 12's synthetic SD2.1-base directory, and runs phase 18: the NCCL rank
at world size 1 through `generate --data_parallel 1`, K1 at the
tensor-parallel shapes, and the gloo rig of two ranks sharing the card.

    python3 perf/torch_distribution.py [--train-seeds N]

`--train-seeds N` runs the rig's two data-parallel train steps (and rank
0's one-process reference) for N LoRA inits and draws, the first of them
phase 18's own, and prints the LoRA update cosine's spread over them.
Exits non-zero on any failed gate; prints what phase 18 prints.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train-seeds", type=int, default=1)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: this needs a CUDA card")
    from faceposegenerator_tpu_torch.ops import _build
    from faceposegenerator_tpu_torch.ops import flash_attention as fa
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card_line, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.time()
    print(f"build: {sorted(_build.build_all())} in {time.time() - t0:.1f} s", flush=True)
    with chip_smoke.build_dir("sd21_base_synthetic") as model_dir:
        t0 = time.time()
        src = StableDiffusionPipeline.from_random(seed=0, dtype=torch.bfloat16)  # phase 12's weights
        chip_smoke.write_sd21_dir(model_dir, src, torch)
        del src
        torch.cuda.empty_cache()
        print(f"SD2.1-base directory written in {time.time() - t0:.1f} s", flush=True)
        launches, _, _ = chip_smoke.run_distribution(torch, fa, torch.cuda.get_device_name(0), card_line, model_dir,
                                                     float("nan"), float("nan"), train_seeds=args.train_seeds)
    print(f"phase 18 launches {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
