"""Run phase 17 of chip_smoke.py alone on one CUDA card: the command line
(`faceposegenerator_tpu_torch/cli.py`). It builds the kernels, writes
phase 12's synthetic SD2.1-base directory, runs phase 14 (serving and the
packed sweep: the references phase 17 holds generate and serve to), writes
the files phases 15 and 16 leave (their writers alone, not their runs), and
runs phase 17; it skips everything else.

    python3 perf/torch_cli.py

Exits non-zero on any failed gate; prints what phases 14 and 17 print.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: this needs a CUDA card")
    from faceposegenerator_tpu_torch.ops import _build
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card_line, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.time()
    print(f"build: {sorted(_build.build_all())} in {time.time() - t0:.1f} s", flush=True)
    with chip_smoke.build_dir("sd21_base_synthetic") as model_dir, chip_smoke.build_dir("serving") as work, \
            chip_smoke.build_dir("phase_data") as data:
        t0 = time.time()
        src = StableDiffusionPipeline.from_random(seed=0, dtype=torch.bfloat16)  # phase 12's weights
        chip_smoke.write_sd21_dir(model_dir, src, torch)
        del src
        torch.cuda.empty_cache()
        inputs = chip_smoke.cli_inputs(data)
        chip_smoke._write_embed_tree(inputs["embed_images"])
        chip_smoke._write_fr_data(os.path.dirname(inputs["fr_flat"]), torch)
        chip_smoke._write_quality_sets(os.path.dirname(inputs["quality"]["real"]))
        print(f"inputs written in {time.time() - t0:.1f} s", flush=True)
        _, _, refs = chip_smoke.run_serving(torch, card_line, model_dir, work, float("nan"))
        torch.cuda.empty_cache()
        chip_smoke.run_cli(torch, card_line, model_dir, refs, inputs, float("nan"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
