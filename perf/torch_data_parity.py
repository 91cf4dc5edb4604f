"""Run phase 20 of chip_smoke.py alone on one CUDA card: the data layer
(the native JPEG/RecordIO loader, `MXFaceDataset`, the RGBN path, the
conditional layouts, native decode in the streaming embed) and the parity
runbook (`cli parity-all`, its first leg `cli parity --full_chain`), then the
FLOP counts.
It builds the kernels, writes phase 12's synthetic SD2.1-base directory and
the files phase 15 leaves (its writers alone, not its run), and runs phase
20; it skips everything else, so the .rec driver's s/step prints without
phase 15's folder driver beside it, the RGBN bench times the 3-channel
step itself, and the request's FLOP rate prints without phase 4's
s/request.

    python3 perf/torch_data_parity.py

Exits non-zero on any failed gate; prints what phase 20 prints.
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
    with chip_smoke.build_dir("sd21_base_synthetic") as model_dir, chip_smoke.build_dir("phase_data") as data:
        t0 = time.time()
        src = StableDiffusionPipeline.from_random(seed=0, dtype=torch.bfloat16)  # phase 12's weights
        chip_smoke.write_sd21_dir(model_dir, src, torch)
        del src
        torch.cuda.empty_cache()
        inputs = chip_smoke.cli_inputs(data)
        chip_smoke._write_embed_tree(inputs["embed_images"])
        chip_smoke._write_fr_data(os.path.dirname(inputs["fr_flat"]), torch)
        print(f"inputs written in {time.time() - t0:.1f} s", flush=True)
        launches = chip_smoke.run_data_parity(torch, card_line, model_dir, data)
    print(f"phase 20 launches {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
