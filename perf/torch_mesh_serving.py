"""Run phase 19 of chip_smoke.py alone on one CUDA card: the servers over a
mesh (`SamplerServer(mesh=)`, `RollingServer(mesh=)`, `sample_parallel(mesh=)`,
`serve --data_parallel N`) and MoCo over the data axis. It builds the
kernels, writes phase 12's synthetic SD2.1-base directory, and runs phase
19, which then starts the one-process `serve` itself for the reference PNG
(in chip_smoke.py phase 17 gives it). It first checks `ops.norms.layer_norm`'s
mixed-dtype path on the card (`chip_smoke.check_layer_norm`).

    python3 perf/torch_mesh_serving.py

Exits non-zero on any failed gate; prints what phase 19 prints.
"""

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
    from faceposegenerator_tpu_torch.ops import flash_attention as fa
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card_line, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.time()
    print(f"build: {sorted(_build.build_all())} in {time.time() - t0:.1f} s", flush=True)
    chip_smoke.check_layer_norm(torch)
    with chip_smoke.build_dir("sd21_base_synthetic") as model_dir:
        t0 = time.time()
        src = StableDiffusionPipeline.from_random(seed=0, dtype=torch.bfloat16)  # phase 12's weights
        chip_smoke.write_sd21_dir(model_dir, src, torch)
        del src
        torch.cuda.empty_cache()
        print(f"SD2.1-base directory written in {time.time() - t0:.1f} s", flush=True)
        launches, _ = chip_smoke.run_mesh_serving(torch, fa, torch.cuda.get_device_name(0), card_line, model_dir)
    print(f"phase 19 launches {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
