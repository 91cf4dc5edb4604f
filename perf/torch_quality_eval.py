"""Run phase 16 of chip_smoke.py alone on one CUDA card: dgm-eval with
DINOv2 (all metrics, GradCAM), the other ten encoders, make_heatmap_fn, the
encoder gates and PyEER. It builds the kernels (the ViT encoders run K1
and, under a gradient, K5), checks them at phase 16's shapes as phase 3
does, and skips everything else of phases 2-15.

    python3 perf/torch_quality_eval.py

Exits non-zero on any failed gate; prints what phase 16 prints and the
kernel rows of phase 3 at its shapes.
"""

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: this needs a CUDA card")
    from faceposegenerator_tpu_torch.ops import _build
    from faceposegenerator_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card_line, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"build: {sorted(_build.build_all())}", flush=True)
    card = torch.cuda.get_device_name(0)
    chip_smoke.check_quality_kernels(torch, fa, card)
    _, measured = chip_smoke.run_quality_eval(torch, card_line)
    print("quality: launches a run at the kernel rows' shapes "
          + json.dumps({f"{kernel} {shape}": n for (kernel, shape), n in measured.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
