"""Run phase 15 of chip_smoke.py alone on one CUDA card: the FR gate, the
FR bench and driver, embedding extraction with its gates, alignment and the
face backbones. That path builds no kernel, so this skips phases 1-14.

    python3 perf/torch_identity_stack.py

Exits non-zero on any failed gate; prints what phase 15 prints.
"""

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: this needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card_line, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    chip_smoke.run_identity_stack(torch, card_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
