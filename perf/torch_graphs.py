"""Run phase 21 of chip_smoke.py alone on one CUDA card: the txt2img
request, the latency preset, the rolling server and the ID-Booth train step,
each eagerly (`core.compile.disable()`) and as captured CUDA graphs from the
same inputs. It builds the kernels and runs phase 21; nothing else.

    python3 perf/torch_graphs.py

Exits non-zero on any failed gate; prints what phase 21 prints.
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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card_line, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.time()
    print(f"build: {sorted(_build.build_all())} in {time.time() - t0:.1f} s under {_build.build_dir()}", flush=True)
    launches = chip_smoke.run_graphs(torch, card_line)
    print(f"phase 21 launches {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
