"""Seconds per txt2img request of two copies of the port, timed in one call
on one card, in turns.

    python3 perf/torch_txt2img_compare.py --other build/parent [--rounds 2] [--path latency]

`--other` is the root of another checkout (for example the parent commit,
unpacked with `git archive` into a directory that .gitignore lists). Each
copy runs in a fresh process of its own, in the order other, this, this,
other (repeated `--rounds` times): it builds its own kernels under its own
`build/kernels` and runs `--path`:

  - `txt2img` (the default): its `chip_smoke.run_pipeline`, chip_smoke.py's
    phase 4 (from_random at SD2.1-base widths in bf16 with a rank-4 LoRA, a
    kernel-against-plain check at a small size, then 3 requests at batch 8,
    512², DDPM 30, CFG 5.0, each to a synchronising copy);
  - `latency`: the latency preset at batch 1 (DPM++ 20, DeepCache-3,
    `cfg_interval` (3, 13)) on the same pipeline, run eagerly (inside
    `core.compile.disable()` where the copy has it): two warm-up requests,
    then 5 requests with the rank-4 LoRA and 5 without, alternating.

Prints each run's s/request and each copy's median of its steady requests
(all but each run's first for `txt2img`; every timed request for
`latency`, by LoRA), with the card's name and power limit, and writes the
rows to chiprun_out/torch_txt2img_compare.json. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "chiprun_out"

# runs inside the copy's root: chip_smoke's phase 4
CHILD = r"""
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from faceposegenerator_tpu_torch.ops import _build, flash_attention as fa
_build.build_all()
cs.run_pipeline(torch, fa, "")
"""

# runs inside the copy's root: the latency preset, eagerly
CHILD_LATENCY = r"""
import contextlib, json, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from faceposegenerator_tpu_torch.data.tokenizer import CLIPTokenizer
from faceposegenerator_tpu_torch.ops import _build
from faceposegenerator_tpu_torch.pipelines.presets import get_preset
from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline
try:
    from faceposegenerator_tpu_torch.core.compile import disable
except ImportError:  # a copy without core/compile.py runs every call eagerly
    disable = contextlib.nullcontext
_build.build_all()
pipe = StableDiffusionPipeline.from_random(seed=0, dtype=torch.bfloat16,
                                           tokenizer=CLIPTokenizer(*cs.synthetic_vocab([])))
lora = cs.make_lora(pipe.nets["unet"], 10, torch)
kw = get_preset("latency").apply(pipe)

def request(adapter):
    torch.cuda.synchronize()
    t0 = time.time()
    img = pipe(cs.PROMPTS[0], negative_prompt=cs.NEGATIVE_PROMPT, seed=0, num_inference_steps=20, height=512,
               width=512, lora=adapter, output_type="pt", **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(img).all())
    return time.time() - t0

secs = {"lora": [], "none": []}
with disable():
    request(lora), request(None)
    for _ in range(5):
        secs["lora"].append(request(lora))
        secs["none"].append(request(None))
print("latency " + json.dumps(secs))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--path", choices=("txt2img", "latency"), default="txt2img")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card_line, flush=True)
    trees = {"other": Path(args.other).resolve(), "this": REPO}
    rows = []
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            child = CHILD if args.path == "txt2img" else CHILD_LATENCY
            run = subprocess.run([sys.executable, "-c", child], cwd=trees[name], capture_output=True, text=True,
                                 timeout=900)
            if run.returncode != 0:
                print(run.stdout[-3000:], run.stderr[-3000:], file=sys.stderr)
                print(f"FAIL: the {name} copy exited with {run.returncode}", file=sys.stderr)
                return 1
            if args.path == "txt2img":
                secs = {"steady": [float(s) for s in re.findall(r"^request \d+: seed \d+, ([\d.]+) s",
                                                                run.stdout, re.M)][1:]}
            else:
                secs = json.loads(re.search(r"^latency (.*)$", run.stdout, re.M).group(1))
            rows.append({"tree": name, "s_per_request": secs})
            print(f"{name}: s/request {json.dumps(secs)} ({card_line})", flush=True)
    for name in ("other", "this"):
        for kind in rows[0]["s_per_request"]:
            steady = [s for r in rows if r["tree"] == name for s in r["s_per_request"][kind]]
            print(f"{name}: median {kind} s/request {statistics.median(steady):.3f} over {len(steady)} requests "
                  f"({card_line})", flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "torch_txt2img_compare.json").write_text(json.dumps({"card": card_line, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
