"""K4 (`gn_silu_conv3x3`, GroupNorm+SiLU→conv3x3) of two copies of the port,
timed in one call on one card, in turns; with `--fp32`, its fp32 instance
(`gn_silu_conv3x3_f32`) instead.

    python3 perf/torch_conv_compare.py --other build/parent [--tag parent] [--fp32]

`--other` is the root of another checkout (for example the parent commit,
unpacked with `git archive` into a directory that .gitignore lists). Each
copy runs in a fresh process of its own, in the order other, this, this,
other: it builds its own kernels under its own `build/kernels`, then runs
its `chip_smoke.check_conv` at the fused txt2img request's conv shapes
(gated against the plain version and timed beside it, the default route's
plain GroupNorm+SiLU with cuDNN's conv, and the bound, as chip_smoke.py
does; CUDA events over back-to-back calls), and traces 20 calls a shape
with torch.profiler to keep the kernels' own device time a call (the conv
kernel and the two statistics launches). Prints the table with both copies'
best times and writes every row to chiprun_out/torch_conv_compare[_TAG].json.
With `--fp32` each copy runs chip_smoke's `check_conv_f32` instead (fp32 x
and weights, gated against the plain version in fp32 with TF32 off, timed
beside it, plain GroupNorm+SiLU with cuDNN's fp32 conv and the 3xTF32
bound), and its profiler table holds the fp32 kernels (the conv, its
statistics launches and, where the copy has it, the weight pre-pass).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "chiprun_out"

# runs inside the copy's root: chip_smoke's K4 rows of phase 8 (FP32 False)
# or of phase 11 (FP32 True)
CHILD = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from faceposegenerator_tpu_torch.ops import _build, fused_gn_conv as fgc
FP32 = {fp32}
_build.build_all()
card = torch.cuda.get_device_name(0)
shapes = getattr(cs, "CONV_F32_SHAPES", cs.CONV_SHAPES) if FP32 else cs.CONV_SHAPES
rows = (cs.check_conv_f32 if FP32 else cs.check_conv)(torch, card, shapes, "request")
ptxas = _build.ptxas_report("gn_conv") if hasattr(_build, "ptxas_report") else []

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

def device_ms(fn, n=20):
    # K4's device time a call: the conv kernel and the statistics launches
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and ("gn_k4" in e.name or "gn_conv_f32_split" in e.name):
            name = next(k for k in ("gn_k4_conv", "gn_k4_partial", "gn_k4_fold", "gn_conv_f32_split") if k in e.name)
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    return out

g = torch.Generator(device="cuda").manual_seed(7)
device = {}
for label, n, h, w, cin, cout, _ in shapes:
    x, gamma, beta, conv = cs._conv_inputs(torch, g, n, h, w, cin, cout)
    if FP32:
        x, conv = x.float(), conv.float()
        conv.weight.data = conv.weight.data.contiguous(memory_format=torch.channels_last)
    device[f"{label} N{n}"] = device_ms(lambda: fgc.gn_silu_conv3x3(x, gamma, beta, conv, 32))
print("RESULT " + json.dumps({"rows": rows, "ptxas": ptxas, "device": device}))
"""


def run(root: Path, fp32: bool) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD.replace("{fp32}", str(fp32))], cwd=root,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"FAIL in {root}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    line = next(l for l in proc.stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="root of the other checkout (e.g. the parent commit)")
    ap.add_argument("--tag", default="", help="suffix of the output file's name")
    ap.add_argument("--fp32", action="store_true", help="compare K4's fp32 instance instead")
    args = ap.parse_args()
    other = Path(args.other).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card_line = smi.stdout.strip()
    print(card_line, flush=True)
    runs = []
    for label, root in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
        runs.append(dict(copy=label, root=str(root), **run(root, args.fp32)))
        print(f"done: {label} ({root})", flush=True)
    best: dict = {}
    for r in runs:
        for row in r["rows"]:
            slot = best.setdefault(f"{row['shape']} N{row['N']}", {})
            if r["copy"] not in slot or row["ms"] < slot[r["copy"]]["ms"]:
                slot[r["copy"]] = row
    print(f"{'shape':26s} {'other ms':>9s} {'this ms':>9s} {'this/other':>10s} {'library':>8s} {'bound':>7s} "
          f"{'TFLOP/s':>8s} {'dev other':>9s} {'dev this':>9s}")
    for k, slot in best.items():
        ro, rt = slot["other"], slot["this"]
        dev = {c: min(sum(r["device"][k].values()) for r in runs if r["copy"] == c) for c in ("other", "this")}
        flops = 2.0 * rt["N"] * rt["H"] * rt["W"] * rt["Cout"] * 9 * rt["Cin"]
        print(f"{k:26s} {ro['ms']:9.4f} {rt['ms']:9.4f} {rt['ms'] / ro['ms']:10.3f} {rt['library_ms']:8.4f} "
              f"{rt['bound_ms']:7.4f} {flops / rt['ms'] * 1e-9:8.1f} {dev['other']:9.4f} {dev['this']:9.4f}")
    OUT.mkdir(exist_ok=True)
    name = f"torch_conv_compare{'_' + args.tag if args.tag else ''}.json"
    (OUT / name).write_text(json.dumps({"card": card_line, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
