"""K1 and K5 (the d = 64 flash-attention kernels) of two copies of the port,
timed in one call on one card, in turns; with `--fp32`, their fp32 instances
(flash_fwd_f32, flash_bwd_f32_dkv/_dq) instead; with `--wide`, K2
(flash_fwd_wide) at its VAE shapes.

    python3 perf/torch_flash_compare.py --other build/parent [--tag parent] [--fp32 | --wide]

`--other` is the root of another checkout (for example the parent commit,
unpacked with `git archive` into a directory that .gitignore lists). Each
copy runs in a fresh process of its own, in the order other, this, this,
other: it builds its own kernels under its own `build/kernels`, then runs
its `chip_smoke.check_kernels` at K1's txt2img shapes and at its train
shapes with the log-sum-exp, and `chip_smoke.check_backward` at K5's train
shapes (each shape gated against the plain version and timed beside it,
SDPA and the bound, as chip_smoke.py does). Those times are CUDA events over
back-to-back calls, so where a kernel takes less than the wrapper's host
path (the small shapes) they time the host; each copy therefore also traces
20 calls a shape with torch.profiler and keeps the kernels' own device time
a call. Prints both tables with both copies' best times and writes every
row to chiprun_out/torch_flash_compare[_TAG].json. Needs a CUDA card.

With `--fp32` each copy runs chip_smoke.py's phase 11 checks instead
(`check_f32_forward` at every sampling shape and, with the log-sum-exp,
every train shape; `check_f32_backward` at the train shapes), each gated
against the plain version in fp32 with TF32 off and timed beside it and
SDPA on fp32 tensors; these kernels take milliseconds, so CUDA events time
them and there is no profiler table.

With `--wide` each copy runs `check_kernels` at K2's shapes: the txt2img
request's VAE mid-block attention (8 × 4096² × 512) and the train step's
encode and decode with the log-sum-exp, and traces 20 calls a shape.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "chiprun_out"

# runs inside the copy's root: the d = 64 rows of chip_smoke's phase 3
CHILD = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from faceposegenerator_tpu_torch.ops import _build, flash_attention as fa
_build.build_all()
card = torch.cuda.get_device_name(0)
d64 = lambda shapes: [s for s in shapes if s[5] == 64]
rows = cs.check_kernels(torch, fa, card, d64(cs.SHAPES))
rows += cs.check_kernels(torch, fa, card, d64(cs.TRAIN_SHAPES), with_lse=True, per="step")
rows += cs.check_backward(torch, fa, card, d64(cs.TRAIN_SHAPES))
ptxas = {n: _build.ptxas_report(n) for n in ("flash_fwd", "flash_bwd")} if hasattr(_build, "ptxas_report") else {}

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

def device_ms(fn, n=20):
    # the flash kernels' device time a call, by kernel
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "flash_" in e.name:
            name = next(k for k in ("flash_fwd_d64", "flash_bwd_d64_dkv", "flash_bwd_d64_dq", "flash_") if k in e.name)
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    return out

g = torch.Generator(device="cuda").manual_seed(0)
device = {}
for label, b, h, sq, skv, d, _ in d64(cs.SHAPES):
    q, k, v = cs._inputs(torch, g, b, h, sq, skv, d)
    device[f"flash_fwd_d64 {label} B{b}"] = device_ms(lambda: fa.flash_fwd_d64(q, k, v, d**-0.5))
for label, b, h, sq, skv, d, _ in d64(cs.TRAIN_SHAPES):
    q, k, v = cs._inputs(torch, g, b, h, sq, skv, d)
    do = torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16)
    o, lse = fa.flash_fwd_d64(q, k, v, d**-0.5, with_lse=True)
    device[f"flash_fwd_d64 +lse {label} B{b}"] = device_ms(lambda: fa.flash_fwd_d64(q, k, v, d**-0.5, with_lse=True))
    device[f"flash_bwd_d64 {label} B{b}"] = device_ms(lambda: fa.flash_bwd_d64(q, k, v, o, lse, do, d**-0.5))
print("RESULT " + json.dumps({"rows": rows, "ptxas": ptxas, "device": device}))
"""

# runs inside the copy's root: chip_smoke's phase 3 rows of K2
CHILD_WIDE = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from faceposegenerator_tpu_torch.ops import _build, flash_attention as fa
_build.build_all()
card = torch.cuda.get_device_name(0)
wide = lambda shapes: [s for s in shapes if s[5] != 64]
rows = cs.check_kernels(torch, fa, card, wide(cs.SHAPES))
rows += cs.check_kernels(torch, fa, card, wide(cs.TRAIN_SHAPES), with_lse=True, per="step")

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

def device_ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {"flash_fwd_wide": sum(e.time_range.elapsed_us() for e in prof.events()
                                  if e.device_type == DeviceType.CUDA and "flash_fwd_wide" in e.name) / 1e3 / n}

g = torch.Generator(device="cuda").manual_seed(0)
device = {}
for shapes, lse in ((wide(cs.SHAPES), False), (wide(cs.TRAIN_SHAPES), True)):
    for label, b, h, sq, skv, d, _ in shapes:
        q, k, v = cs._inputs(torch, g, b, h, sq, skv, d)
        device[f"flash_fwd_wide{' +lse' if lse else ''} {label} B{b}"] = device_ms(
            lambda: fa.flash_fwd_wide(q, k, v, d**-0.5, with_lse=lse))
print("RESULT " + json.dumps({"rows": rows, "ptxas": _build.ptxas_report("flash_fwd"), "device": device}))
"""

# runs inside the copy's root: chip_smoke's phase 11 attention rows
CHILD_F32 = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from faceposegenerator_tpu_torch.ops import _build, flash_attention as fa
_build.build_all()
card = torch.cuda.get_device_name(0)
rows = cs.check_f32_forward(torch, fa, card, cs.SHAPES)
rows += cs.check_f32_forward(torch, fa, card, cs.TRAIN_SHAPES, with_lse=True, per="step")
rows += cs.check_f32_backward(torch, fa, card, [s for s in cs.TRAIN_SHAPES if s[0] != "vae encode mid"])
print("RESULT " + json.dumps({"rows": rows, "ptxas": _build.ptxas_report("flash_f32"), "device": {}}))
"""


def run(root: Path, child: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", child], cwd=root, capture_output=True, text=True, timeout=1500)
    if proc.returncode != 0:
        raise SystemExit(f"FAIL in {root}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    line = next(l for l in proc.stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def key(row: dict) -> str:
    kind = row["kernel"] + (" +lse" if row.get("lse") else "")
    return f"{kind} {row['shape']} B{row['B']}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="root of the other checkout (e.g. the parent commit)")
    ap.add_argument("--tag", default="", help="suffix of the output file's name")
    ap.add_argument("--fp32", action="store_true", help="compare the fp32 instances instead of K1 and K5")
    ap.add_argument("--wide", action="store_true", help="compare K2 instead of K1 and K5")
    args = ap.parse_args()
    child = CHILD_F32 if args.fp32 else CHILD_WIDE if args.wide else CHILD
    other = Path(args.other).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card_line = smi.stdout.strip()
    print(card_line, flush=True)
    runs = []
    for label, root in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
        runs.append(dict(copy=label, root=str(root), **run(root, child)))
        print(f"done: {label} ({root})", flush=True)
    best: dict = {}
    for r in runs:
        for row in r["rows"]:
            t = row.get("ms", row.get("pair_ms"))
            slot = best.setdefault(key(row), {})
            if r["copy"] not in slot or t < slot[r["copy"]][0]:
                slot[r["copy"]] = (t, row)
    print(f"{'kernel, shape':44s} {'other ms':>9s} {'this ms':>9s} {'this/other':>10s} {'SDPA ms':>8s} "
          f"{'bound ms':>8s} {'TFLOP/s':>8s}")
    for k, slot in best.items():
        (to, _), (tt, row) = slot["other"], slot["this"]
        tfl = row.get("tflops")
        print(f"{k:44s} {to:9.4f} {tt:9.4f} {tt / to:10.3f} {row['library_ms']:8.4f} "
              f"{row.get('bound_ms', row.get('pair_bound_ms')):8.4f} {tfl if tfl is None else round(tfl, 1)!s:>8s}")
    if runs[0]["device"]:
        print("device time a call, by torch.profiler (ms):")
        print(f"{'kernel, shape':44s} {'other ms':>9s} {'this ms':>9s} {'this/other':>10s}  kernels")
    for k in runs[0]["device"]:
        t = {c: min(sum(r["device"][k].values()) for r in runs if r["copy"] == c) for c in ("other", "this")}
        parts = min((r["device"][k] for r in runs if r["copy"] == "this"), key=lambda p: sum(p.values()))
        print(f"{k:44s} {t['other']:9.4f} {t['this']:9.4f} {t['this'] / t['other']:10.3f}  "
              + ", ".join(f"{n} {v:.4f}" for n, v in parts.items()))
    OUT.mkdir(exist_ok=True)
    name = f"torch_flash_compare{'_' + args.tag if args.tag else ''}.json"
    (OUT / name).write_text(json.dumps({"card": card_line, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
