"""K7 (`qdense`, the w8a8 dense) and K8 (`flash_int8`, the int8 attention) of
two copies of the port, timed in one call on one card, in turns.

    python3 perf/torch_int8_compare.py --other build/parent [--tag parent]

`--other` is the root of another checkout (for example the parent commit,
unpacked with `git archive` into a directory that .gitignore lists). Each
copy runs in a fresh process of its own, in the order other, this, this,
other: it builds its own qdense and flash_int8 libraries under its own
`build/kernels`, then, in bf16 and in fp32:
  * K7 at chip_smoke's QDENSE_SHAPES in the dynamic and static modes, and
    K8 at its INT8_SHAPES and INT8_LONG (the 640² self-attention; a copy
    that refuses more than 4096 keys gets no row there);
  * per row, the output against the copy's own plain version (chip_smoke's
    K7/K8 gate: 1 ulp + 1e-3 relative), the wrapper's time (`ms`: every
    launch and torch op of one call) and each launch's own time (`launch_ms`:
    CUDA events around its C call, replayed with the arguments the wrapper
    gave it; for K8 the attention launch is the one on ready codes).
Times are CUDA-event means over back-to-back calls (chip_smoke.time_ms),
warm in L2. Prints the table with both copies' best times and writes every
row to chiprun_out/torch_int8_compare[_TAG].json.
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

# runs inside the copy's root
CHILD = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from faceposegenerator_tpu_torch.ops import _build, flash_attention as fa, qdense as qd
from faceposegenerator_tpu_torch.ops.quant import quantize_weight

for lib in ("qdense", "flash_int8"):
    _build.load(lib)
card = torch.cuda.get_device_name(0)
LONG = ("self 640², 2 key blocks", 2, 5, 6400, 6400, 64)  # chip_smoke.INT8_LONG

# every C call a wrapper makes, by kernel name, with its arguments
calls = {}
def recording(get):
    def wrapped(name):
        fn = get(name)
        def call(*args):
            calls[name] = (fn, args)
            return fn(*args)
        return call
    return wrapped
qd._kernel = recording(qd._kernel)
fa._fn = recording(fa._fn)

def launches(wrapper):
    calls.clear()
    wrapper()
    torch.cuda.synchronize()
    return {name: cs.time_ms(lambda: fn(*args), torch) for name, (fn, args) in list(calls.items())}

rows = []
for dtype in (torch.bfloat16, torch.float32):
    g = torch.Generator(device="cuda").manual_seed(2)
    for label, m, k, n in cs.QDENSE_SHAPES:
        x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
        qw = quantize_weight(torch.randn(n, k, generator=g, device="cuda") * k**-0.5)
        for mode in ("dynamic", "static"):
            a = float(x.float().abs().amax()) * 1.1 / 127.0 if mode == "static" else None
            out = qd.qdense_kernel(x, qw.q, qw.s, a)
            mx, mean, over = cs._ulp_err(out, qd.qdense_plain(x, qw.q, qw.s, a))
            del out
            rows.append(dict(kernel="qdense", dtype=str(dtype)[6:], shape=label, mode=mode, M=m, K=k, N=n,
                             ms=cs.time_ms(lambda: qd.qdense_kernel(x, qw.q, qw.s, a), torch),
                             launch_ms=launches(lambda: qd.qdense_kernel(x, qw.q, qw.s, a)),
                             max_abs_err=mx, mean_abs_err=mean, over_limit=over))
            print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
        del x, qw
        torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(3)
    for label, b, h, sq, skv, d in [*cs.INT8_SHAPES, LONG]:
        q, k, v = cs._inputs(torch, g, b, h, sq, skv, d, dtype)
        try:
            out = fa.flash_attention_int8(q, k, v, d**-0.5)
        except ValueError as e:  # a copy that refuses this key length
            rows.append(dict(kernel="flash_int8", dtype=str(dtype)[6:], shape=label, B=b, Skv=skv, refused=str(e)))
            continue
        mx, mean, over = cs._ulp_err(out, fa.attention_int8_plain(q, k, v, d**-0.5))
        del out
        torch.cuda.empty_cache()
        rows.append(dict(kernel="flash_int8", dtype=str(dtype)[6:], shape=label, B=b, H=h, Sq=sq, Skv=skv,
                         ms=cs.time_ms(lambda: fa.flash_attention_int8(q, k, v, d**-0.5), torch),
                         launch_ms=launches(lambda: fa.flash_attention_int8(q, k, v, d**-0.5)),
                         max_abs_err=mx, mean_abs_err=mean, over_limit=over))
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
        del q, k, v
        torch.cuda.empty_cache()
ptxas = {lib: _build.ptxas_report(lib) for lib in ("qdense", "flash_int8")}
print("RESULT " + json.dumps({"card": card, "rows": rows, "ptxas": ptxas}))
"""


def run(root: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root, capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise SystemExit(f"FAIL in {root}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    line = next(l for l in proc.stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _key(row) -> str:
    if row["kernel"] == "qdense":
        return f"K7 {row['dtype']:8s} {row['shape']} {row['mode']}"
    return f"K8 {row['dtype']:8s} {row['shape']} B{row['B']}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="root of the other checkout (e.g. the parent commit)")
    ap.add_argument("--tag", default="", help="suffix of the output file's name")
    args = ap.parse_args()
    other = Path(args.other).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card_line = smi.stdout.strip()
    print(card_line, flush=True)
    runs = []
    for label, root in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
        runs.append(dict(copy=label, root=str(root), **run(root)))
        print(f"done: {label} ({root})", flush=True)
    best: dict = {}
    for r in runs:
        for row in r["rows"]:
            slot = best.setdefault(_key(row), {})
            if "ms" not in row:
                slot.setdefault(r["copy"], row)
            elif r["copy"] not in slot or row["ms"] < slot[r["copy"]].get("ms", float("inf")):
                slot[r["copy"]] = row
    fails = []
    print(f"{'':46s} {'other ms':>9s} {'this ms':>9s} {'this/other':>10s}   launches (other | this), ms")
    for key, slot in best.items():
        ro, rt = slot.get("other", {}), slot.get("this", {})
        o_ms, t_ms = ro.get("ms"), rt.get("ms")
        ratio = f"{t_ms / o_ms:10.3f}" if o_ms and t_ms else f"{'-':>10s}"
        fmt = lambda r: ", ".join(f"{n} {ms:.4f}" for n, ms in r.get("launch_ms", {}).items()) or "refused"
        print(f"{key:46s} {o_ms or float('nan'):9.4f} {t_ms or float('nan'):9.4f} {ratio}   {fmt(ro)} | {fmt(rt)}")
        fails += [f"{c} {key}" for c, r in slot.items() if r.get("over_limit")]
    OUT.mkdir(exist_ok=True)
    name = f"torch_int8_compare{'_' + args.tag if args.tag else ''}.json"
    (OUT / name).write_text(json.dumps({"card": card_line, "runs": runs}, indent=1))
    if fails:
        print("FAIL: outputs beyond the K7/K8 gate: " + "; ".join(fails))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
