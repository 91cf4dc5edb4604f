"""K3 (`fused_group_norm`, GroupNorm+SiLU) and K6 (`flash_bwd_wide_dkv/_dq`,
the D = 512 attention backward) of two copies of the port, timed in one call
on one card, in turns.

    python3 perf/torch_gn_bwd_compare.py [--other build/parent] [--tag parent] [--e2e] [--rounds N]

`--other` is the root of another checkout (for example the parent commit,
unpacked with `git archive` into a directory that .gitignore lists); without
it only this copy runs. Each copy runs in a fresh process of its own, in the
order other, this, this, other (`--rounds` times): it builds its own fused_gn, flash_fwd and
flash_bwd libraries under its own `build/kernels`, then
  * K3 at chip_smoke's GroupNorm shapes (GN_SHAPES, GN_TRAIN_SHAPES and
    GN_ALONE_SHAPES in bf16, GN_F32_SHAPES in fp32; a copy without
    GN_ALONE_SHAPES runs those of this copy): the output against the copy's own plain
    version (chip_smoke's K3 gate: 1 ulp + 1e-3 relative + 1e-5 of the max
    abs); `ms`, the call (the wrapper, CUDA events over back-to-back calls,
    chip_smoke.time_ms); `launch_ms`, each C call alone, replayed with the
    arguments the wrapper gave it (for K3 the C entry on ready buffers);
    `host_us`, the wrapper's host time a call (time.perf_counter over 1000
    calls with no synchronisation, then one synchronisation: `host_sync_us`
    is the same loop with it); `device_us`, the device time of the call's
    kernels a call by torch.profiler over 20 calls;
  * K6 at 4 × 4096² × 512 (the train step's VAE decode mid-block attention):
    each gradient against attention_bwd_plain (chip_smoke's bf16 gradient
    gate), each pass and the pair by CUDA events, each launch alone, and
    the device time of the pair by torch.profiler;
  * with `--e2e`, in every process: the fused txt2img request (GN_IMPL and
    GN_CONV_IMPL at pallas; batch 8, 512², 30 DDPM steps, CFG 5.0; a
    warm-up, then 3 requests), the same with GN_IMPL alone at pallas (a
    warm-up, then 2), the default train step and the fused train step
    (chip_smoke's op point; 5 steps each with chip_smoke's exact launch
    counts, the first a warm-up). Every timed request and step is kept, so
    the table gives each tree's median and spread over its processes.
Times are warm in L2. Prints the table with both copies' best times and
writes every row to chiprun_out/torch_gn_bwd_compare[_TAG].json. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "chiprun_out"
sys.path.insert(0, str(REPO))
from chip_smoke import GN_ALONE_SHAPES as ALONE  # noqa: E402

sys.path.pop(0)

# runs inside the copy's root
CHILD = r"""
import json, re, sys, time, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
import chip_smoke as cs
from faceposegenerator_tpu_torch.ops import _build, flash_attention as fa, fused_gn as fg

for lib in ("fused_gn", "flash_fwd", "flash_bwd"):
    _build.load(lib)
card = torch.cuda.get_device_name(0)

# every C call a wrapper makes, by kernel name, with its arguments
calls = {}
def record(name, fn):
    def call(*args):
        calls[name] = (fn, args)
        return fn(*args)
    return call
get_k3 = fg._kernel
fg._kernel = lambda: record("fused_group_norm", get_k3())
get_fa = fa._fn
fa._fn = lambda name: record(name, get_fa(name))

def launches(wrapper):
    calls.clear()
    out = wrapper()  # kept alive: the replays write into it
    torch.cuda.synchronize()
    times = {name: cs.time_ms(lambda: fn(*args), torch) for name, (fn, args) in list(calls.items())}
    del out
    return times

def host_us(fn, n=1000):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return 1e6 * (t1 - t0) / n, 1e6 * (t2 - t0) / n

def device_us(fn, pattern, n=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and re.search(pattern, e.name):
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / n
    return by

rows = []
shapes = {}
for s in cs.GN_SHAPES + cs.GN_TRAIN_SHAPES + ALONE:
    shapes.setdefault((torch.bfloat16, *s[1:7]), s[0])
for s in getattr(cs, "GN_F32_SHAPES", []):
    shapes.setdefault((torch.float32, *s[1:7]), s[0])
g = torch.Generator(device="cuda").manual_seed(6)
for (dtype, n, h, w, c, eps, act), label in shapes.items():
    x = (torch.randn(n, h, w, c, generator=g, device="cuda") * 3 + 1).to(dtype)
    gamma, beta = (torch.randn(c, generator=g, device="cuda").to(dtype) for _ in "gb")
    call = lambda: fg.fused_group_norm(x, gamma, beta, 32, eps, act)
    out = call()
    mx, mean, over = cs._ulp_err(out, fg.fused_group_norm_plain(x, gamma, beta, 32, eps, act), cs.GN_REL_ERR,
                                 cs.GN_MAX_FLOOR)
    del out
    hu, hsu = host_us(call)
    rows.append(dict(kernel="fused_group_norm", dtype=str(dtype)[6:], shape=label, N=n, H=h, W=w, C=c, act=act,
                     ms=cs.time_ms(call, torch), launch_ms=launches(call), host_us=hu, host_sync_us=hsu,
                     device_us=device_us(call, r"gn_k3"), max_abs_err=mx, mean_abs_err=mean, over_limit=over))
    print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    del x
    torch.cuda.empty_cache()

g = torch.Generator(device="cuda").manual_seed(1)
b, h, sq, skv, d = 4, 1, 4096, 4096, 512
q, k, v = cs._inputs(torch, g, b, h, sq, skv, d)
do = torch.randn(b, sq, h, d, generator=g, device="cuda").to(torch.bfloat16)
scale = d**-0.5
o, lse = fa.flash_fwd_wide(q, k, v, scale, with_lse=True)
grads = fa.flash_bwd_wide(q, k, v, o, lse, do, scale)
refs = fa.attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale)
errs = {}
for name, x, r in zip(("dq", "dk", "dv"), grads, refs):
    e = (x.float() - r.float()).abs()
    nmax = r.abs().max().item()
    errs[name] = [e.max().item(), e.mean().item(), nmax,
                  e.max().item() <= cs.MAX_ERR * nmax and e.mean().item() <= cs.MEAN_ERR * nmax]
del grads, refs
torch.cuda.empty_cache()
pair = lambda: fa.flash_bwd_wide(q, k, v, o, lse, do, scale)
rows.append(dict(kernel="flash_bwd_wide", shape="vae decode mid", B=b, H=h, Sq=sq, Skv=skv, D=d,
                 dkv_ms=cs.time_ms(lambda: fa.flash_bwd_wide(q, k, v, o, lse, do, scale, passes=("dkv",)), torch),
                 dq_ms=cs.time_ms(lambda: fa.flash_bwd_wide(q, k, v, o, lse, do, scale, passes=("dq",)), torch),
                 ms=cs.time_ms(pair, torch), launch_ms=launches(pair), device_us=device_us(pair, r"flash_bwd_wide", 5),
                 errs=errs, over_limit=not all(e[3] for e in errs.values())))
print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
del q, k, v, o, lse, do
torch.cuda.empty_cache()

e2e = {}
if "--e2e" in sys.argv:
    import contextlib, io
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline
    pipe = StableDiffusionPipeline.from_random(seed=0, dtype=torch.bfloat16)
    pipe.set_lora(cs.make_lora(pipe.nets["unet"], 10, torch))
    ids = torch.randint(0, 49408, (8, 77), generator=torch.Generator().manual_seed(1))
    from faceposegenerator_tpu_torch.ops import fused_gn_conv as fgc

    @contextlib.contextmanager
    def route(impl, conv):  # GN_IMPL and GN_CONV_IMPL as the environment sets them at import
        saved = fg._GN_IMPL, fgc._IMPL
        fg._GN_IMPL, fgc._IMPL = impl, conv
        try:
            yield
        finally:
            fg._GN_IMPL, fgc._IMPL = saved

    for key, ctx, seeds in (("fused_txt2img_s", route("pallas", "pallas"), (9, 0, 1, 2)),
                            ("gn_alone_txt2img_s", route("pallas", "xla"), (9, 0, 1))):
        secs = []
        with ctx:
            for seed in seeds:
                torch.cuda.synchronize()
                t0 = time.time()
                img = pipe(input_ids=ids, num_inference_steps=30, guidance_scale=5.0, height=512, width=512,
                           seed=seed)
                secs.append(time.time() - t0)
        cs._check_images(img, 8, 512, key)
        e2e[key] = secs[1:]
    del pipe
    torch.cuda.empty_cache()
    op = cs.build_train_op_point(torch)
    wide = 3 if op[3].remat_identity else 2
    for key, ctx, expect in (("train_s", route("xla", "xla"), cs.STEP_LAUNCHES),
                             ("fused_train_s", route("pallas", "pallas"), cs.FUSED_STEP_LAUNCHES)):
        log = io.StringIO()
        with ctx, contextlib.redirect_stdout(log):
            cs._train_steps(torch, op, 5, dict(expect, flash_fwd_wide=wide), key, card)
        e2e[key] = [float(m) for m in re.findall(r"step [1-9]\d*: ([0-9.]+) s", log.getvalue())]
ptxas = {lib: _build.ptxas_report(lib) for lib in ("fused_gn", "flash_bwd")}
print("RESULT " + json.dumps({"card": card, "rows": rows, "e2e": e2e, "ptxas": ptxas}))
"""


def run(root: Path, e2e: bool) -> dict:
    child = CHILD.replace("ALONE", "getattr(cs, 'GN_ALONE_SHAPES', " + repr(ALONE) + ")")
    argv = [sys.executable, "-c", child] + (["--e2e"] if e2e else [])
    proc = subprocess.run(argv, cwd=root, capture_output=True, text=True, timeout=1500)
    if proc.returncode != 0:
        raise SystemExit(f"FAIL in {root}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    line = next(l for l in proc.stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _key(row) -> str:
    if row["kernel"] == "fused_group_norm":
        return f"K3 {row['dtype']:8s} {row['shape']} N{row['N']} {row['H']}²·{row['C']}"
    return f"K6 {row['shape']} B{row['B']} {row['Sq']}²·{row['D']}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", default=None, help="root of the other checkout (e.g. the parent commit)")
    ap.add_argument("--tag", default="", help="suffix of the output file's name")
    ap.add_argument("--e2e", action="store_true", help="also time the fused requests and the two train steps")
    ap.add_argument("--rounds", type=int, default=1, help="times to run the order other, this, this, other")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card_line = smi.stdout.strip()
    print(card_line, flush=True)
    order = [("this", REPO)]
    if args.other:
        other = Path(args.other).resolve()
        order = [("other", other), ("this", REPO), ("this", REPO), ("other", other)] * args.rounds
    runs = []
    for label, root in order:
        runs.append(dict(copy=label, root=str(root), **run(root, args.e2e)))
        print(f"done: {label} ({root}){' with e2e ' + json.dumps(runs[-1]['e2e']) if args.e2e else ''}",
              flush=True)
    best: dict = {}
    for r in runs:
        for row in r["rows"]:
            slot = best.setdefault(_key(row), {})
            if r["copy"] not in slot or row["ms"] < slot[r["copy"]]["ms"]:
                slot[r["copy"]] = row
    fails = []
    print(f"{'':44s} {'other ms':>9s} {'this ms':>9s}   launch ms, host us, device us (other | this)")
    for key, slot in best.items():
        ro, rt = slot.get("other", {}), slot.get("this", {})

        def fmt(r):
            if not r:
                return "-"
            launch = ", ".join(f"{n} {ms:.4f}" for n, ms in r["launch_ms"].items())
            dev = sum(r["device_us"].values())
            host = f"host {r['host_us']:.1f} us, " if "host_us" in r else ""
            return f"{launch}; {host}device {dev:.1f} us"

        print(f"{key:44s} {ro.get('ms', float('nan')):9.4f} {rt.get('ms', float('nan')):9.4f}   {fmt(ro)} | {fmt(rt)}")
        fails += [f"{c} {key}" for c, r in slot.items() if r.get("over_limit")]
    samples: dict = {}
    for r in runs:
        for key, secs in r["e2e"].items():
            samples.setdefault(key, {}).setdefault(r["copy"], []).extend(secs)
    for key, by in samples.items():
        print(f"e2e {key}: " + "; ".join(
            f"{copy} median {statistics.median(v):.4f} s, min {min(v):.4f}, max {max(v):.4f} over {len(v)}"
            for copy, v in by.items()))
    OUT.mkdir(exist_ok=True)
    name = f"torch_gn_bwd_compare{'_' + args.tag if args.tag else ''}.json"
    (OUT / name).write_text(json.dumps({"card": card_line, "runs": runs}, indent=1))
    if fails:
        print("FAIL: outputs beyond the K3 or K6 gate: " + "; ".join(fails))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
