"""Where K4 (`gn_silu_conv3x3`, bf16) spends its time: timing-only variants
of csrc/gn_conv.cu, each with one stage taken out or changed, in one call;
with `--fp32`, variants of its fp32 instance (`gn_silu_conv3x3_f32`).

    python3 perf/torch_conv_ablate.py [variant ...]
    python3 perf/torch_conv_ablate.py --fp32 [variant ...]

Variants (all by default):
  base                   the kernel as it is;
  no_normalise           the normaliser copies the raw x chunk instead of
                         computing SiLU(x · scale + shift) (the products and
                         loads unchanged);
  no_weight_loads        the producer loads the weights of the first 4 taps
                         only, and later taps reuse those stages (the L2
                         traffic of the weight tiles gone);
  three_normaliser_warps the normalisation on 3 warps (384 threads) instead
                         of 7, as the first version of the kernel had it.
The variants compute wrong outputs (all but base and three_normaliser_warps),
so nothing is gated: each copies the repository's root to
build/ablate_<variant>, patches its gn_conv.cu, builds it there in a fresh
process and times the kernel at chip_smoke.CONV_SHAPES with
chip_smoke.time_ms (CUDA events). Prints one line per variant and writes
chiprun_out/torch_conv_ablate.json. Needs a CUDA card.

fp32 variants (all by default with `--fp32`), each timed at
chip_smoke.CONV_F32_SHAPES with its error against gn_silu_conv3x3_plain in
fp32 (TF32 off), relative to the output's max abs as the fp32 gate reads it:
  base                   the kernel as it is: a fresh accumulator per
                         32-channel chunk, added to the running sum by FADD;
  one_chain              every product into the one running accumulator (no
                         fresh accumulator, no FADD): what the fresh
                         accumulator costs, and the error it saves.
The same JSON file takes the rows, under "runs" → "fp32".
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "faceposegenerator_tpu_torch" / "csrc" / "gn_conv.cu"


def _sub(s: str, old: str, new: str) -> str:
    if old not in s:
        raise SystemExit(f"the source no longer holds {old[:60]!r}: update this script")
    return s.replace(old, new)


def no_normalise(s: str) -> str:
    return _sub(s, """            out.x = act2(r.x, sc[0], sh[0], sc[1], sh[1]);
            out.y = act2(r.y, sc[2], sh[2], sc[3], sh[3]);
            out.z = act2(r.z, sc[4], sh[4], sc[5], sh[5]);
            out.w = act2(r.w, sc[6], sh[6], sc[7], sh[7]);""", "            out = r;")


def no_weight_loads(s: str) -> str:
    return _sub(s, """          mbar_arrive_expect_tx(w_full(s), W_BYTES);
          tma_load_3d(sW + s * W_BYTES, &tm_w, w_full(s), c * KC, tap, n0);""", """          if (u < W_STAGES) {
            mbar_arrive_expect_tx(w_full(s), W_BYTES);
            tma_load_3d(sW + s * W_BYTES, &tm_w, w_full(s), c * KC, tap, n0);
          } else {
            mbar_arrive(w_full(s));
          }""")


def three_normaliser_warps(s: str) -> str:
    s = _sub(s, "constexpr int THREADS = 512, NORM_THREADS = 224;", "constexpr int THREADS = 384, NORM_THREADS = 96;")
    s = _sub(s, "constexpr int AUX_REGS = 72, CONSUMER_REGS = 184;", "constexpr int AUX_REGS = 96, CONSUMER_REGS = 200;")
    return _sub(s, "static_assert(128 * (2 * AUX_REGS + 2 * CONSUMER_REGS) <= 128 * THREADS",
                "static_assert(128 * (AUX_REGS + 2 * CONSUMER_REGS) <= 168 * THREADS")


VARIANTS = {"base": lambda s: s, "no_normalise": no_normalise, "no_weight_loads": no_weight_loads,
            "three_normaliser_warps": three_normaliser_warps}


def one_chain(s: str) -> str:
    s = _sub(s, "    float acc[80], part[80];  // the running sum; this chunk's products",
             "    float acc[80];\n    float(&part)[80] = acc;")
    s = _sub(s, "tap > 0 || kk > 0);", "1);")
    return _sub(s, """#pragma unroll
      for (int i = 0; i < 80; ++i) acc[i] += part[i];
""", "")


F32_VARIANTS = {"base": lambda s: s, "one_chain": one_chain}

CHILD = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from faceposegenerator_tpu_torch.ops import _build, fused_gn_conv as fgc
_build.build_all()
ptxas = [(r["function"], r.get("registers"), r.get("spill_stores")) for r in _build.ptxas_report("gn_conv")]
loss = [l.strip() for l in _build.build_log("gn_conv").splitlines() if "Performance Loss" in l]
g = torch.Generator(device="cuda").manual_seed(7)
ms = {}
for label, n, h, w, cin, cout, _ in cs.CONV_SHAPES:
    x, gamma, beta, conv = cs._conv_inputs(torch, g, n, h, w, cin, cout)
    ms[label] = cs.time_ms(lambda: fgc.gn_silu_conv3x3(x, gamma, beta, conv, 32), torch)
print("RESULT " + json.dumps({"ms": ms, "ptxas": ptxas, "performance_loss": loss}))
"""

CHILD_F32 = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from faceposegenerator_tpu_torch.ops import _build, fused_gn_conv as fgc
_build.build_all()
ptxas = [(r["function"], r.get("registers"), r.get("spill_stores")) for r in _build.ptxas_report("gn_conv")]
loss = [l.strip() for l in _build.build_log("gn_conv").splitlines() if "Performance Loss" in l]
g = torch.Generator(device="cuda").manual_seed(13)
ms, err = {}, {}
with cs.tf32(False):
    for label, n, h, w, cin, cout, _ in cs.CONV_F32_SHAPES:
        x, gamma, beta, conv = cs._conv_inputs(torch, g, n, h, w, cin, cout)
        x, conv = x.float(), conv.float()
        conv.weight.data = conv.weight.data.contiguous(memory_format=torch.channels_last)
        max_err, mean_err, nmax, _ = cs._f32_errs(fgc.gn_silu_conv3x3(x, gamma, beta, conv, 32),
                                                 fgc.gn_silu_conv3x3_plain(x, gamma, beta, conv.weight, conv.bias, 32))
        err[label] = [max_err / nmax, mean_err / nmax]
        ms[label] = cs.time_ms(lambda: fgc.gn_silu_conv3x3(x, gamma, beta, conv, 32), torch)
print("RESULT " + json.dumps({"ms": ms, "err_of_max_abs": err, "ptxas": ptxas, "performance_loss": loss}))
"""


def main() -> int:
    fp32 = "--fp32" in sys.argv[1:]
    variants, child = (F32_VARIANTS, CHILD_F32) if fp32 else (VARIANTS, CHILD)
    names = [a for a in sys.argv[1:] if a != "--fp32"] or list(variants)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card_line = smi.stdout.strip()
    print(card_line, flush=True)
    base = SRC.read_text()
    out = {}
    for name in names:
        root = REPO / "build" / f"ablate_{'f32_' if fp32 else ''}{name}"
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(REPO, root, ignore=shutil.ignore_patterns("build", "chiprun_out", ".git", "faceposegenerator_tpu"))
        (root / SRC.relative_to(REPO)).write_text(variants[name](base))
        proc = subprocess.run([sys.executable, "-c", child], cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"FAIL in {name}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        out[name] = json.loads(next(l for l in proc.stdout.splitlines() if l.startswith("RESULT "))[7:])
        print(name, " ".join(f"{k}: {v:.4f} ms" for k, v in out[name]["ms"].items()),
              json.dumps(out[name].get("err_of_max_abs", {})), out[name]["ptxas"], out[name]["performance_loss"],
              flush=True)
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    if fp32:
        out = {"fp32": out}
    (REPO / "chiprun_out" / "torch_conv_ablate.json").write_text(json.dumps({"card": card_line, "runs": out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
