"""Where K7 (`qdense`) and K8's attention launch (`flash_int8`) spend their
time: timing-only variants of csrc/qdense.cu and csrc/flash_int8.cu, each
with one stage taken out or changed, in one call.

    python3 perf/torch_int8_ablate.py [variant ...]

Variants (all by default):
  base             the kernels as they are;
  k7_no_epilogue   K7's epilogue writes nothing into the staging tile (no
                   int → float, no rescale, no pack; the TMA stores stay);
  k7_no_store      K7 issues no TMA store of the output tile;
  k7_no_quantize   K7 brings no x and its consumers skip the quantize into
                   shared memory;
  k7_no_mma        K7 issues no wgmma (the loads, barriers and epilogue stay);
  k7_ring4         K7's ring of weight stages capped at 4, not 12;
  k8_fast_exp      K8's per-score expf replaced by __expf (one MUFU.EX2 and
                   a multiply: other codes, timing only);
  k8_no_p8         K8's sweep 2 computes no p (P·V on the raw scores' low
                   bytes);
  k8_no_pv         K8 issues no P·V product;
  k8_no_max        K8's sweep 1 takes no row max (its products stay);
  k8_ring4         K8's ring of K/V stages at 4, not 8;
  k8_magic         K8's score to float by the magic-number add instead of
                   a conversion (I2FP; the same values).
The variants compute wrong outputs (all but base, the ring ones and k8_magic), so
nothing is gated: each copies the repository's root to build/ablate_<variant>,
patches its source, builds it there in a fresh process and times, with
chip_smoke.time_ms (CUDA events), K7 at three of chip_smoke.QDENSE_SHAPES
(dynamic mode) and K8's attention launch on ready codes at the 4096-token
and the 6400-key self-attention. Prints one line per variant and writes
chiprun_out/torch_int8_ablate.json. Needs a CUDA card.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "faceposegenerator_tpu_torch" / "csrc"


def _sub(s: str, old: str, new: str) -> str:
    if old not in s:
        raise SystemExit(f"the source no longer holds {old[:60]!r}: update this script")
    return s.replace(old, new)


# (source, patch) per variant
VARIANTS = {
    "base": (None, None),
    "k7_no_epilogue": ("qdense.cu", lambda s: _sub(s, "for (int i = 0; i < BN / 8; ++i) {",
                                                   "for (int i = 0; i < 0; ++i) {")),
    "k7_no_store": ("qdense.cu", lambda s: _sub(_sub(
        s, "tma_store_2d(&tm_y, out_wg, n0, my0);", ""),
        "if (n0 + 64 < N) tma_store_2d(&tm_y, out_wg + OUT_TILE / 2, n0 + 64, my0);", "")),
    "k7_no_quantize": ("qdense.cu", lambda s: _sub(_sub(
        s, "} else if (!WIDE && threadIdx.x == 288) {", "} else if (false) {"),
        "for (int xc = 0; xc < NX; ++xc) {", "for (int xc = 0; xc < 0; ++xc) {")),
    "k7_no_mma": ("qdense.cu", lambda s: _sub(_sub(
        s, "wgmma_s8_ss_m64n128(acc, desc_k64(sa), desc_k64(sb), kc > 0);", ""),
        "wgmma_s8_ss_m64n128(acc, desc_k64(sa + 32), desc_k64(sb + 32), 1);", "")),
    "k7_ring4": ("qdense.cu", lambda s: _sub(s, "MAX_RING = 12", "MAX_RING = 4")),
    "k8_fast_exp": ("flash_int8.cu", lambda s: _sub(s, "float p = expf(", "float p = __expf(")),
    "k8_no_p8": ("flash_int8.cu", lambda s: _sub(
        s, "tile_p<false>(s_acc, c_qk, mn0, mn1, ls0, ls1, j * BK + 2 * t4, kv_end);", ";")),
    "k8_no_pv": ("flash_int8.cu", lambda s: _sub(
        s, "wgmma_s8_rs_m64n64(o_acc, pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2], pa[4 * kc + 3], desc_k(sV + 32 * kc),",
        "if (0) wgmma_s8_rs_m64n64(o_acc, pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2], pa[4 * kc + 3], desc_k(sV + 32 * kc),")),
    "k8_no_max": ("flash_int8.cu", lambda s: _sub(s, "tile_max<false>(s_acc, mx0, mx1, key0, kv_end);", ";")),
    "k8_ring4": ("flash_int8.cu", lambda s: _sub(s, "THREADS = 384, RING = 8;", "THREADS = 384, RING = 4;")),
    "k8_magic": ("flash_int8.cu", lambda s: _sub(
        s, "static_cast<float>(static_cast<int>(s[4 * i + e]));",
        "__fsub_rn(__int_as_float(static_cast<int>(s[4 * i + e]) + 0x4B400000), 12582912.f);")),
}

CHILD = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from faceposegenerator_tpu_torch.ops import _build, flash_attention as fa, qdense as qd
from faceposegenerator_tpu_torch.ops.quant import quantize_weight
for lib in ("qdense", "flash_int8"):
    _build.load(lib)
ptxas = {lib: [(r["function"], r.get("registers"), r.get("spill_stores")) for r in _build.ptxas_report(lib)]
         for lib in ("qdense", "flash_int8")}
loss = [l.strip() for lib in ("qdense", "flash_int8") for l in _build.build_log(lib).splitlines()
        if "Performance Loss" in l]
g = torch.Generator(device="cuda").manual_seed(2)
ms = {}
for label, m, k, n in cs.QDENSE_SHAPES[:3]:
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    qw = quantize_weight(torch.randn(n, k, generator=g, device="cuda") * k**-0.5)
    ms["K7 " + label] = cs.time_ms(lambda: qd.qdense_kernel(x, qw.q, qw.s), torch)
for label, b, h, sq, skv, d in (cs.INT8_SHAPES[0], cs.INT8_LONG):
    q, k, v = cs._inputs(torch, g, b, h, sq, skv, d)
    q8, k8, vt, ws = fa.int8_codes(q, k, v, d**-0.5)
    ms["K8 attention " + label] = cs.time_ms(lambda: fa.int8_attend(q8, k8, vt, ws, q.shape, q.dtype, skv), torch)
print("RESULT " + json.dumps({"ms": ms, "ptxas": ptxas, "performance_loss": loss}))
"""


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card_line = smi.stdout.strip()
    print(card_line, flush=True)
    out = {}
    for name in names:
        src, patch = VARIANTS[name]
        root = REPO / "build" / f"ablate_{name}"
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(REPO, root, ignore=shutil.ignore_patterns("build", "chiprun_out", ".git", "faceposegenerator_tpu"))
        if src:
            path = root / CSRC.relative_to(REPO) / src
            path.write_text(patch((CSRC / src).read_text()))
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"FAIL in {name}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        out[name] = json.loads(next(l for l in proc.stdout.splitlines() if l.startswith("RESULT "))[7:])
        spills = {f: sp for lib in out[name]["ptxas"].values() for f, _, sp in lib if sp}
        print(f"{name:16s} " + "  ".join(f"{k}: {v:.4f}" for k, v in out[name]["ms"].items()),
              f"spills {spills}" if spills else "", out[name]["performance_loss"] or "", flush=True)
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "torch_int8_ablate.json").write_text(
        json.dumps({"card": card_line, "runs": out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
