"""K3 (`fused_group_norm`) at every GroupNorm shape of chip_smoke.py under the
cluster plans around the one `cluster_plan` picks, timed on one card.

    python3 perf/torch_k3_plan_sweep.py

For each distinct shape of GN_SHAPES, GN_TRAIN_SHAPES and GN_ALONE_SHAPES
(bf16) and GN_F32_SHAPES (fp32), with its own eps and activation, and for
each cluster size of 4, 8 and 16 CTAs (at most S), the ring as deep as one
CTA an SM allows (up to all of the CTA's chunks: x read once where they
fit), as deep as two CTAs an SM allow, and 1 and 2 slots: the C entry's
time on ready buffers (CUDA events over back-to-back launches, chip_smoke's
time_ms), the clusters the card holds at once
(cudaOccupancyMaxActiveClusters), the bytes read again after the statistics
(the chunks beyond the ring), and the output against the plain version under
chip_smoke's K3 gate. The plan `cluster_plan` picks is marked. Prints one line a
plan and writes them all to chiprun_out/torch_k3_plan_sweep.json. Needs a
CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from faceposegenerator_tpu_torch.ops import _build  # noqa: E402
from faceposegenerator_tpu_torch.ops import fused_gn as fg  # noqa: E402


def plans(n, s, c, item):
    """(cluster, rows, stages) around the chosen plan."""
    out = set()
    for cluster in (4, 8, 16):
        if cluster > s:
            continue
        rows = math.ceil(s / cluster)
        chunks = math.ceil(rows / fg.chunk_rows(c, item))
        for per_sm in (1, 2):
            cap = min(fg.SMEM_MAX, fg.SM_SMEM // per_sm - 1024)
            deep = [st for st in range(1, chunks + 1) if fg.cluster_smem(c, item, st) <= cap]
            out.update((cluster, rows, st) for st in deep[-1:] + [st for st in (1, 2) if st in deep])
    out.add(fg.cluster_plan(n, s, c, item))
    return sorted(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card_line = smi.stdout.strip()
    print(card_line, flush=True)
    kernel = fg._kernel()
    occupancy = _build.load("fused_gn").fused_group_norm_clusters
    occupancy.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    shapes = {}
    for dtype, table in ((torch.bfloat16, cs.GN_SHAPES + cs.GN_TRAIN_SHAPES + cs.GN_ALONE_SHAPES),
                         (torch.float32, cs.GN_F32_SHAPES)):
        for label, n, h, w, c, eps, act, _ in table:
            shapes.setdefault((dtype, n, h * w, c, eps, act), label)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, fails = [], 0
    for (dtype, n, s, c, eps, act), label in shapes.items():
        item = torch.finfo(dtype).bits // 8
        x = (torch.randn(n, s, c, generator=g, device="cuda") * 3 + 1).to(dtype)
        gamma, beta = (torch.randn(c, generator=g, device="cuda").to(dtype) for _ in "gb")
        y = torch.empty_like(x)
        want = fg.fused_group_norm_plain(x, gamma, beta, 32, eps, act)
        chosen = fg.cluster_plan(n, s, c, item)
        bound_us = 2 * x.numel() * item / 3.35e12 * 1e6
        print(f"{label} N{n} S{s} C{c} {str(dtype)[6:]}: plan {chosen}, bytes bound {bound_us:.1f} us", flush=True)
        for cluster, r, stages in plans(n, s, c, item):
            args = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), n, s, c, 32, eps, act == "silu",
                    cluster, r, stages, dtype == torch.bfloat16, dtype == torch.bfloat16,
                    torch.cuda.current_stream().cuda_stream)
            y.zero_()
            err = kernel(*args)
            torch.cuda.synchronize()
            active = ctypes.c_int(0)
            occupancy(n, c, cluster, stages, int(item == 2), ctypes.byref(active))
            chunks = [math.ceil((min(s, k * r + r) - min(s, k * r)) / fg.chunk_rows(c, item)) for k in range(cluster)]
            reread = sum(max(0, k - stages) for k in chunks) * fg.chunk_rows(c, item) * c * item * n
            row = dict(shape=label, dtype=str(dtype)[6:], N=n, S=s, C=c, act=act, cluster=cluster, rows=r,
                       stages=stages, smem=fg.cluster_smem(c, item, stages), active_clusters=active.value,
                       reread_mb=reread / 1e6, plan=(cluster, r, stages) == chosen, err=err)
            if err == 0:
                row["over_limit"] = cs._ulp_err(y, want, cs.GN_REL_ERR, cs.GN_MAX_FLOOR)[2]
                row["us"] = 1e3 * cs.time_ms(lambda: kernel(*args), torch)
                fails += bool(row["over_limit"])
            else:
                fails += row["plan"]
            rows.append(row)
            print(f"  cluster {cluster:2d} rows {r:4d} stages {stages:2d} smem {row['smem']:6d} active "
                  f"{active.value:3d} reread {row['reread_mb']:6.2f} MB: "
                  + (f"{row['us']:7.1f} us, over {row['over_limit']}" if err == 0 else f"CUDA error {err}")
                  + (" <- plan" if row["plan"] else ""), flush=True)
        del x, y, want
        torch.cuda.empty_cache()
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_k3_plan_sweep.json").write_text(json.dumps({"card": card_line, "rows": rows}, indent=1))
    if fails:
        print(f"FAIL: {fails} plans beyond K3's gate, or the chosen plan did not launch")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
