"""FLOP counts of a call (port of `faceposegenerator_tpu/core/flops.py`).

The JAX package asks XLA for the compiled program's cost. Here the call is
run once under `torch.utils.flop_counter.FlopCounterMode`, which counts the
aten ops it dispatches (matmuls, convolutions, attention). The port's
hand-written kernels are launched through ctypes, so that mode sees none of
them: each kernel wrapper adds the FLOPs of the function its launch computes
through `count_kernel`, from the formulas of PERF.md's kernel table, and
those are the counts the plain routes' aten ops give, so a function counts
the same on either route:

  attention forward (K1, K2, K8, their fp32 instances): 4·B·H·Sq·Skv·D
  attention backward (K5, K6, fp32): 10·B·H·Sq·Skv·D for the pair of passes
      (S recomputed, dV, dP, dQ, dK), 8· for the dK/dV pass alone, 6· for the
      dQ pass alone
  GN+SiLU → conv3x3 (K4): 2·N·H·W·9·Cin·Cout
  w8a8 dense (K7): 2·M·N·K
  GroupNorm (K3), the split and quantize passes: 0 (the mode counts no
      normalisation or elementwise op either)

Skv is the key tensor's length (masked keys included), as the plain einsum
computes them. Bytes moved are not counted: `bytes_accessed` is None.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

_TALLIES: List[Dict[str, float]] = []  # one for each cost_analysis in progress


def count_kernel(name: str, flops: float) -> None:
    """Add `flops` under `name` to every `cost_analysis` in progress (the
    kernel wrappers call this where they launch)."""
    for tally in _TALLIES:
        tally[name] = tally.get(name, 0.0) + float(flops)


def cost_analysis(fn: Callable, *example_args, **example_kwargs) -> Dict:
    """Run `fn(*args, **kwargs)` once and return {"flops": total,
    "bytes_accessed": None, "aten_flops": {op: n}, "kernel_flops": {kernel:
    n}}. The call's work is queued on the card as usual; the counts come
    from the shapes, not from timing."""
    from torch.utils.flop_counter import FlopCounterMode

    tally: Dict[str, float] = {}
    _TALLIES.append(tally)
    try:
        with FlopCounterMode(display=False) as mode:
            fn(*example_args, **example_kwargs)
    finally:
        _TALLIES.remove(tally)
    aten = {str(op): float(n) for op, n in mode.get_flop_counts().get("Global", {}).items()}
    return {"flops": float(mode.get_total_flops()) + sum(tally.values()), "bytes_accessed": None,
            "aten_flops": aten, "kernel_flops": tally}


def flops(fn: Callable, *example_args, **example_kwargs) -> Optional[float]:
    return cost_analysis(fn, *example_args, **example_kwargs).get("flops")


def summarize(fn: Callable, *example_args, peak_flops_per_sec: Optional[float] = None,
              runtime_s: Optional[float] = None) -> Dict:
    """Cost summary, with the achieved rate given a measured runtime and the
    card's share of its peak given `peak_flops_per_sec` (e.g. 989e12 for an
    H100 SXM's dense bf16 tensor cores)."""
    cost = cost_analysis(fn, *example_args)
    out = {"flops": cost["flops"], "bytes_accessed": cost["bytes_accessed"]}
    if runtime_s and out["flops"]:
        out["achieved_flops_per_sec"] = out["flops"] / runtime_s
        if peak_flops_per_sec:
            out["tensor_core_utilization"] = out["achieved_flops_per_sec"] / peak_flops_per_sec
    return out
