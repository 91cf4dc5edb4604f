"""K3's cluster plan and its summation order, on the CPU.

K3 (csrc/fused_gn.cu) runs one thread-block cluster per image: each CTA
takes a run of rows, holds as many as fit in shared memory, sums per channel
in fp32, and the cluster adds the CTAs' partials in rank order through
distributed shared memory. Here:

  (a) `cluster_plan` at every K3 shape of chip_smoke.py (GN_SHAPES,
      GN_TRAIN_SHAPES, GN_ALONE_SHAPES, GN_F32_SHAPES) and at ragged ones: the CTAs' rows
      cover S exactly once, a CTA's shared memory stays within 227 KB and
      its share of the SM, the cluster has at most 16 CTAs, all N clusters
      run in one wave, and a CTA holds all its chunks or streams them
      through a ring as deep as fits (to be read again after the cluster's
      reduction);
  (b) an emulation of the kernel's arithmetic in numpy fp32 (per-thread
      sums in row order, squares by FMA, the CTA's lanes in order, the
      cluster's ranks in order, the group's channels in order, the affine
      FMA and SiLU) against JAX's `fused_group_norm(..., interpret=True)`,
      the Pallas kernel in interpret mode, within K3's gate (1 ulp of the
      dtype + 1e-3 relative + 1e-5 of the max abs), at bf16 and fp32, C =
      320 and 640, G = 32, with and without SiLU, S not a multiple of a
      CTA's rows, and with β + 3, where a fold of the mean into the shift
      without the scale must fail the gate.
The kernel itself is held to its plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.ops import fused_gn as jfg
from faceposegenerator_tpu_torch.ops import fused_gn as fg

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
try:
    import chip_smoke
finally:
    sys.path.remove(str(REPO))

ITEM = {"bf16": 2, "fp32": 4}
MAIN = sorted({(n, h * w, c, ITEM["bf16"])
               for _, n, h, w, c, *_ in chip_smoke.GN_SHAPES + chip_smoke.GN_TRAIN_SHAPES + chip_smoke.GN_ALONE_SHAPES}
              | {(n, h * w, c, ITEM["fp32"]) for _, n, h, w, c, *_ in chip_smoke.GN_F32_SHAPES})
RAGGED = [(1, 200, 320, 2), (3, 1073, 320, 2), (2, 4097, 512, 4), (1, 7, 64, 2), (5, 2, 96, 2), (1, 1, 1024, 4),
          (2, 16384, 640, 2), (1, 12800, 2048, 2)]


@pytest.mark.parametrize("n,s,c,item", MAIN + RAGGED)
def test_cluster_plan_covers_the_image_within_shared_memory(n, s, c, item):
    cluster, rows, stages = fg.cluster_plan(n, s, c, item)
    assert 1 <= cluster <= fg.MAX_CLUSTER and cluster & (cluster - 1) == 0
    seen = np.zeros(s, np.int64)
    for rank in range(cluster):
        r0 = min(s, rank * rows)
        seen[r0:min(s, r0 + rows)] += 1
    assert (seen == 1).all()
    smem = fg.cluster_smem(c, item, stages)
    assert smem <= fg.SMEM_MAX == 232448
    # the CTAs of all N clusters in one wave; a ring that holds every chunk
    # of a CTA (x read once) or as many as its share of the SM allows, and
    # then the chunks beyond it read again
    ch = fg.chunk_rows(c, item)
    chunks = math.ceil(rows / ch)
    assert ch * c * item <= fg.CHUNK_BYTES or ch == 1
    per_sm = 1 if n <= fg._WAVE_CLUSTERS[cluster] else 2
    assert n <= per_sm * fg._WAVE_CLUSTERS[cluster] or cluster == 1
    cap = min(fg.SMEM_MAX, fg.SM_SMEM // per_sm - 1024)
    assert smem <= cap and 1 <= stages <= chunks
    assert stages == chunks or fg.cluster_smem(c, item, stages + 1) > cap


def test_cluster_plan_at_the_main_paths():
    """Every image's cluster runs in one wave: 8-CTA clusters two to an SM
    for the 16-image UNet shapes, 16-CTA ones for 8 images and fewer at 64²,
    8-CTA ones at 32² and below (256 rows a CTA at least in a 16-CTA
    cluster); a 16²·640 image stays in its cluster's shared memory, a
    64²·320 one keeps 5 of each CTA's 21 chunks and reads the other 16
    again, and 8 images at 32²·640 hold all 11 chunks of a CTA at one CTA
    an SM."""
    assert fg.cluster_plan(16, 4096, 320, 2) == (8, 512, 5) and fg.cluster_plan(16, 1024, 640, 2)[0] == 8
    assert fg.cluster_plan(8, 4096, 320, 2)[0] == 16 and fg.cluster_plan(4, 4096, 512, 2)[0] == 16
    assert fg.cluster_plan(8, 1024, 640, 2) == (8, 128, 11) and fg.cluster_plan(8, 256, 640, 2) == (8, 32, 3)
    assert fg.cluster_plan(1, 256, 640, 2)[0] == 8
    cluster, rows, stages = fg.cluster_plan(16, 256, 640, 2)
    assert stages * fg.chunk_rows(640, 2) >= rows


def test_gn_alone_shapes_are_k4s_norm_sites():
    """chip_smoke's phase 8 holds K3 to its plain version at every shape the
    GN_IMPL-alone request gives it: K4's norm sites (its input shapes, SiLU,
    eps 1e-5, as often a request) are the GN_ALONE_SHAPES and, at 64²·320,
    a shape of GN_SHAPES; their launches are K4's in the fused request."""
    sites = {}
    for _, n, h, w, cin, _, per in chip_smoke.CONV_SHAPES:
        sites[(n, h, w, cin)] = sites.get((n, h, w, cin), 0) + per
    alone = {(n, h, w, c): per for _, n, h, w, c, eps, act, per in chip_smoke.GN_ALONE_SHAPES
             if eps == 1e-5 and act == "silu"}
    assert len(alone) == len(chip_smoke.GN_ALONE_SHAPES)
    rest = set(sites) - set(alone)
    assert all(sites[k] == alone[k] for k in alone) and rest == {(16, 64, 64, 320)}
    assert ("unet conv_norm_out", 16, 64, 64, 320, 1e-5, "silu", 30) in chip_smoke.GN_SHAPES
    assert sum(sites.values()) == chip_smoke.FUSED_LAUNCHES["gn_silu_conv3x3"]
    assert chip_smoke.GN_ALONE_LAUNCHES["fused_group_norm"] == (chip_smoke.FUSED_LAUNCHES["fused_group_norm"]
                                                               + chip_smoke.FUSED_LAUNCHES["gn_silu_conv3x3"])


def ring_run(nchunks, stages, warps, seed):
    """K3's ring (csrc/fused_gn.cu) run by its producer and `warps` consumer
    warps in a random interleaving, each bulk copy landing at a random later
    time, with the kernel's slots and barrier parities. An mbarrier is its
    count of completed phases; mbar_wait(bar, parity) passes once the phase
    of that parity has completed (count % 2 != parity). Raises where a copy
    would overwrite a chunk some warp has still to read, a warp would read a
    slot that does not hold the chunk it wants, or nothing can move (a hang).
    Returns (the chunks each warp summed in step 1, the chunks each warp
    applied in step 3, the chunks loaded in step 3)."""
    rng = np.random.default_rng(seed)
    done = {b: [0] * stages for b in ("full1", "empty1", "full2", "empty2")}
    arrived = {b: [0] * stages for b in ("empty1", "empty2")}
    slot, in_flight, reloaded = [None] * stages, [], []
    summed, applied = [[] for _ in range(warps)], [[] for _ in range(warps)]
    read = {1: [set() for _ in range(stages)], 3: [set() for _ in range(stages)]}  # by step, the warps that read a slot

    def free(step, sl):  # every warp has read, in this step, what the slot holds
        return step == 1 and slot[sl] is None or len(read[step][sl]) == warps

    def producer():
        for k in range(nchunks):  # step 1
            if k >= stages:
                yield ("empty1", k % stages, ((k // stages) & 1) ^ 1)
            assert free(1, k % stages) and not any(f[1] == k % stages for f in in_flight), ("overwrites", k)
            in_flight.append(("full1", k % stages, k))
        yield ("step 1 done",)  # the cluster barrier: every warp has summed every chunk
        for i in range(stages, nchunks):  # step 3
            k = nchunks - 1 - i
            yield ("empty2", k % stages, ((i // stages) & 1) ^ 1)
            assert free(3, k % stages) and not any(f[1] == k % stages for f in in_flight), ("overwrites", k)
            in_flight.append(("full2", k % stages, k))
            reloaded.append(k)

    def consumer(w):
        for k in range(nchunks):
            sl = k % stages
            yield ("full1", sl, (k // stages) & 1)
            assert slot[sl] == k, ("step 1 reads", k, slot[sl])
            summed[w].append(k)
            read[1][sl].add(w)
            if k + stages < nchunks:
                yield ("arrive", "empty1", sl)
        yield ("summed",)
        for i in range(nchunks):
            k = nchunks - 1 - i
            sl = k % stages
            if i >= stages:
                yield ("full2", sl, ((i // stages) - 1) & 1)
            assert slot[sl] == k, ("step 3 reads", k, slot[sl])
            applied[w].append(k)
            read[3][sl].add(w)
            if i + stages < nchunks:
                yield ("arrive", "empty2", sl)

    agents = [producer()] + [consumer(w) for w in range(warps)]
    pending = [next(a, None) for a in agents]
    while any(p is not None for p in pending) or in_flight:
        ready = []
        for j, p in enumerate(pending):
            if p is None:
                continue
            if p[0] == "arrive" or p[0] == "summed":
                ready.append(j)
            elif p[0] == "step 1 done":
                if all(q is None or q[0] != "full1" and len(summed[w]) == nchunks
                       for w, q in enumerate(pending[1:])):
                    ready.append(j)
            elif done[p[0]][p[1]] % 2 != p[2]:
                ready.append(j)
        moves = ready + ["land"] * bool(in_flight)
        assert moves, "hang: every agent waits and no copy is in flight"
        pick = moves[rng.integers(len(moves))]
        if pick == "land":
            bar, sl, k = in_flight.pop(rng.integers(len(in_flight)))
            slot[sl] = k
            read[1 if bar == "full1" else 3][sl] = set()
            done[bar][sl] += 1
            continue
        p = pending[pick]
        if p[0] == "arrive":
            arrived[p[1]][p[2]] += 1
            if arrived[p[1]][p[2]] % warps == 0:
                done[p[1]][p[2]] += 1
        pending[pick] = next(agents[pick], None)
    return summed, applied, reloaded


@pytest.mark.parametrize("nchunks,stages", [(1, 1), (3, 3), (3, 6), (5, 1), (21, 5), (16, 5), (11, 5), (43, 6),
                                            (7, 3), (6, 5), (16, 12), (9, 2)])
def test_ring_reads_only_the_chunks_it_no_longer_holds(nchunks, stages):
    """In any interleaving: step 1 sums every chunk once in order; step 3
    applies every chunk once, last to first, the last `stages` from the
    slots step 1 left them in and only the others read again, each into a
    slot every warp has freed; every mbarrier wait sees the phase it is
    meant to, and nothing hangs."""
    for seed in range(20):
        summed, applied, reloaded = ring_run(nchunks, stages, 3, seed)
        assert all(s == list(range(nchunks)) for s in summed)
        assert all(a == list(range(nchunks))[::-1] for a in applied)
        assert reloaded == list(range(max(0, nchunks - stages)))[::-1]


def test_ring_model_catches_a_wrong_parity():
    """The model is not vacuous: a consumer's or the producer's step-3 wait
    on the wrong parity lets a copy overwrite a chunk still to be read, a
    read find the wrong chunk, or the ring hang."""
    import inspect

    for old, new in (('("full2", sl, ((i // stages) - 1) & 1)', '("full2", sl, (i // stages) & 1)'),
                     ('("empty2", k % stages, ((i // stages) & 1) ^ 1)', '("empty2", k % stages, (i // stages) & 1)')):
        src = inspect.getsource(ring_run)
        assert old in src
        scope = {"np": np}
        exec(src.replace(old, new).replace("def ring_run(", "def broken(", 1), scope)
        with pytest.raises(AssertionError):
            for seed in range(20):
                scope["broken"](21, 5, 3, seed)


def _round(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype).float().numpy()


def _fma(a, b, c):
    """fp32 a·b + c rounded once (the product is exact in fp64 for these
    inputs; the sum rounds twice, which is rare and far inside the gate)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_k3(x, gamma, beta, groups, eps, act, item, fold="kernel"):
    """K3's arithmetic on x (N, S, C) fp32 holding the dtype's values, in
    the kernel's order; fp32 output before the rounding to the dtype.
    fold="mean_unscaled" folds the mean into the shift without the scale."""
    n, s, c = x.shape
    cluster, rows = fg.cluster_plan(n, s, c, item)[:2]
    lanes = fg.CONSUMERS // (c * item // 16)
    cg = c // groups
    inv_count = np.float32(1.0) / np.float32(cg * s)
    out = np.empty_like(x)
    for img in range(n):
        tot_s, tot_q = np.zeros(c, np.float32), np.zeros(c, np.float32)
        for rank in range(cluster):
            r0 = min(s, rank * rows)
            xs = x[img, r0:min(s, r0 + rows)]
            # thread (v, lane) sums rows lane, lane + lanes, ... in order
            ts, tq = np.zeros((lanes, c), np.float32), np.zeros((lanes, c), np.float32)
            for i in range(math.ceil(len(xs) / lanes)):
                blk = xs[i * lanes:(i + 1) * lanes]
                m = len(blk)
                ts[:m] = ts[:m] + blk
                tq[:m] = _fma(blk, blk, tq[:m])
            ps, pq = np.zeros(c, np.float32), np.zeros(c, np.float32)
            for k in range(lanes):  # the CTA's lanes in order
                ps, pq = ps + ts[k], pq + tq[k]
            tot_s, tot_q = tot_s + ps, tot_q + pq  # the cluster's ranks in order
        a, b = np.zeros(groups, np.float32), np.zeros(groups, np.float32)
        for j in range(cg):  # each group's channels in order
            a, b = a + tot_s[j::cg], b + tot_q[j::cg]
        mean = a * inv_count
        var = b * inv_count - mean * mean
        inv = (np.float32(1.0) / np.sqrt(var + np.float32(eps))).astype(np.float32)
        scale = np.repeat(inv, cg) * gamma
        shift = beta - np.repeat(mean, cg) * scale if fold == "kernel" else beta - np.repeat(mean, cg)
        y = _fma(x[img], scale, shift)
        if act == "silu":
            y = (y / (np.float32(1.0) + np.exp(-y))).astype(np.float32)
        out[img] = y
    return out


def _over_gate(out, ref, dtype):
    """How many outputs miss K3's gate: 1 ulp of the dtype + 1e-3·|ref| +
    1e-5·max |ref| (chip_smoke.GN_REL_ERR, GN_MAX_FLOOR)."""
    bits = 8 if dtype == torch.bfloat16 else 24
    ulp = np.ldexp(np.ones_like(ref), np.frexp(np.maximum(np.abs(ref), 2.0**-126))[1] - bits)
    slack = ulp + chip_smoke.GN_REL_ERR * np.abs(ref) + chip_smoke.GN_MAX_FLOOR * np.abs(ref).max()
    return int((np.abs(out - ref) > slack).sum())


DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp32": (jnp.float32, torch.float32)}
CASES = [  # (shape, act, dtype, beta shift): C = 320 and 640, G = 32; S = 200 is ragged over 16 CTAs
    ((2, 16, 16, 320), None, "bf16", 0.0), ((2, 16, 16, 320), "silu", "bf16", 0.0),
    ((2, 16, 16, 320), None, "fp32", 0.0), ((2, 16, 16, 320), "silu", "fp32", 0.0),
    ((2, 8, 8, 640), None, "bf16", 0.0), ((2, 8, 8, 640), "silu", "bf16", 0.0),
    ((2, 8, 8, 640), None, "fp32", 0.0), ((2, 8, 8, 640), "silu", "fp32", 0.0),
    ((1, 10, 20, 320), "silu", "bf16", 0.0), ((2, 8, 8, 640), "silu", "bf16", 3.0),
    ((2, 16, 16, 320), None, "fp32", 3.0),
]


def _case(shape, dtype, shift):
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = _round(rng.standard_normal(shape) * 3 + 1, DTYPES[dtype][1])
    gamma = rng.standard_normal(c).astype(np.float32)
    beta = (rng.standard_normal(c) + shift).astype(np.float32)
    return x, gamma, beta


@pytest.fixture(scope="module")
def jax_outputs():
    out = {}
    for i, (shape, act, dtype, shift) in enumerate(CASES):
        x, gamma, beta = _case(shape, dtype, shift)
        y = jfg.fused_group_norm(jnp.asarray(x).astype(DTYPES[dtype][0]), jnp.asarray(gamma), jnp.asarray(beta), 32,
                                 1e-6, act, True)
        out[i] = np.asarray(y.astype(jnp.float32))
    return out


@pytest.mark.parametrize("case", range(len(CASES)))
def test_emulated_kernel_order_meets_k3_gate_against_jax(jax_outputs, case):
    shape, act, dtype, shift = CASES[case]
    x, gamma, beta = _case(shape, dtype, shift)
    tdt = DTYPES[dtype][1]
    n, c = shape[0], shape[-1]
    y = emulate_k3(x.reshape(n, -1, c), gamma, beta, 32, 1e-6, act, ITEM[dtype])
    got = _round(y, tdt).reshape(shape)
    assert _over_gate(got, jax_outputs[case], tdt) == 0
    if shift:  # the gate sees a mean folded into the shift without the scale
        wrong = emulate_k3(x.reshape(n, -1, c), gamma, beta, 32, 1e-6, act, ITEM[dtype], fold="mean_unscaled")
        assert _over_gate(_round(wrong, tdt).reshape(shape), jax_outputs[case], tdt) > 0


def test_emulation_is_the_plain_version_up_to_rounding():
    """The emulated order and `fused_group_norm_plain` (torch's reductions)
    agree within the same gate at a main-path width."""
    x, gamma, beta = _case((2, 16, 16, 640), "bf16", 0.0)
    y = _round(emulate_k3(x.reshape(2, -1, 640), gamma, beta, 32, 1e-5, "silu", 2), torch.bfloat16)
    want = fg.fused_group_norm_plain(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(gamma),
                                     torch.from_numpy(beta), 32, 1e-5, "silu").float().numpy()
    assert _over_gate(y.reshape(want.shape), want, torch.bfloat16) == 0
