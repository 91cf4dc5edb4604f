// Flash attention in fp32 for Hopper (sm_90a): the fp32 instance of the
// forward kernels (K1, K2) and of the backward kernels (K5, K6), for the
// fp32 compute policy (`StableDiffusionPipeline.from_random()`'s default, the
// parity policy of the train step).
//
//   flash_f32_split    the pre-pass: fp32 operands split into tf32 hi and lo
//                      planes, in natural or transposed layout (below);
//   flash_fwd_f32      softmax(q·kᵀ·scale)·v, keys >= kv_end excluded, and the
//                      natural-log log-sum-exp of each row when asked;
//   flash_bwd_f32_dkv  dK = scale·dSᵀ·Q, dV = Pᵀ·dO;
//   flash_bwd_f32_dq   dQ = scale·dS·K;
// with P = exp(S·scale − lse) recomputed from the forward's LSE and
// dS = P∘(dP − D), D = rowsum(dO∘O) (computed by the wrapper), as
// `attention_bwd_plain` does. Two passes, no atomics: deterministic.
//
// Replaces faceposegenerator_tpu/ops/flash_attention.py at fp32 operands:
// `_fwd_kernel_packed` (:258) and `_fwd_kernel` (:104) forward,
// `_bwd_kernel_packed_dkv/_dq` (:711, :777) and `_bwd_kernel_plain_dkv/_dq`
// (:542, :585) backward; JAX's `flash_supported` sends fp32 to the same
// kernels as bf16 (flash_attention.py:87-101).
//
// Arithmetic: 3xTF32 on the tensor cores. fp32 FFMA peaks at 67 TFLOP/s on
// an H100 SXM; tf32 wgmma at 495. One tf32 product rounds each operand to
// 11 significant bits, ~1e-3 relative, which misses the fp32 gate
// (chip_smoke.py phase 11 holds plain TF32 attention to it and sees it
// fail). So every operand x is split as hi = rna_tf32(x), lo = rna_tf32(x −
// hi) (`tf32_split`, explicit rounding, never the tensor core's own reading
// of the 13 low bits), and each product a·b is a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi, three wgmma into one fp32 accumulator (small terms first). hi
// and lo carry 22 of fp32's 24 bits, and the dropped a_lo·b_lo is ~2^-22 of
// |a·b|, so a dot product lands within a few fp32 ulps of its FFMA value
// (tests/test_torch_tf32_split.py emulates this arithmetic on the CPU). The
// tensor cores add into the accumulator with truncation, though, so a long
// chain of products drifts: 64 key tiles × 24 products into one running
// accumulator end ~4e-5 of the output's max abs off at 4096 keys, against
// the fp32 gate's 1e-4 (LSE 1e-5). Where registers allow (the forward and
// dQ at D <= 128), each tile's second product goes into a fresh
// accumulator that FFMA adds to the running one: 5e-6. The cost is 3× the
// tensor-core work: the bound is 3·ops / 495 TFLOP/s, 2.5× below FFMA's.
//
// Layouts. tf32 wgmma reads both shared-memory operands K-major only (the
// transpose flags exist for 16-bit types alone). Where the reduction runs
// along the rows of a stored tensor (V in O += P·V; dO and Q in dV += Pᵀ·dO
// and dK += dSᵀ·Q; K in dQ += dS·K), the tensor has to reach shared memory
// transposed. `flash_f32_split`, one launch per call of the wrapper, writes
// each operand's hi and lo as the two planes of one buffer:
//   natural     (2, B·H, S, D): q, k, v, dO as they are (A and B operands
//               of S = Q·Kᵀ, dP = dO·Vᵀ, and of Sᵀ, dPᵀ in the dK/dV pass);
//   transposed  (2, B·H, D, S_pad), S_pad = S rounded up to 64, zero past S:
//               V, K, Q, dO for the second products.
// The second products take P (or dS) from registers, straight from the
// first product's accumulator (the RS form): a thread's accumulator holds
// columns 2t, 2t + 1 of each 8-column chunk, and the tf32 A fragment wants
// columns t and t + 4. Rather than shuffle, the transposed layout permutes
// the keys within each group of 8 to the order (0, 2, 4, 6, 1, 3, 5, 7): a
// sum over keys does not depend on their order, and accumulator registers
// (4i, 4i + 2, 4i + 1, 4i + 3) are then the A fragment of k8 slice i as
// they are.
//
// One kernel body (`flash_f32_body`) serves the three entry points. A CTA
// has 384 threads: warpgroup 2 produces (TMA), warpgroups 0 and 1 consume
// (setmaxnreg 40 / 232: 2·128·232 + 128·40 <= 65536). Two shapes:
//   D = 64  the consumers own 64 rows each (128 rows a CTA) and share one
//           ring of tiles; the A operands of the first products (Q; Q and
//           dO; K and V in the dK/dV pass) stay in shared memory for the
//           whole CTA;
//   D >= 128 the consumers own the same 64 rows and one half of the head
//           dim each: each computes the first products over its half,
//           they swap the partial sums through shared memory and add them
//           (mine + other's: the same sum in both, fp32 addition commutes),
//           so each product runs once; each accumulates its half of the
//           output columns (at D = 512: 4 × 64 columns, 128 registers), and
//           each has its own ring, A operands streamed with B, since a
//           64 × 512 hi/lo tile alone would fill shared memory (256 KB).
//           The dK/dV pass runs dV and dK as two launches, each with one
//           accumulator per warpgroup half: registers do not hold both.
// Every tile moved is 64 rows × 32 fp32 columns × (hi, lo) = 16 KB: one
// TMA box of a 4-D map (32, S or D, B·H, plane), 128-byte swizzled, which
// zero-fills rows past the tensor. The producer thread of a ring walks the
// same sequence of tiles as its consumers; each tile has a full and an empty
// mbarrier. Each first product is 4 k8 slices × 3 wgmma per 32 columns of
// the head dim; the consumer keeps one chunk's wgmma group in flight while
// it waits for the next chunk's tiles where the ring holds two chunks.
//
// The online softmax keeps the rounded base: the running sums stay relative to
// the rounded base b = fl(m · scale · log2 e) of the running max, and a tile
// rescales them, and O, by exactly 2^(b_old − b_new); any other rescale
// multiplies them by 2^(its rounding error) on every tile, a drift past the
// 1e-5 LSE gate over 64 tiles.
//
// Plain C interface, loaded with ctypes. Every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (or the
// error of encoding a tensor map).

#include "sm90_common.cuh"

namespace {

constexpr float LOG2E_F = 1.4426950408889634f, LN2_F = 0.6931471805599453f;

enum Mode { FWD, DQ, DKV, DV, DK };

template <int D, int MODE>
struct Cfg {
  static constexpr int R = D == 64 ? 2 : 1;  // row groups of 64 (consumer warpgroups over rows)
  static constexpr int G = 2 / R;            // head-dim halves (consumer warpgroups over D)
  static constexpr int DG = D / G;           // head-dim columns of one consumer
  static constexpr int NCH = DG / 32;        // its 32-column chunks of the first products
  static constexpr int NB = DG / 64;         // its 64-column blocks of the second product's output
  static constexpr int NA = (MODE == FWD || MODE == DV) ? 1 : 2;  // first products: S (and dP)
  static constexpr int NS = MODE == DKV ? 2 : 1;                  // second products: dV (and dK)
  static constexpr bool RES = R == 2;                              // A operands resident
  static constexpr int ITEM = 16384, PLANE = 8192;
  static constexpr int RES_BYTES = RES ? NA * 2 * R * ITEM : 0;  // A operand × 2 chunks × R row groups
  static constexpr int X_BYTES = G == 2 ? NA * 2 * ITEM : 0;     // partial sums: first product × consumer
  static constexpr int STAGES = (224 * 1024 - RES_BYTES - X_BYTES) / (G * ITEM);
  static constexpr int IPC = NA * (RES ? 1 : 2);     // ring tiles per 32-column chunk
  static constexpr int LAG = 2 * IPC <= STAGES;      // keep a chunk's group in flight
  // each tile's second product into a fresh accumulator, added to the
  // running one by FFMA, where registers allow (one 64-column block)
  static constexpr bool FRESH = NB == 1 && (MODE == FWD || MODE == DQ);
  static constexpr int THREADS = 384, PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static_assert(128 * (PRODUCER_REGS + 2 * CONSUMER_REGS) <= 65536, "register file");
  static_assert(STAGES >= IPC && STAGES >= NB, "ring too shallow");
  static constexpr int RING_OFF = RES_BYTES + X_BYTES;
  static constexpr int BAR_OFF = RING_OFF + G * STAGES * ITEM;
  // tiles, one resident-tile barrier, full and empty barriers per stage, alignment room
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * G * STAGES) + 1024;
};

struct Args {
  float* out0;  // FWD: o; DQ: dq; DKV and DV: dv; DK: dk
  float* out1;  // DKV: dk
  float* lse;   // FWD: written when not null; backward: read
  const float* dd;
  long long o0_b, o0_s, o0_h, o1_b, o1_s, o1_h;
  int H, Sq;
  int rows;      // rows of the output (Sq, or Skv in the dK/dV pass)
  int n_tiles;   // 64-column tiles of the loop (keys up to kv_end, or queries)
  int row_live;  // rows at or past it are masked (Sq, or kv_end)
  int col_live;  // columns at or past it are masked (kv_end, or Sq)
  float mult0, mult1, scale_log2;
};

__device__ __forceinline__ float neg_inf_f() { return __int_as_float(0xff800000); }

template <int D, int MODE>
__device__ __forceinline__ void flash_f32_body(const CUtensorMap* tmA1, const CUtensorMap* tmB1,
                                               const CUtensorMap* tmA2, const CUtensorMap* tmB2,
                                               const CUtensorMap* tmT1, const CUtensorMap* tmT2, const Args& a) {
  using C = Cfg<D, MODE>;
  constexpr int ST = C::STAGES, NB = C::NB, ITEM = C::ITEM, PLANE = C::PLANE;
  extern __shared__ __align__(1024) unsigned char smem_f32[];
  const uint32_t raw = smem_u32(smem_f32), base = (raw + 1023u) & ~1023u;
  const uint32_t sRes = base, sX = base + C::RES_BYTES, sRing = base + C::RING_OFF;
  const uint32_t bar_res = base + C::BAR_OFF;
  auto full = [&](int g, int s) { return bar_res + 8u * (1 + g * ST + s); };
  auto empty = [&](int g, int s) { return bar_res + 8u * (1 + C::G * ST + g * ST + s); };
  auto stage = [&](int g, int s) { return sRing + static_cast<uint32_t>((g * ST + s) * ITEM); };
  const int bh = blockIdx.y, row0 = blockIdx.x * 64 * C::R;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(bar_res, 1);
    for (int g = 0; g < C::G; ++g)
      for (int s = 0; s < ST; ++s) {
        mbar_init(full(g, s), 1);
        mbar_init(empty(g, s), 4 * C::R);  // one arrival per consumer warp
      }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: lane 0 of warp g feeds ring g
    setmaxnreg_dec<C::PRODUCER_REGS>();
    const int lane = threadIdx.x & 31, g = (threadIdx.x >> 5) & 3;
    if (lane == 0 && g < C::G) {
      if (C::RES) {
        mbar_arrive_expect_tx(bar_res, C::RES_BYTES);
        for (int p = 0; p < C::NA; ++p)
          for (int c = 0; c < 2; ++c)
            for (int r = 0; r < C::R; ++r)
              tma_load_4d(sRes + ((p * 2 + c) * C::R + r) * ITEM, p ? tmA2 : tmA1, bar_res, 32 * c, row0 + 64 * r,
                          bh, 0);
      }
      int it = 0;
      auto item = [&](const CUtensorMap* m, int x, int y) {
        const int s = it % ST;
        mbar_wait(empty(g, s), ((it / ST) & 1) ^ 1);
        mbar_arrive_expect_tx(full(g, s), ITEM);
        tma_load_4d(stage(g, s), m, full(g, s), x, y, bh, 0);
        ++it;
      };
      for (int j = 0; j < a.n_tiles; ++j) {
        const int col0 = 64 * j;
        for (int c = 0; c < C::NCH; ++c) {
          const int dc = g * C::DG + 32 * c;
          if (!C::RES) item(tmA1, dc, row0);
          item(tmB1, dc, col0);
          if (C::NA == 2) {
            if (!C::RES) item(tmA2, dc, row0);
            item(tmB2, dc, col0);
          }
        }
        for (int kc = 0; kc < 2; ++kc)
          for (int s = 0; s < C::NS; ++s)
            for (int vb = 0; vb < NB; ++vb) item(s ? tmT2 : tmT1, col0 + 32 * kc, g * C::DG + 64 * vb);
      }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, t4 = lane & 3, tid = threadIdx.x & 127;
  const int r = C::R == 2 ? wg : 0, g = C::G == 2 ? wg : 0;
  const int rowA = row0 + 64 * r + 16 * w + (lane >> 2), rowB = rowA + 8;  // this thread's two rows
  const bool liveA = rowA < a.row_live, liveB = rowB < a.row_live;
  const float sl2 = a.scale_log2;
  float* xbuf = reinterpret_cast<float*>(smem_f32 + (sX - raw));

  float sacc[32], pacc[32];  // S and dP (Sᵀ and dPᵀ in the dK/dV pass)
  float acc[C::NS][NB][32];
  float tacc[NB][32];  // this tile's second product (FRESH)
#pragma unroll
  for (int s = 0; s < C::NS; ++s)
#pragma unroll
    for (int vb = 0; vb < NB; ++vb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[s][vb][i] = 0.f;
      fence_regs(acc[s][vb]);  // zeroed here, not next to a wgmma in flight
    }
  auto fence_acc = [&]() {
#pragma unroll
    for (int s = 0; s < C::NS; ++s)
#pragma unroll
      for (int vb = 0; vb < NB; ++vb) fence_regs(acc[s][vb]);
    if (C::FRESH) fence_regs(tacc[0]);
  };

  // row statistics: the forward's running max, its base and sum; the dQ
  // pass's log2-domain lse and D of its rows
  float m0 = neg_inf_f(), m1 = neg_inf_f(), mb0 = 0.f, mb1 = 0.f, l0 = 0.f, l1 = 0.f, al0 = 1.f, al1 = 1.f;
  float lr0 = 0.f, lr1 = 0.f, dr0 = 0.f, dr1 = 0.f;
  if (MODE == DQ) {
    const long long o = static_cast<long long>(bh) * a.Sq;
    if (liveA) lr0 = a.lse[o + rowA] * LOG2E_F, dr0 = a.dd[o + rowA];
    if (liveB) lr1 = a.lse[o + rowB] * LOG2E_F, dr1 = a.dd[o + rowB];
  }

  int it = 0, rel = 0;  // the next ring tile to consume, and to release
  auto release_upto = [&](int n) {
    for (; rel < n; ++rel) mbar_arrive_if(empty(g, rel % ST), lane == 0);
  };
  auto wait_full = [&](int i) { mbar_wait(full(g, i % ST), (i / ST) & 1); };
  if (C::RES) mbar_wait(bar_res, 0);

  // three k8 products of one 32-column chunk: lo·hi, hi·lo, hi·hi
  auto chunk3 = [&](float (&d)[32], uint32_t ta, uint32_t tb, bool first) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_tf32_ss_m64n64(d, desc_k(ta + PLANE + 32 * kk), desc_k(tb + 32 * kk), !(first && kk == 0));
      wgmma_tf32_ss_m64n64(d, desc_k(ta + 32 * kk), desc_k(tb + PLANE + 32 * kk), 1);
      wgmma_tf32_ss_m64n64(d, desc_k(ta + 32 * kk), desc_k(tb + 32 * kk), 1);
    }
  };

  // one second product over 32 columns of the tile (k8 slices 4kc..4kc+3):
  // e's accumulator registers as the tf32 A fragments, NB ring tiles as B;
  // into `tacc` (FRESH: the tile's first wgmma overwrites it) or `acc`
  auto second = [&](float (&e)[32], float (&o)[NB][32], int kc) {
    wgmma_wait<0>();
    fence_acc();
    release_upto(it);
    uint32_t fh[16], fl[16];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int i = 4 * kc + ii;
      tf32_split(e[4 * i + 0], fh[4 * ii + 0], fl[4 * ii + 0]);
      tf32_split(e[4 * i + 2], fh[4 * ii + 1], fl[4 * ii + 1]);
      tf32_split(e[4 * i + 1], fh[4 * ii + 2], fl[4 * ii + 2]);
      tf32_split(e[4 * i + 3], fh[4 * ii + 3], fl[4 * ii + 3]);
    }
#pragma unroll
    for (int vb = 0; vb < NB; ++vb) wait_full(it + vb);
    fence_regs(fh);
    fence_regs(fl);
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int vb = 0; vb < NB; ++vb) {
      const uint32_t tb = stage(g, (it + vb) % ST);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int f = 4 * ii;
        wgmma_tf32_rs_m64n64(o[vb], fl[f], fl[f + 1], fl[f + 2], fl[f + 3], desc_k(tb + 32 * ii),
                             !(C::FRESH && kc == 0 && ii == 0));
        wgmma_tf32_rs_m64n64(o[vb], fh[f], fh[f + 1], fh[f + 2], fh[f + 3], desc_k(tb + PLANE + 32 * ii), 1);
        wgmma_tf32_rs_m64n64(o[vb], fh[f], fh[f + 1], fh[f + 2], fh[f + 3], desc_k(tb + 32 * ii), 1);
      }
    }
    wgmma_commit();
    it += NB;
  };

  for (int j = 0; j < a.n_tiles; ++j) {
    const int col0 = 64 * j;
    // first products over this consumer's head-dim chunks. The first wgmma
    // overwrites them; zeroing them first ends the previous tile's values
    // here, so their registers are free during the second products.
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
    fence_regs(sacc);
    if (C::NA == 2) fence_regs(pacc);
    // the dK/dV pass: lane l loads the log2-domain lse and D of columns
    // col0 + 2l, + 1 now, under the first products; the elementwise step
    // takes each column's from its lane by shuffle (16 loads a thread, held
    // in registers, would spill at D = 512)
    float lc2[2] = {0.f, 0.f}, dc2[2] = {0.f, 0.f};
    if (MODE == DKV || MODE == DV || MODE == DK) {
      const long long o = static_cast<long long>(bh) * a.Sq;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int col = col0 + 2 * lane + e2;
        if (col < a.col_live) {
          lc2[e2] = a.lse[o + col] * LOG2E_F;
          if (MODE != DV) dc2[e2] = a.dd[o + col];
        }
      }
    }
#pragma unroll 1
    for (int c = 0; c < C::NCH; ++c) {
#pragma unroll
      for (int q = 0; q < C::IPC; ++q) wait_full(it + q);
      uint32_t a1, b1, a2 = 0, b2 = 0;
      if (C::RES) {
        a1 = sRes + ((0 * 2 + c) * C::R + r) * ITEM;
        b1 = stage(g, it % ST);
        if (C::NA == 2) a2 = sRes + ((1 * 2 + c) * C::R + r) * ITEM, b2 = stage(g, (it + 1) % ST);
      } else {
        a1 = stage(g, it % ST);
        b1 = stage(g, (it + 1) % ST);
        if (C::NA == 2) a2 = stage(g, (it + 2) % ST), b2 = stage(g, (it + 3) % ST);
      }
      wgmma_fence();
      chunk3(sacc, a1, b1, c == 0);
      if (C::NA == 2) chunk3(pacc, a2, b2, c == 0);
      wgmma_commit();
      it += C::IPC;
      if (C::LAG) {
        wgmma_wait<1>();
        release_upto(it - C::IPC);
      } else {
        wgmma_wait<0>();
        release_upto(it);
      }
    }
    wgmma_wait<0>();
    fence_regs(sacc);
    if (C::NA == 2) fence_regs(pacc);
    release_upto(it);

    if (C::G == 2) {  // swap the partial sums with the other half's consumer
      const int og = 1 - g;
      if (j > 0) named_bar_sync(2 + g, 256);  // the other has read my previous partials
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        xbuf[((0 * 2 + g) * 32 + i) * 128 + tid] = sacc[i];
        if (C::NA == 2) xbuf[((1 * 2 + g) * 32 + i) * 128 + tid] = pacc[i];
      }
      named_bar_sync(1, 256);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sacc[i] += xbuf[((0 * 2 + og) * 32 + i) * 128 + tid];
        if (C::NA == 2) pacc[i] += xbuf[((1 * 2 + og) * 32 + i) * 128 + tid];
      }
      if (j + 1 < a.n_tiles) named_bar_arrive(2 + og, 256);
    }

    // elementwise: register 4i + e holds row (e < 2 ? rowA : rowB), column
    // col0 + 8i + 2·t4 + (e & 1)
    if (MODE == FWD) {
      if (col0 + 64 > a.col_live) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col0 + 8 * i + 2 * t4 + (e & 1) >= a.col_live) sacc[4 * i + e] = neg_inf_f();
      }
      float mx0 = neg_inf_f(), mx1 = neg_inf_f();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * i], sacc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float base0 = (mn0 == neg_inf_f() ? 0.f : mn0) * sl2, base1 = (mn1 == neg_inf_f() ? 0.f : mn1) * sl2;
      // 1 exactly while the max holds
      al0 = m0 == neg_inf_f() ? 0.f : exp2f(mb0 - base0);
      al1 = m1 == neg_inf_f() ? 0.f : exp2f(mb1 - base1);
      m0 = mn0, m1 = mn1, mb0 = base0, mb1 = base1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sacc[4 * i + 0] = exp2f(fmaf(sacc[4 * i + 0], sl2, -base0));
        sacc[4 * i + 1] = exp2f(fmaf(sacc[4 * i + 1], sl2, -base0));
        sacc[4 * i + 2] = exp2f(fmaf(sacc[4 * i + 2], sl2, -base1));
        sacc[4 * i + 3] = exp2f(fmaf(sacc[4 * i + 3], sl2, -base1));
        rs0 += sacc[4 * i + 0] + sacc[4 * i + 1];
        rs1 += sacc[4 * i + 2] + sacc[4 * i + 3];
      }
      l0 = l0 * al0 + rs0;  // per-thread partial row sums; summed over the quad at the end
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int vb = 0; vb < (C::FRESH ? 0 : NB); ++vb)  // FRESH: rescaled as the tile is added
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[0][vb][4 * i + 0] *= al0;
          acc[0][vb][4 * i + 1] *= al0;
          acc[0][vb][4 * i + 2] *= al1;
          acc[0][vb][4 * i + 3] *= al1;
        }
    } else if (MODE == DQ) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = (e < 2 ? liveA : liveB) && col0 + 8 * i + 2 * t4 + (e & 1) < a.col_live;
          const float p = live ? exp2f(fmaf(sacc[4 * i + e], sl2, -(e < 2 ? lr0 : lr1))) : 0.f;
          pacc[4 * i + e] = p * (pacc[4 * i + e] - (e < 2 ? dr0 : dr1));
        }
    } else {  // the dK/dV pass: rows are keys, columns queries
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int col = col0 + 8 * i + 2 * t4 + e2;  // loaded by lane 4i + t4
          const bool cl = col < a.col_live;
          const float lc = __shfl_sync(0xffffffffu, lc2[e2], 4 * i + t4);
          const float dc = MODE != DV ? __shfl_sync(0xffffffffu, dc2[e2], 4 * i + t4) : 0.f;
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int k = 4 * i + 2 * h2 + e2;
            const bool live = cl && (h2 ? liveB : liveA);
            const float p = live ? exp2f(fmaf(sacc[k], sl2, -lc)) : 0.f;
            if (MODE != DK) sacc[k] = p;
            if (MODE != DV) pacc[k] = p * (pacc[k] - dc);
          }
        }
    }

    // second products: O += P·V, dQ += dS·K, dV += Pᵀ·dO, dK += dSᵀ·Q
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      if (MODE == FWD || MODE == DV || MODE == DKV) second(sacc, C::FRESH ? tacc : acc[0], kc);
      if (MODE == DQ || MODE == DK) second(pacc, C::FRESH ? tacc : acc[0], kc);
      if (MODE == DKV) second(pacc, acc[C::NS - 1], kc);
    }
    wgmma_wait<0>();
    fence_acc();
    release_upto(it);
    if (C::FRESH) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[0][0][i] = MODE == FWD ? fmaf(acc[0][0][i], (i & 2) ? al1 : al0, tacc[0][i]) : acc[0][0][i] + tacc[0][i];
    }
  }

  // epilogue: this thread's rows rowA, rowB; columns g·DG + 64vb + 8i + 2t4 (+1)
  const int b = bh / a.H, h = bh % a.H;
  float mulA = a.mult0, mulB = a.mult0;
  if (MODE == FWD) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    mulA = 1.f / l0;
    mulB = 1.f / l1;
  }
#pragma unroll
  for (int s = 0; s < C::NS; ++s) {
    float* out = s ? a.out1 : a.out0;
    const long long ob = s ? a.o1_b : a.o0_b, os = s ? a.o1_s : a.o0_s, oh = s ? a.o1_h : a.o0_h;
    const float mA = s ? a.mult1 : mulA, mB = s ? a.mult1 : mulB;
    float* base_bh = out + b * ob + h * oh + g * C::DG + 2 * t4;
#pragma unroll
    for (int vb = 0; vb < NB; ++vb)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * vb + 8 * i;
        if (rowA < a.rows)
          *reinterpret_cast<float2*>(base_bh + rowA * os + col) =
              make_float2(acc[s][vb][4 * i] * mA, acc[s][vb][4 * i + 1] * mA);
        if (rowB < a.rows)
          *reinterpret_cast<float2*>(base_bh + rowB * os + col) =
              make_float2(acc[s][vb][4 * i + 2] * mB, acc[s][vb][4 * i + 3] * mB);
      }
  }
  // natural-log LSE of the scaled logits: l sums 2^(s · scale · log2 e − b)
  if (MODE == FWD && a.lse != nullptr && g == 0 && t4 == 0) {
    float* lb = a.lse + static_cast<long long>(bh) * a.Sq;
    if (rowA < a.rows) lb[rowA] = fmaf(mb0, LN2_F, logf(l0));
    if (rowB < a.rows) lb[rowB] = fmaf(mb1, LN2_F, logf(l1));
  }
}

// The three entry kernels: one body, named apart so ptxas reports each.
template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tvt, const Args a) {
  flash_f32_body<D, FWD>(&tq, &tk, &tq, &tk, &tvt, &tvt, a);
}

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_f32_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tkt, const Args a) {
  flash_f32_body<D, DQ>(&tq, &tk, &tdo, &tv, &tkt, &tkt, a);
}

template <int D, int MODE>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_f32_dkv_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tdot, const __grid_constant__ CUtensorMap tqt,
                             const Args a) {
  // dV's B operand is dOᵀ, dK's is Qᵀ
  flash_f32_body<D, MODE>(&tk, &tq, &tv, &tdo, MODE == DK ? &tqt : &tdot, &tqt, a);
}

// ---------------------------------------------------------------------------
// the split pre-pass
// ---------------------------------------------------------------------------

struct SplitJob {
  const float* src;  // (B, S, H, D) with element strides (sb, ss, sh), head dim contiguous
  float* dst;        // (2, B·H, S, D), or (2, B·H, D, S_pad) transposed
  long long sb, ss, sh;
  int S, S_pad, transposed;
};

constexpr int MAX_JOBS = 7;

struct SplitArgs {
  SplitJob job[MAX_JOBS];
  int H, D;
};

// One CTA per (32 rows, b·h, job), 256 threads; it walks the head dim in
// 32-column steps. Natural: each warp reads and writes 128-byte rows.
// Transposed: through a 32 × 33 tile, keys permuted within groups of 8.
__global__ void __launch_bounds__(256) flash_f32_split_kernel(const __grid_constant__ SplitArgs a) {
  __shared__ float tile[32][33];
  const SplitJob& jb = a.job[blockIdx.z];
  const int s0 = blockIdx.x * 32;
  if (s0 >= (jb.transposed ? jb.S_pad : jb.S)) return;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const float* src = jb.src + b * jb.sb + h * jb.sh;
  const long long per_bh = static_cast<long long>(jb.transposed ? jb.S_pad : jb.S) * a.D;
  const long long plane = per_bh * gridDim.y;
  float* dst = jb.dst + bh * per_bh;
  for (int d0 = 0; d0 < a.D; d0 += 32) {
    if (!jb.transposed) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + ty + 8 * i;
        if (s < jb.S) {
          uint32_t hi, lo;
          tf32_split(src[s * jb.ss + d0 + tx], hi, lo);
          const long long at = static_cast<long long>(s) * a.D + d0 + tx;
          dst[at] = __uint_as_float(hi);
          dst[plane + at] = __uint_as_float(lo);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + ty + 8 * i;
        tile[ty + 8 * i][tx] = s < jb.S ? src[s * jb.ss + d0 + tx] : 0.f;
      }
      __syncthreads();
      const int c = tx & 7, key = (tx & ~7) + (c < 4 ? 2 * c : 2 * c - 7);  // position c holds key 2c or 2c − 7
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = ty + 8 * i;
        uint32_t hi, lo;
        tf32_split(tile[key][d], hi, lo);
        const long long at = static_cast<long long>(d0 + d) * jb.S_pad + s0 + tx;
        dst[at] = __uint_as_float(hi);
        dst[plane + at] = __uint_as_float(lo);
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// The 4-D fp32 map (32-column boxes of 64 rows, both planes) of a split
// buffer: natural (2, BH, rows, D) with inner = D, or transposed
// (2, BH, D, S_pad) with inner = S_pad and rows = D.
int map_split(CUtensorMap* map, const void* buf, int inner, int rows, int BH) {
  const long long dims[4] = {inner, rows, BH, 2};
  const long long strides[3] = {4LL * inner, 4LL * inner * rows, 4LL * inner * rows * BH};
  const int box[4] = {32, 64, 1, 2};
  return make_map(map, buf, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

int pad64(int s) { return (s + 63) / 64 * 64; }

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

Args make_args(float* out0, float* out1, float* lse, const float* dd, const long long* os, int H, int Sq, int rows,
               int n_tiles, int row_live, int col_live, float mult0, float mult1, float scale) {
  Args a;
  a.out0 = out0, a.out1 = out1, a.lse = lse, a.dd = dd;
  a.o0_b = os[0], a.o0_s = os[1], a.o0_h = os[2], a.o1_b = os[3], a.o1_s = os[4], a.o1_h = os[5];
  a.H = H, a.Sq = Sq, a.rows = rows, a.n_tiles = n_tiles, a.row_live = row_live, a.col_live = col_live;
  a.mult0 = mult0, a.mult1 = mult1, a.scale_log2 = scale * LOG2E_F;
  return a;
}

template <int D>
int launch_fwd(const void* qs, const void* ks, const void* vt, float* o, float* lse, int B, int H, int Sq, int Skv,
               int kv_end, const long long* os, float scale, cudaStream_t stream) {
  using C = Cfg<D, FWD>;
  CUtensorMap tq, tk, tvt;
  int e = map_split(&tq, qs, D, Sq, B * H);
  if (e == 0) e = map_split(&tk, ks, D, Skv, B * H);
  if (e == 0) e = map_split(&tvt, vt, pad64(Skv), D, B * H);
  if (e != 0) return e;
  cudaError_t err = set_smem(flash_fwd_f32_kernel<D>, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a = make_args(o, nullptr, lse, nullptr, os, H, Sq, Sq, (kv_end + 63) / 64, Sq, kv_end, 1.f, 1.f, scale);
  const dim3 grid((Sq + 64 * C::R - 1) / (64 * C::R), B * H);
  flash_fwd_f32_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tvt, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* qs, const void* ks, const void* vs, const void* dos, const void* kt, const float* lse,
              const float* dd, float* dq, int B, int H, int Sq, int Skv, int kv_end, const long long* os, float scale,
              cudaStream_t stream) {
  using C = Cfg<D, DQ>;
  CUtensorMap tq, tk, tdo, tv, tkt;
  int e = map_split(&tq, qs, D, Sq, B * H);
  if (e == 0) e = map_split(&tk, ks, D, Skv, B * H);
  if (e == 0) e = map_split(&tdo, dos, D, Sq, B * H);
  if (e == 0) e = map_split(&tv, vs, D, Skv, B * H);
  if (e == 0) e = map_split(&tkt, kt, pad64(Skv), D, B * H);
  if (e != 0) return e;
  cudaError_t err = set_smem(flash_bwd_f32_dq_kernel<D>, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long o6[6] = {os[0], os[1], os[2], 0, 0, 0};
  const Args a = make_args(dq, nullptr, const_cast<float*>(lse), dd, o6, H, Sq, Sq, (kv_end + 63) / 64, Sq, kv_end,
                           scale, 1.f, scale);
  const dim3 grid((Sq + 64 * C::R - 1) / (64 * C::R), B * H);
  flash_bwd_f32_dq_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tdo, tv, tkt, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MODE>
int launch_dkv_mode(const CUtensorMap& tk, const CUtensorMap& tq, const CUtensorMap& tv, const CUtensorMap& tdo,
                    const CUtensorMap& tdot, const CUtensorMap& tqt, const Args& a, int BH, int Skv,
                    cudaStream_t stream) {
  using C = Cfg<D, MODE>;
  cudaError_t err = set_smem(flash_bwd_f32_dkv_kernel<D, MODE>, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Skv + 64 * C::R - 1) / (64 * C::R), BH);
  flash_bwd_f32_dkv_kernel<D, MODE><<<grid, C::THREADS, C::SMEM, stream>>>(tk, tq, tv, tdo, tdot, tqt, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* qs, const void* ks, const void* vs, const void* dos, const void* qt, const void* dot,
               const float* lse, const float* dd, float* dk, float* dv, int B, int H, int Sq, int Skv, int kv_end,
               const long long* os, float scale, cudaStream_t stream) {
  CUtensorMap tk, tq, tv, tdo, tdot, tqt;
  int e = map_split(&tk, ks, D, Skv, B * H);
  if (e == 0) e = map_split(&tq, qs, D, Sq, B * H);
  if (e == 0) e = map_split(&tv, vs, D, Skv, B * H);
  if (e == 0) e = map_split(&tdo, dos, D, Sq, B * H);
  if (e == 0) e = map_split(&tdot, dot, pad64(Sq), D, B * H);
  if (e == 0) e = map_split(&tqt, qt, pad64(Sq), D, B * H);
  if (e != 0) return e;
  const int n_tiles = (Sq + 63) / 64;
  float* l = const_cast<float*>(lse);
  if constexpr (D == 64) {  // dV and dK in one pass; os: dk (b, s, h), dv (b, s, h)
    const long long o6[6] = {os[3], os[4], os[5], os[0], os[1], os[2]};
    const Args a = make_args(dv, dk, l, dd, o6, H, Sq, Skv, n_tiles, kv_end, Sq, 1.f, scale, scale);
    return launch_dkv_mode<D, DKV>(tk, tq, tv, tdo, tdot, tqt, a, B * H, Skv, stream);
  } else {  // dV, then dK: one 64 × D/2 accumulator per consumer each
    const long long ov[6] = {os[3], os[4], os[5], 0, 0, 0}, ok[6] = {os[0], os[1], os[2], 0, 0, 0};
    e = launch_dkv_mode<D, DV>(tk, tq, tv, tdo, tdot, tqt,
                               make_args(dv, nullptr, l, dd, ov, H, Sq, Skv, n_tiles, kv_end, Sq, 1.f, 1.f, scale),
                               B * H, Skv, stream);
    if (e != 0) return e;
    return launch_dkv_mode<D, DK>(tk, tq, tv, tdo, tdot, tqt,
                                  make_args(dk, nullptr, l, dd, ok, H, Sq, Skv, n_tiles, kv_end, Sq, scale, 1.f, scale),
                                  B * H, Skv, stream);
  }
}

}  // namespace

extern "C" {

// jobs: njobs (<= 7) × 7 values: src, dst (pointers), the (b, s, h) element
// strides of src, its S, and 1 for the transposed layout. src is (B, S, H, D)
// fp32 with a contiguous head dim; dst is (2, B·H, S, D) natural or
// (2, B·H, D, S_pad) transposed, S_pad = S rounded up to 64, fp32
// contiguous: tf32 hi in plane 0, lo in plane 1.
int flash_f32_split(const long long* jobs, int njobs, int B, int H, int D, void* stream) {
  if (njobs < 1 || njobs > MAX_JOBS || D % 32) return static_cast<int>(cudaErrorInvalidValue);
  SplitArgs a = {};
  a.H = H, a.D = D;
  int blocks = 0;
  for (int i = 0; i < njobs; ++i) {
    const long long* v = jobs + 7 * i;
    SplitJob& jb = a.job[i];
    jb.src = reinterpret_cast<const float*>(v[0]);
    jb.dst = reinterpret_cast<float*>(v[1]);
    jb.sb = v[2], jb.ss = v[3], jb.sh = v[4];
    jb.S = static_cast<int>(v[5]), jb.S_pad = pad64(jb.S), jb.transposed = static_cast<int>(v[6]);
    const int n = ((jb.transposed ? jb.S_pad : jb.S) + 31) / 32;
    blocks = n > blocks ? n : blocks;
  }
  flash_f32_split_kernel<<<dim3(blocks, B * H, njobs), 256, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// qs, ks: natural splits of q (B, Sq, H, D) and k (B, Skv, H, D); vt: the
// transposed split of v; o: (B, Sq, H, D) fp32 with element strides
// (o_b, o_s, o_h); D in {64, 128, 256, 384, 512}; keys [kv_end, Skv) are
// excluded. lse: null, or (B, H, Sq) fp32 contiguous, which receives each
// row's natural-log log-sum-exp.
int flash_fwd_f32(const void* qs, const void* ks, const void* vt, void* o, void* lse, int B, int H, int Sq, int Skv,
                  int kv_end, int D, int o_b, int o_s, int o_h, float scale, void* stream) {
  const long long os[6] = {o_b, o_s, o_h, 0, 0, 0};
  float* oo = static_cast<float*>(o);
  float* ll = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_fwd<64>(qs, ks, vt, oo, ll, B, H, Sq, Skv, kv_end, os, scale, s);
    case 128: return launch_fwd<128>(qs, ks, vt, oo, ll, B, H, Sq, Skv, kv_end, os, scale, s);
    case 256: return launch_fwd<256>(qs, ks, vt, oo, ll, B, H, Sq, Skv, kv_end, os, scale, s);
    case 384: return launch_fwd<384>(qs, ks, vt, oo, ll, B, H, Sq, Skv, kv_end, os, scale, s);
    case 512: return launch_fwd<512>(qs, ks, vt, oo, ll, B, H, Sq, Skv, kv_end, os, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward passes on the forward's lse and dd = rowsum(dO ∘ O), both
// (B, H, Sq) fp32 contiguous. qs, ks, vs, dos: natural splits of q, k, v,
// dO; qt, dot: transposed splits of q and dO; kt: of k. dk, dv: (B, Skv, H,
// D) and dq: (B, Sq, H, D) fp32; out_strides: (b, s, h) in elements of dk
// then dv, or of dq. Keys [kv_end, Skv) get zero dk and dv.
int flash_bwd_f32_dkv(const void* qs, const void* ks, const void* vs, const void* dos, const void* qt,
                      const void* dot, const void* lse, const void* dd, void* dk, void* dv, int B, int H, int Sq,
                      int Skv, int kv_end, int D, const long long* out_strides, float scale, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dd);
  float* k = static_cast<float*>(dk);
  float* v = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_dkv<64>(qs, ks, vs, dos, qt, dot, l, d, k, v, B, H, Sq, Skv, kv_end, out_strides, scale, s);
    case 128:
      return launch_dkv<128>(qs, ks, vs, dos, qt, dot, l, d, k, v, B, H, Sq, Skv, kv_end, out_strides, scale, s);
    case 256:
      return launch_dkv<256>(qs, ks, vs, dos, qt, dot, l, d, k, v, B, H, Sq, Skv, kv_end, out_strides, scale, s);
    case 384:
      return launch_dkv<384>(qs, ks, vs, dos, qt, dot, l, d, k, v, B, H, Sq, Skv, kv_end, out_strides, scale, s);
    case 512:
      return launch_dkv<512>(qs, ks, vs, dos, qt, dot, l, d, k, v, B, H, Sq, Skv, kv_end, out_strides, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_bwd_f32_dq(const void* qs, const void* ks, const void* vs, const void* dos, const void* kt, const void* lse,
                     const void* dd, void* dq, int B, int H, int Sq, int Skv, int kv_end, int D,
                     const long long* out_strides, float scale, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dd);
  float* q = static_cast<float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_dq<64>(qs, ks, vs, dos, kt, l, d, q, B, H, Sq, Skv, kv_end, out_strides, scale, s);
    case 128: return launch_dq<128>(qs, ks, vs, dos, kt, l, d, q, B, H, Sq, Skv, kv_end, out_strides, scale, s);
    case 256: return launch_dq<256>(qs, ks, vs, dos, kt, l, d, q, B, H, Sq, Skv, kv_end, out_strides, scale, s);
    case 384: return launch_dq<384>(qs, ks, vs, dos, kt, l, d, q, B, H, Sq, Skv, kv_end, out_strides, scale, s);
    case 512: return launch_dq<512>(qs, ks, vs, dos, kt, l, d, q, B, H, Sq, Skv, kv_end, out_strides, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
