// Flash-attention forward for Hopper (sm_90a): non-causal softmax(q·kᵀ·scale)·v
// over bf16 tensors in (B, S, H, D) layout, fp32 online-softmax statistics and
// fp32 accumulation, key columns >= kv_end excluded.
//
// Two kernels, one per TPU kernel they replace:
//
//   flash_fwd_d64   replaces faceposegenerator_tpu/ops/flash_attention.py
//                   `_fwd_kernel_packed` (and its scheduling variant
//                   `_fwd_kernel_packed_split`): every UNet attention, D = 64.
//   flash_fwd_wide  replaces `_fwd_kernel` in the same file: D % 128 == 0, on
//                   the main path the VAE mid-block attention (one head, D = 512).
//
// What bounds them on the card. At the UNet's 4096-token self-attention and
// at the VAE's 4096×4096×512 the work is 4·Sq·Skv·D tensor-core FLOPs per head
// against (Sq + 2·Skv + Sq)·D·2 bytes, far above the card's ~295 FLOP/byte
// ridge: they are bound by the tensor cores and, at D = 64, by the exp of
// every score on the special-function units (MUFU), which costs about as
// much: at 80 heads × 4096² that is 1.34 G ex2, ~0.33 ms of MUFU time against
// a 0.35 ms tensor-core bound. The 77-token cross-attention reads q and
// writes o once for few FLOPs: it is bound by bytes, and the small levels
// (64 and 256 query tokens) by launches.
//
// What the D = 64 design (flash_fwd_d64, sm90_common.cuh) does about it:
//   * wgmma on 64-row warpgroup tiles: S = Q·Kᵀ as m64n128k16 with Q and K
//     read by the tensor cores straight from shared memory, once per
//     warpgroup (not once per warp, as ldmatrix + mma.sync did), and P·V as
//     m64n64k16 with P from registers (the S accumulator re-packed to bf16 in
//     place) and V read MN-major, so the score matrix never leaves registers.
//   * TMA: one producer thread loads Q once and streams the K and V tiles
//     through a ring of shared-memory stages guarded by mbarriers; the 4-D
//     tensor maps take the strided q/k/v views of the fused projection with
//     no copy, zero-fill the ragged last tile and never cross into the next
//     batch row or head. The producer warpgroup gives its registers to the
//     consumers (setmaxnreg 40 / 232 or 24 / 160), so nothing spills.
//   * The exps run under the tensor cores twice over: inside a warpgroup,
//     the softmax of S_j runs while P_{j-1}·V_{j-1} is in flight; across the
//     consumer warpgroups (two or three), named barriers make them issue their
//     products in turn (ping-pong, FlashAttention-3, arXiv:2407.08608), so
//     one's exps run under the others' products.
//   * exp is exp2 of a score pre-multiplied by scale·log2(e): one FMA and one
//     MUFU op per score; the statistics stay in raw-score units.
//   * Loop bounds stop at kv_end, so masked tiles are never loaded; in the
//     tile that holds kv_end the columns past it are masked to -inf.
//   * The TPU kernel's head-pair lane packing and ones-column MXU row sum are
//     not carried over: a wgmma takes 16-deep slices, so D = 64 is native
//     and an odd head count needs no zero head.
// The D % 128 design (flash_fwd_wide) keeps mma.sync: a 64×512 fp32 O tile
// does not fit in registers, so it uses 32-row Q and K/V tiles in shared
// memory (~105 KB of dynamic shared memory), splits the O accumulator by
// D-columns over 8 warps (64 fp32 registers per thread) and passes scores
// through a 32×32 tile in shared memory.
// For training both kernels also write each row's log-sum-exp (natural log,
// scaled logits; `save_lse` in the JAX package) when given a buffer for it:
// one fp32 per query row, from the statistics they keep anyway. flash_bwd.cu
// recomputes the normalised p from it.
//
// Plain C interface, loaded with ctypes. Every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

struct Strides {
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

// ---------------------------------------------------------------------------
// D = 64 (K1): one CTA per (b·h, 64·NC query rows), NC + 1 warpgroups.
//   warpgroup NC, the producer: one thread issues the TMA loads, Q once and
//     then the 128-key K and V tiles into a ring of two stages, each tile
//     behind its own full/empty mbarrier pair (K may be refilled as soon as
//     S is computed, V only after P·V);
//   warpgroups 0..NC-1, the consumers: 64 query rows each. Iteration j issues
//     S_j = Q·K_jᵀ (wgmma m64n128k16, A and B from shared memory) and
//     P_{j-1}·V_{j-1} (m64n64k16, A = P from registers, B = V MN-major), then
//     runs the softmax of S_j while P_{j-1}·V_{j-1} is on the tensor cores.
//     The consumers take turns to issue their products (named barriers
//     1..NC), so one's exps run under the others' products.
// NC = 3 from 1024 query tokens up: each K/V tile fetched from L2 then serves
// 192 query rows instead of 128 (PERF.md, PR 5, times the two side by
// side); below, NC = 2, whose 128-row tiles leave less of a CTA idle (at 256
// tokens, 192-row tiles make one full and one third-full CTA per head).
// ---------------------------------------------------------------------------

template <int NC>
struct D64 {
  static constexpr int BM = 64 * NC, BN = 128, STAGES = 2, THREADS = 128 * (NC + 1);
  // registers a thread: the producer gives back what the consumers take;
  // the launch starts every thread at 65536 / THREADS (168 or 128), so the
  // consumers' count is at least that
  static constexpr int PRODUCER_REGS = NC == 2 ? 40 : 24, CONSUMER_REGS = NC == 2 ? 232 : 160;
  static_assert(128 * (PRODUCER_REGS + NC * CONSUMER_REGS) <= 65536, "register file");
  static constexpr int Q_BYTES = BM * 64 * 2, KV_BYTES = BN * 64 * 2;
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // tiles, 1 + 4·STAGES mbarriers, and room to align the base to 1024 bytes
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;
};

template <int NC>
__global__ void __launch_bounds__(D64<NC>::THREADS, 1)
    flash_fwd_d64_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                         float* __restrict__ lse, int H, int Sq, int kv_end, long long o_b, long long o_s,
                         long long o_h, float scale_log2) {
  using C = D64<NC>;
  constexpr int BM = C::BM, BN = C::BN, ST = C::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_d64[];
  const uint32_t base = (smem_u32(smem_d64) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK0 = base + C::Q_BYTES, sV0 = sK0 + ST * C::KV_BYTES;
  // mbarriers: Q full, then per stage K full, V full, K empty, V empty
  const uint32_t full_q = base + C::BAR_OFF, full_k0 = full_q + 8, full_v0 = full_k0 + 8 * ST;
  const uint32_t empty_k0 = full_v0 + 8 * ST, empty_v0 = empty_k0 + 8 * ST;

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;
  const int n_tiles = (kv_end + BN - 1) / BN;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k0 + 8 * s, 1);
      mbar_init(full_v0 + 8 * s, 1);
      mbar_init(empty_k0 + 8 * s, 4 * NC);  // one arrival per consumer warp
      mbar_init(empty_v0 + 8 * s, 4 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {  // producer
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 128 * NC) {
      mbar_arrive_expect_tx(full_q, C::Q_BYTES);
      tma_load_4d(sQ, &tm_q, full_q, 0, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        const uint32_t ph = (j / ST) & 1;
        mbar_wait(empty_k0 + 8 * s, ph ^ 1);
        mbar_arrive_expect_tx(full_k0 + 8 * s, C::KV_BYTES);
        tma_load_4d(sK0 + s * C::KV_BYTES, &tm_k, full_k0 + 8 * s, 0, j * BN, h, b);
        mbar_wait(empty_v0 + 8 * s, ph ^ 1);
        mbar_arrive_expect_tx(full_v0 + 8 * s, C::KV_BYTES);
        tma_load_4d(sV0 + s * C::KV_BYTES, &tm_v, full_v0 + 8 * s, 0, j * BN, h, b);
      }
    }
  } else {  // consumers
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t sQw = sQ + wg * 64 * 128;  // this warpgroup's 64 query rows
    float s_acc[BN / 2], o_acc[32];
    uint32_t pa[BN / 4];
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
    fence_regs(o_acc);  // zeroed here, not later next to a wgmma in flight
    float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.f, l1 = 0.f, al0 = 1.f, al1 = 1.f;

    // S_j = Q·K_jᵀ
    auto issue_s = [&](int j) {
      const uint32_t sK = sK0 + (j % ST) * C::KV_BYTES;
      fence_regs(s_acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_ss_m64n128(s_acc, desc_k(sQw + 32 * k), desc_k(sK + 32 * k), k);
      wgmma_commit();
    };
    // P_j (in s_acc) → bf16 A fragments; O rescaled to the running max
    auto pack_p = [&]() {
      pack_a<BN / 16>(pa, s_acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o_acc[4 * i + 0] *= al0;
        o_acc[4 * i + 1] *= al0;
        o_acc[4 * i + 2] *= al1;
        o_acc[4 * i + 3] *= al1;
      }
    };
    // O += P_j·V_j, once V_j has arrived
    auto issue_pv = [&](int j) {
      const int s = j % ST;
      mbar_wait(full_v0 + 8 * s, (j / ST) & 1);
      const uint32_t sV = sV0 + s * C::KV_BYTES;
      fence_regs(o_acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
        wgmma_rs_m64n64_mn(o_acc, pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2], pa[4 * kc + 3],
                           desc_mn(sV + 2048 * kc));
      wgmma_commit();
    };
    // online softmax of S_j: statistics stay in raw-score units (scale > 0
    // commutes with max); the scale and the max shift fold into one FMA in
    // front of each ex2. Only the tile that holds kv_end needs masking.
    auto softmax = [&](int j) {
      const int kv0 = j * BN;
      if (kv0 + BN > kv_end) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (kv0 + i * 8 + t4 * 2 + e >= kv_end) s_acc[4 * i + e] = s_acc[4 * i + 2 + e] = neg_inf();
      }
      float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(s_acc[4 * i], s_acc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s_acc[4 * i + 2], s_acc[4 * i + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float base0 = (mn0 == neg_inf() ? 0.f : mn0) * scale_log2;
      const float base1 = (mn1 == neg_inf() ? 0.f : mn1) * scale_log2;
      al0 = ex2(fmaf(m0, scale_log2, -base0));
      al1 = ex2(fmaf(m1, scale_log2, -base1));
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        s_acc[4 * i + 0] = ex2(fmaf(s_acc[4 * i + 0], scale_log2, -base0));
        s_acc[4 * i + 1] = ex2(fmaf(s_acc[4 * i + 1], scale_log2, -base0));
        s_acc[4 * i + 2] = ex2(fmaf(s_acc[4 * i + 2], scale_log2, -base1));
        s_acc[4 * i + 3] = ex2(fmaf(s_acc[4 * i + 3], scale_log2, -base1));
        rs0 += s_acc[4 * i + 0] + s_acc[4 * i + 1];
        rs1 += s_acc[4 * i + 2] + s_acc[4 * i + 3];
      }
      l0 = l0 * al0 + rs0;  // per-thread partial row sums; summed over the quad at the end
      l1 = l1 * al1 + rs1;
    };

    // Ping-pong: warpgroup w issues its products between bar.sync on
    // barrier 1 + w and bar.arrive on the next one's barrier, in turn;
    // warpgroup 0 goes first. Each warpgroup syncs n_tiles + 1 times and is
    // arrived for as often (the last skips its arrival after its last
    // products).
    const int next_bar = 1 + (wg + 1) % NC;
    if (wg == NC - 1) named_bar_arrive(1, 256);
    mbar_wait(full_q, 0);
    mbar_wait(full_k0, 0);
    named_bar_sync(1 + wg, 256);
    issue_s(0);
    named_bar_arrive(next_bar, 256);
    wgmma_wait<0>();
    fence_regs(s_acc);
    mbar_arrive_if(empty_k0, lane == 0);
    softmax(0);
    // iteration j: S_j and P_{j-1}·V_{j-1} on the tensor cores, then the
    // softmax of S_j while P_{j-1}·V_{j-1} runs
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % ST;
      pack_p();
      mbar_wait(full_k0 + 8 * s, (j / ST) & 1);
      named_bar_sync(1 + wg, 256);
      issue_s(j);
      issue_pv(j - 1);
      named_bar_arrive(next_bar, 256);
      wgmma_wait<1>();
      fence_regs(s_acc);
      mbar_arrive_if(empty_k0 + 8 * s, lane == 0);
      softmax(j);
      wgmma_wait<0>();
      fence_regs(o_acc);
      fence_regs(pa);
      mbar_arrive_if(empty_v0 + 8 * ((j - 1) % ST), lane == 0);
    }
    pack_p();
    named_bar_sync(1 + wg, 256);
    issue_pv(n_tiles - 1);
    if (wg != NC - 1) named_bar_arrive(next_bar, 256);
    wgmma_wait<0>();
    fence_regs(o_acc);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int row0 = q0 + wg * 64 + w * 16 + g, row1 = row0 + 8;
    bf16* ob = o + b * o_b + h * o_h;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = i * 8 + t4 * 2;
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + row0 * o_s + col) = pack_bf16(o_acc[4 * i] * inv0, o_acc[4 * i + 1] * inv0);
      if (row1 < Sq)
        *reinterpret_cast<uint32_t*>(ob + row1 * o_s + col) =
            pack_bf16(o_acc[4 * i + 2] * inv1, o_acc[4 * i + 3] * inv1);
    }
    // natural-log LSE of the scaled logits: the running max is in raw-score
    // units and the sum in the log2 domain of the ex2 above
    if (lse != nullptr && t4 == 0) {
      float* lb = lse + static_cast<long long>(blockIdx.y) * Sq;
      if (row0 < Sq) lb[row0] = (m0 * scale_log2 + log2f(l0)) * LN2;
      if (row1 < Sq) lb[row1] = (m1 * scale_log2 + log2f(l1)) * LN2;
    }
  }
}

// ---------------------------------------------------------------------------
// D % 128 == 0 (D <= 512): one CTA per (b·h, 32-row Q tile), 8 warps.
//   scores: warp w computes the 16×8 score tile (w & 1, w >> 1) over all D;
//   softmax: 8 threads per row over the 32×32 score tile in shared memory;
//   P·V: warp w owns output columns [w·D/8, (w+1)·D/8) for all 32 rows.
// ---------------------------------------------------------------------------

template <int D>
struct WideSmem {
  static constexpr int BM = 32, BN = 32, SST = D + 8, SFS = BN + 1, PST = BN + 8;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + BM * SST * sizeof(bf16);
  static constexpr size_t v_off = k_off + BN * SST * sizeof(bf16);
  static constexpr size_t s_off = v_off + BN * SST * sizeof(bf16);
  static constexpr size_t p_off = s_off + BM * SFS * sizeof(float);
  static constexpr size_t stat_off = p_off + BM * PST * sizeof(bf16);
  static constexpr size_t bytes = stat_off + 3 * BM * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(256)
    flash_fwd_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int H, int Sq, int kv_end, Strides st,
                          float scale_log2) {
  using L = WideSmem<D>;
  constexpr int BM = L::BM, BN = L::BN, SST = L::SST, SFS = L::SFS, PST = L::PST, NT = 256;
  constexpr int DW = D / 8;    // output columns per warp
  constexpr int NDT = DW / 8;  // 8-column MMA tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p_off);
  float* sM = reinterpret_cast<float*>(smem + L::stat_off);
  float* sL = sM + BM;
  float* sAlpha = sL + BM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;
  const bf16* qb = q + b * st.q_b + h * st.q_h;
  const bf16* kb = k + b * st.k_b + h * st.k_h;
  const bf16* vb = v + b * st.v_b + h * st.v_h;
  bf16* ob = o + b * st.o_b + h * st.o_h;

  if (tid < BM) {
    sM[tid] = neg_inf();
    sL[tid] = 0.f;
  }
  load_tile<BM, D, SST, NT>(sQ, qb, st.q_s, q0, Sq);

  float acc[2][NDT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < NDT; ++i) acc[mt][i][0] = acc[mt][i][1] = acc[mt][i][2] = acc[mt][i][3] = 0.f;

  const int smt = warp & 1, snt = warp >> 1;  // this warp's score tile
  const int srow = smt * 16 + g;
  const int srow_ = threadIdx.x >> 3, spart = threadIdx.x & 7;  // softmax: row, 4-col part

  for (int kv0 = 0; kv0 < kv_end; kv0 += BN) {
    __syncthreads();  // previous tile's K/V/P fully consumed
    load_tile<BN, D, SST, NT>(sK, kb, st.k_s, kv0, kv_end);
    load_tile<BN, D, SST, NT>(sV, vb, st.v_s, kv0, kv_end);
    __syncthreads();

    // scores: two accumulators over alternating k-chunks for ILP
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int kc = 0; kc < D / 16; kc += 2) {
      uint32_t a[4];
      const bf16* pa = sQ + srow * SST + kc * 16 + t4 * 2;
      const bf16* pb = sK + (snt * 8 + g) * SST + kc * 16 + t4 * 2;
      a[0] = ld_pair(pa);
      a[1] = ld_pair(pa + 8 * SST);
      a[2] = ld_pair(pa + 8);
      a[3] = ld_pair(pa + 8 * SST + 8);
      mma_16816(s0, a, ld_pair(pb), ld_pair(pb + 8));
      a[0] = ld_pair(pa + 16);
      a[1] = ld_pair(pa + 8 * SST + 16);
      a[2] = ld_pair(pa + 24);
      a[3] = ld_pair(pa + 8 * SST + 24);
      mma_16816(s1, a, ld_pair(pb + 16), ld_pair(pb + 24));
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = snt * 8 + t4 * 2 + e;
      const bool live = kv0 + col < kv_end;
      sS[srow * SFS + col] = live ? (s0[e] + s1[e]) * scale_log2 : neg_inf();
      sS[(srow + 8) * SFS + col] = live ? (s0[2 + e] + s1[2 + e]) * scale_log2 : neg_inf();
    }
    __syncthreads();

    // online softmax over the 32×32 tile: 8 threads per row, 4 columns each
    {
      const float m_old = sM[srow_];
      float x[4];
      float mx = neg_inf();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = sS[srow_ * SFS + spart * 4 + i];
        mx = fmaxf(mx, x[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m_old, mx);
      const float base = mn == neg_inf() ? 0.f : mn;
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(x[i] - base);
        rs += p;
        sP[srow_ * PST + spart * 4 + i] = __float2bfloat16_rn(p);
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      __syncwarp();
      if (spart == 0) {
        const float alpha = exp2f(m_old - base);
        sM[srow_] = mn;
        sL[srow_] = sL[srow_] * alpha + rs;
        sAlpha[srow_] = alpha;
      }
    }
    __syncthreads();

    // O[:, warp's columns] = alpha·O + P·V
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float al0 = sAlpha[mt * 16 + g], al1 = sAlpha[mt * 16 + g + 8];
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        acc[mt][dt][0] *= al0;
        acc[mt][dt][1] *= al0;
        acc[mt][dt][2] *= al1;
        acc[mt][dt][3] *= al1;
      }
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        uint32_t a[4];
        const bf16* pa = sP + (mt * 16 + g) * PST + kc * 16 + t4 * 2;
        a[0] = ld_pair(pa);
        a[1] = ld_pair(pa + 8 * PST);
        a[2] = ld_pair(pa + 8);
        a[3] = ld_pair(pa + 8 * PST + 8);
#pragma unroll
        for (int dt = 0; dt < NDT; ++dt) {
          const bf16* pv = sV + (kc * 16 + t4 * 2) * SST + warp * DW + dt * 8 + g;
          mma_16816(acc[mt][dt], a, ld_strided_pair(pv, SST), ld_strided_pair(pv + 8 * SST, SST));
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int lr0 = mt * 16 + g, lr1 = lr0 + 8;
    const float inv0 = 1.f / sL[lr0], inv1 = 1.f / sL[lr1];
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      const int col = warp * DW + dt * 8 + t4 * 2;
      if (q0 + lr0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (q0 + lr0) * st.o_s + col) =
            pack_bf16(acc[mt][dt][0] * inv0, acc[mt][dt][1] * inv0);
      if (q0 + lr1 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (q0 + lr1) * st.o_s + col) =
            pack_bf16(acc[mt][dt][2] * inv1, acc[mt][dt][3] * inv1);
    }
  }
  // statistics are in the log2 domain of the scaled logits
  if (lse != nullptr && tid < BM && q0 + tid < Sq)
    lse[static_cast<long long>(blockIdx.y) * Sq + q0 + tid] = (sM[tid] + log2f(sL[tid])) * LN2;
}

template <int D>
cudaError_t launch_wide(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B, int H,
                        int Sq, int kv_end, const Strides& st, float scale_log2,
                        cudaStream_t stream) {
  const size_t bytes = WideSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wide_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + WideSmem<D>::BM - 1) / WideSmem<D>::BM, B * H);
  flash_fwd_wide_kernel<D><<<grid, 256, bytes, stream>>>(q, k, v, o, lse, H, Sq, kv_end, st,
                                                          scale_log2);
  return cudaGetLastError();
}

template <int NC>
int launch_d64(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Sq, int kv_end,
               int q_b, int q_s, int q_h, int k_b, int k_s, int k_h, int v_b, int v_s, int v_h, int o_b, int o_s,
               int o_h, float scale, cudaStream_t stream) {
  using C = D64<NC>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_d64_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  // keys at or past kv_end lie outside the K and V maps and read as zeros
  CUtensorMap tq, tk, tv;
  int err = make_map_d64(&tq, q, Sq, H, B, q_s, q_h, q_b, C::BM);
  if (err == 0) err = make_map_d64(&tk, k, kv_end, H, B, k_s, k_h, k_b, C::BN);
  if (err == 0) err = make_map_d64(&tv, v, kv_end, H, B, v_s, v_h, v_b, C::BN);
  if (err != 0) return err;
  dim3 grid((Sq + C::BM - 1) / C::BM, B * H);
  flash_fwd_d64_kernel<NC><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), H, Sq, kv_end, o_b, o_s, o_h, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

Strides make_strides(int q_b, int q_s, int q_h, int k_b, int k_s, int k_h, int v_b, int v_s,
                     int v_h, int o_b, int o_s, int o_h) {
  Strides st;
  st.q_b = q_b; st.q_s = q_s; st.q_h = q_h;
  st.k_b = k_b; st.k_s = k_s; st.k_h = k_h;
  st.v_b = v_b; st.v_s = v_s; st.v_h = v_h;
  st.o_b = o_b; st.o_s = o_s; st.o_h = o_h;
  return st;
}

}  // namespace

extern "C" {

// q: (B, Sq, H, 64), k/v: (B, Skv, H, 64), o: (B, Sq, H, 64), bf16; strides
// in elements, head dim contiguous; keys [kv_end, Skv) are excluded. lse:
// null, or (B, H, Sq) fp32 contiguous, which receives the natural-log
// log-sum-exp of each row's scaled logits (what the backward kernels read).
int flash_fwd_d64(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Sq,
                  int kv_end, int q_b, int q_s, int q_h, int k_b, int k_s, int k_h, int v_b,
                  int v_s, int v_h, int o_b, int o_s, int o_h, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq >= 1024)  // three consumer warpgroups (see the kernel's notes)
    return launch_d64<3>(q, k, v, o, lse, B, H, Sq, kv_end, q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s,
                         o_h, scale, s);
  return launch_d64<2>(q, k, v, o, lse, B, H, Sq, kv_end, q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s,
                       o_h, scale, s);
}

// The same contract for D in {128, 256, 384, 512}.
int flash_fwd_wide(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Sq,
                   int kv_end, int D, int q_b, int q_s, int q_h, int k_b, int k_s, int k_h,
                   int v_b, int v_s, int v_h, int o_b, int o_s, int o_h, float scale,
                   void* stream) {
  const Strides st = make_strides(q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h);
  const float sl2 = scale * LOG2E;
  float* ll = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  switch (D) {
    case 128: return static_cast<int>(launch_wide<128>(qq, kk, vv, oo, ll, B, H, Sq, kv_end, st, sl2, s));
    case 256: return static_cast<int>(launch_wide<256>(qq, kk, vv, oo, ll, B, H, Sq, kv_end, st, sl2, s));
    case 384: return static_cast<int>(launch_wide<384>(qq, kk, vv, oo, ll, B, H, Sq, kv_end, st, sl2, s));
    case 512: return static_cast<int>(launch_wide<512>(qq, kk, vv, oo, ll, B, H, Sq, kv_end, st, sl2, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
