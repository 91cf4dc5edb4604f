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
// The D % 128 design (flash_fwd_wide) is the same pipeline in the head-dim
// split of flash_f32.cu: see its section below.
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
// D % 128 == 0 (K2, D <= 512; on the main path the VAE's one 512-wide head).
//
// What bounds it. A 64 × 512 fp32 O tile is 256 registers a thread of one
// warpgroup: it does not fit. So, as flash_f32.cu does at D >= 128, a CTA
// of 384 threads takes one 64-row Q tile, and its two consumer warpgroups
// each own one half of the head dim:
//   * each computes its partial S = Q_half·K_halfᵀ (wgmma m64n64k16, A and B
//     from shared memory), the two swap partial sums through shared memory
//     (2 × 16 KB) and add them (mine + other's: the same bits in both), and
//     both run the same online softmax;
//   * each computes O_half += P·V_half with P from registers (the S
//     accumulator packed to bf16) and V read MN-major (bf16 has the
//     transpose flag: no pre-pass), m64n64k16 per 64 output columns, and
//     keeps its 64 × D/2 fp32 O half in registers (128 a thread at D = 512;
//     setmaxnreg 232 for the consumers, 40 for the producer warpgroup).
// TMA boxes are 64 rows × 64 columns, 128-byte swizzled (a 512-wide row is
// 8 boxes). Shared memory at D = 512: the Q tile, resident (64 KB), one K
// tile (64 KB), one V tile (64 KB) and the exchange (32 KB): 224 KB, one
// stage each. K and V have barriers and producer threads of their own, and
// iteration j issues P_j·V_j before S_{j+1} = Q·K_{j+1}ᵀ: V_j is released
// when its product is done and V_{j+1} loads under S_{j+1}, the exchange
// and the softmax; K_{j+1} is released when S_{j+1} is done and K_{j+2}
// loads under the softmax and P_{j+1}·V_{j+1}. (Streaming Q with K in
// 64-column chunks, as flash_f32.cu does, would deepen the ring but read Q
// from L2 once per key tile: 1.5× the L2 traffic of this layout, which at 64
// query rows a CTA already reads K and V 64 times a head, ~4.3 GB at 8 ×
// 4096² × 512.)
// Shared-memory bandwidth: S alone asks ~136 B/clk at the tensor-core rate
// (A and B from shared memory, m64n64k16), over the SM's 128; P·V, with A
// in registers, ~68. The two are issued back to back by both warpgroups, so
// the tensor cores interleave them and the average is ~102 B/clk.
// Kept from the mma.sync kernel this replaces, and from flash_f32.cu: the
// online softmax keeps the rounded base (sums relative to b = fl(m · scale ·
// log2 e), rescaled by exactly 2^(b_old − b_new)), P is rounded to bf16
// before P·V (as attention_plain rounds the weights), the LSE is in
// natural-log units.
// ---------------------------------------------------------------------------

template <int D>
struct Wide {
  static constexpr int NBOX = D / 64;           // 64-column boxes of a row tile
  static constexpr int HB = NBOX / 2;           // the boxes of one consumer's head-dim half
  static constexpr int TILE = 64 * D * 2;       // one 64-row bf16 tile of Q, K or V
  static constexpr int X_OFF = 3 * TILE;        // the partial-S exchange: 2 × 64 × 64 fp32
  static constexpr int BAR_OFF = X_OFF + 2 * 16384;
  static constexpr int SMEM = BAR_OFF + 8 * 5 + 1024;  // Q full; K full, empty; V full, empty; alignment
  static constexpr int THREADS = 384, PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  // the launch allocates 168 registers a thread (65536 / 384, rounded down
  // to 8); the consumers' setmaxnreg.inc takes what the producers' dec frees
  static_assert(128 * (PRODUCER_REGS + 2 * CONSUMER_REGS) <= THREADS * 168, "register file");
  static_assert(SMEM <= 232448, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(Wide<D>::THREADS, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                          float* __restrict__ lse, int H, int Sq, int kv_end, long long o_b, long long o_s,
                          long long o_h, float scale_log2) {
  using C = Wide<D>;
  constexpr int NCB = D / 128;  // a consumer's 64-column blocks of O
  constexpr int KS = D / 32;    // its k16 slices of S
  extern __shared__ __align__(1024) unsigned char smem_wide[];
  const uint32_t raw = smem_u32(smem_wide), base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + C::TILE, sV = base + 2 * C::TILE;
  const uint32_t full_q = base + C::BAR_OFF, full_k = full_q + 8, empty_k = full_q + 16, full_v = full_q + 24,
                 empty_v = full_q + 32;

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * 64;
  const int n_tiles = (kv_end + 63) / 64;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(full_k, 1);
    mbar_init(full_v, 1);
    mbar_init(empty_k, 8);  // one arrival per consumer warp
    mbar_init(empty_v, 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producers: thread 256 loads Q and the K tiles, thread 288 the V tiles
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(full_q, C::TILE);
      for (int c = 0; c < C::NBOX; ++c) tma_load_4d(sQ + c * 8192, &tm_q, full_q, 64 * c, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(empty_k, (j & 1) ^ 1);
        mbar_arrive_expect_tx(full_k, C::TILE);
        for (int c = 0; c < C::NBOX; ++c) tma_load_4d(sK + c * 8192, &tm_k, full_k, 64 * c, 64 * j, h, b);
      }
    } else if (threadIdx.x == 288) {
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(empty_v, (j & 1) ^ 1);
        mbar_arrive_expect_tx(full_v, C::TILE);
        for (int c = 0; c < C::NBOX; ++c) tma_load_4d(sV + c * 8192, &tm_v, full_v, 64 * c, 64 * j, h, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns head-dim columns [wg·D/2, (wg + 1)·D/2)
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, t4 = lane & 3, tid = threadIdx.x & 127;
  float* xbuf = reinterpret_cast<float*>(smem_wide + (base - raw) + C::X_OFF);
  float s_acc[32], o_acc[NCB][32];
  uint32_t pa[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) s_acc[i] = 0.f;
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[cb][i] = 0.f;
    fence_regs(o_acc[cb]);  // zeroed here, not later next to a wgmma in flight
  }
  // row statistics of rows 16w + lane/4 and + 8: the running max (raw score
  // units), its rounded base b = fl(m · scale · log2 e) and the sum relative
  // to it, and this tile's rescale 2^(b_old − b_new)
  float m0 = neg_inf(), m1 = neg_inf(), mb0 = 0.f, mb1 = 0.f, l0 = 0.f, l1 = 0.f, al0 = 1.f, al1 = 1.f;

  // S_j (this warpgroup's partial) = Q_half·K_halfᵀ
  auto issue_s = [&]() {
    fence_regs(s_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (wg * C::HB + kk / 4) * 8192 + 32 * (kk % 4);
      wgmma_ss_m64n64(s_acc, desc_k(opaque(sQ) + off), desc_k(opaque(sK) + off), kk > 0);
    }
    wgmma_commit();
  };
  // O_half += P_j·V_j[:, half]
  auto issue_pv = [&]() {
    fence_regs(pa);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) fence_regs(o_acc[cb]);
    wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs_m64n64_mn(o_acc[cb], pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2], pa[4 * kc + 3],
                           desc_mn(opaque(sV) + (wg * C::HB + cb) * 8192 + 2048 * kc));
    wgmma_commit();
  };
  // the full S_j: mine + the other half's, swapped through shared memory
  // (barrier 2 + wg: the other warpgroup has read my previous partials)
  auto exchange = [&](int j) {
    if (j > 0) named_bar_sync(2 + wg, 256);
#pragma unroll
    for (int i = 0; i < 32; ++i) xbuf[(wg * 32 + i) * 128 + tid] = s_acc[i];
    named_bar_sync(1, 256);
#pragma unroll
    for (int i = 0; i < 32; ++i) s_acc[i] += xbuf[((1 - wg) * 32 + i) * 128 + tid];
    if (j + 1 < n_tiles) named_bar_arrive(2 + (1 - wg), 256);
  };
  // online softmax of S_j in place; only the tile that holds kv_end needs masking
  auto softmax = [&](int j) {
    const int kv0 = 64 * j;
    if (kv0 + 64 > kv_end) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (kv0 + i * 8 + t4 * 2 + e >= kv_end) s_acc[4 * i + e] = s_acc[4 * i + 2 + e] = neg_inf();
    }
    float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
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
    al0 = m0 == neg_inf() ? 0.f : ex2(mb0 - base0);  // 1 exactly while the max holds
    al1 = m1 == neg_inf() ? 0.f : ex2(mb1 - base1);
    m0 = mn0, m1 = mn1, mb0 = base0, mb1 = base1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
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
  // O rescaled to the new base, P_j packed to bf16 A fragments, S's
  // registers zeroed (their values end here, not at the next wgmma)
  auto rescale_pack = [&]() {
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o_acc[cb][4 * i + 0] *= al0;
        o_acc[cb][4 * i + 1] *= al0;
        o_acc[cb][4 * i + 2] *= al1;
        o_acc[cb][4 * i + 3] *= al1;
      }
    pack_a<4>(pa, s_acc);
#pragma unroll
    for (int i = 0; i < 32; ++i) s_acc[i] = 0.f;
  };

  mbar_wait(full_q, 0);
  mbar_wait(full_k, 0);
  issue_s();
  wgmma_wait<0>();
  fence_regs(s_acc);
  mbar_arrive_if(empty_k, lane == 0);
  exchange(0);
  softmax(0);
  rescale_pack();
  // iteration j: P_j·V_j, then S_{j+1}, on the tensor cores; V_j released
  // when its product is done, K_{j+1} when S_{j+1} is; then the exchange and
  // softmax of S_{j+1}
  for (int j = 0; j + 1 < n_tiles; ++j) {
    mbar_wait(full_v, j & 1);
    issue_pv();
    mbar_wait(full_k, (j + 1) & 1);
    issue_s();
    wgmma_wait<1>();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) fence_regs(o_acc[cb]);
    fence_regs(pa);
    mbar_arrive_if(empty_v, lane == 0);
    wgmma_wait<0>();
    fence_regs(s_acc);
    mbar_arrive_if(empty_k, lane == 0);
    exchange(j + 1);
    softmax(j + 1);
    rescale_pack();
  }
  mbar_wait(full_v, (n_tiles - 1) & 1);
  issue_pv();
  wgmma_wait<0>();
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) fence_regs(o_acc[cb]);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + w * 16 + (lane >> 2), row1 = row0 + 8;
  bf16* ob = o + b * o_b + h * o_h + wg * (D / 2) + 2 * t4;
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 64 * cb + 8 * i;
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + row0 * o_s + col) =
            pack_bf16(o_acc[cb][4 * i] * inv0, o_acc[cb][4 * i + 1] * inv0);
      if (row1 < Sq)
        *reinterpret_cast<uint32_t*>(ob + row1 * o_s + col) =
            pack_bf16(o_acc[cb][4 * i + 2] * inv1, o_acc[cb][4 * i + 3] * inv1);
    }
  // natural-log LSE of the scaled logits: l sums 2^(s · scale · log2 e − b)
  if (lse != nullptr && wg == 0 && t4 == 0) {
    float* lb = lse + static_cast<long long>(blockIdx.y) * Sq;
    if (row0 < Sq) lb[row0] = (mb0 + log2f(l0)) * LN2;
    if (row1 < Sq) lb[row1] = (mb1 + log2f(l1)) * LN2;
  }
}

template <int D>
int launch_wide(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Sq, int kv_end,
                int q_b, int q_s, int q_h, int k_b, int k_s, int k_h, int v_b, int v_s, int v_h, int o_b, int o_s,
                int o_h, float scale, cudaStream_t stream) {
  using C = Wide<D>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_wide_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  // 4-D maps (D, S, H, B) with 64 × 64 boxes; rows past Sq, and keys at or
  // past kv_end, read as zeros
  CUtensorMap tq, tk, tv;
  const int box[4] = {64, 64, 1, 1};
  auto map = [&](CUtensorMap* m, const void* base, int S, int s_s, int s_h, int s_b) {
    const long long dims[4] = {D, S, H, B}, strides[3] = {2LL * s_s, 2LL * s_h, 2LL * s_b};
    return make_map(m, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  int err = map(&tq, q, Sq, q_s, q_h, q_b);
  if (err == 0) err = map(&tk, k, kv_end, k_s, k_h, k_b);
  if (err == 0) err = map(&tv, v, kv_end, v_s, v_h, v_b);
  if (err != 0) return err;
  dim3 grid((Sq + 63) / 64, B * H);
  flash_fwd_wide_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), H, Sq, kv_end, o_b, o_s, o_h, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return launch_wide<128>(q, k, v, o, lse, B, H, Sq, kv_end, q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h,
                                      o_b, o_s, o_h, scale, s);
    case 256: return launch_wide<256>(q, k, v, o, lse, B, H, Sq, kv_end, q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h,
                                      o_b, o_s, o_h, scale, s);
    case 384: return launch_wide<384>(q, k, v, o, lse, B, H, Sq, kv_end, q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h,
                                      o_b, o_s, o_h, scale, s);
    case 512: return launch_wide<512>(q, k, v, o, lse, B, H, Sq, kv_end, q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h,
                                      o_b, o_s, o_h, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
