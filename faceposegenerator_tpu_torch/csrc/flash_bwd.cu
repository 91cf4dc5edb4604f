// Flash-attention backward for Hopper (sm_90a): the gradients of
// o = softmax(q·kᵀ·scale)·v with respect to q, k and v, over bf16 tensors in
// (B, S, H, D) layout, from the forward's per-row log-sum-exp (flash_fwd.cu).
//
// Four entry points, two passes for each of the two TPU kernel pairs they
// replace (faceposegenerator_tpu/ops/flash_attention.py):
//
//   flash_bwd_d64_dkv   `_bwd_kernel_packed_dkv` (:711)  D = 64, every UNet
//   flash_bwd_d64_dq    `_bwd_kernel_packed_dq`  (:777)  attention's backward
//   flash_bwd_wide_dkv  `_bwd_kernel_plain_dkv`  (:542)  D % 128 == 0: the VAE
//   flash_bwd_wide_dq   `_bwd_kernel_plain_dq`   (:585)  mid attention (D = 512)
//
// The function, as in the JAX kernels (FlashAttention-2 eqs. 13-21):
//   p  = exp(scale·q·kᵀ − lse)           recomputed, already normalised
//   D  = rowsum(dO ∘ O)                  fp32, computed by the caller
//   dV = pᵀ·dO                           p rounded to bf16 first
//   dS = p ∘ (dO·vᵀ − D)                 rounded to bf16
//   dK = scale·dSᵀ·q,  dQ = scale·dS·k   fp32 accumulation, bf16 outputs
// Keys at positions >= kv_end get p = 0, so their dk and dv are 0.
//
// Structure: as on the TPU, separate passes own separate outputs, so every
// output tile is owned by one CTA and nothing needs atomics (the result is
// deterministic). The dK/dV pass gives each CTA a tile of key rows and walks
// the query tiles; the dQ pass gives each CTA a tile of query rows and walks
// the key tiles. Each pass recomputes the scores, so at D = 64 the five
// products S, dP, dV, dK, dQ cost 14·Sq·Skv·D FLOPs per head in all (S and
// dP are computed twice); at D % 128 == 0 the dK/dV pass is two launches (dV,
// then dK: see that section), 16·Sq·Skv·D.
//
// What bounds them on the card: at the 4096-token self-attention the work
// is ~10·Sq·Skv·D tensor-core FLOPs per head against ~(4·Sq + 4·Skv)·D·2
// bytes, far above the ~295 FLOP/byte ridge: tensor cores first, then the
// exp of every score on the special-function units (recomputed in each
// pass) and the chain that turns each score into the operand of the next
// product. The 77-key cross-attention backward moves q, dO and dq once for
// few FLOPs: bytes and launches bound.
//
// What the design does about it (sm90_common.cuh; both head-dim families):
// wgmma on 64-row warpgroup tiles, the tiles a CTA keeps for the whole pass
// resident in shared memory as the A operands of the score products, the
// streamed tiles arriving by TMA from a producer warpgroup behind mbarriers
// and read straight by the tensor cores (once per warpgroup, not four times
// per warp as with ldmatrix), p and dS re-packed in registers as the A
// operand of the gradient products with B read MN-major.
//   * D = 64: a CTA owns 128 rows (64 a consumer warpgroup), K and V (or Q
//     and dO) resident, a three-stage ring of streamed tiles; each consumer
//     issues the score products of the next streamed tile before it waits
//     for the gradient products of the last, so p and dS are computed while
//     the tensor cores run, and the two consumer warpgroups interleave.
//   * D % 128 == 0: a 64-row fp32 accumulator over all of D = 512 is 256
//     registers a thread of one warpgroup, so the two consumer warpgroups of
//     a CTA split the head dim, as K2 does (see the section below).
//
// Plain C interface, loaded with ctypes. Every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

struct BwdStrides {  // in elements; head dim contiguous
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s, do_h;
  long long dq_b, dq_s, dq_h, dk_b, dk_s, dk_h, dv_b, dv_s, dv_h;
};

// Zero rows [row0, min(row0 + ROWS, nrows)) of a (rows, D) bf16 slice.
template <int ROWS, int D, int NTHREADS>
__device__ __forceinline__ void zero_rows(bf16* dst, long long row_stride, int row0, int nrows) {
  for (int c = threadIdx.x; c < ROWS * (D / 8); c += NTHREADS) {
    const int row = row0 + c / (D / 8);
    if (row < nrows) *reinterpret_cast<uint4*>(dst + row * row_stride + (c % (D / 8)) * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---------------------------------------------------------------------------
// D = 64 (K5): both passes run one CTA of three warpgroups. Warpgroup 2 is
// the producer: TMA loads of the CTA's resident tiles once, then the
// streamed tiles into a ring of B64_STAGES shared-memory stages behind
// full/empty mbarriers. Warpgroups 0 and 1 are the consumers, 64 resident
// rows each. Each consumer issues the score products of streamed tile j
// before it waits for the gradient products of tile j-1, so the tensor
// cores go on while it computes p and dS; the other consumer's work
// interleaves with its own.
// ---------------------------------------------------------------------------

constexpr int B64_ROWS = 128, B64_STREAM = 64, B64_STAGES = 3, B64_THREADS = 384;
constexpr int B64_TILE = 64 * 64 * 2;  // a 64-row bf16 tile: 8 KB, 1024-byte aligned
// dK/dV pass: K, V (128 rows each); per stage Q, dO (64 rows each); per
// stage lse·log2(e) and D (64 fp32 each); mbarriers; alignment slack
constexpr int DKV_STAGE_OFF = 4 * B64_TILE;
constexpr int DKV_STAT_OFF = DKV_STAGE_OFF + B64_STAGES * 2 * B64_TILE;
constexpr int DKV_BAR_OFF = DKV_STAT_OFF + B64_STAGES * 2 * B64_STREAM * 4;
constexpr int DKV_SMEM = DKV_BAR_OFF + 8 * (1 + 2 * B64_STAGES) + 1024;
// dQ pass: Q, dO (128 rows each); per stage K, V (64 rows each); mbarriers
constexpr int DQ_STAGE_OFF = 4 * B64_TILE;
constexpr int DQ_BAR_OFF = DQ_STAGE_OFF + B64_STAGES * 2 * B64_TILE;
constexpr int DQ_SMEM = DQ_BAR_OFF + 8 * (1 + 2 * B64_STAGES) + 1024;

// Rows r0 and r0 + 8 of a 64×64 fp32 accumulator, times `mul`, as bf16
// into a (rows, 64) slice; rows >= nrows are skipped.
__device__ __forceinline__ void store_rows(bf16* dst, long long row_stride, const float (&c)[32], int r0,
                                           int nrows, int t4, float mul) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = i * 8 + t4 * 2;
    if (r0 < nrows)
      *reinterpret_cast<uint32_t*>(dst + r0 * row_stride + col) = pack_bf16(c[4 * i] * mul, c[4 * i + 1] * mul);
    if (r0 + 8 < nrows)
      *reinterpret_cast<uint32_t*>(dst + (r0 + 8) * row_stride + col) =
          pack_bf16(c[4 * i + 2] * mul, c[4 * i + 3] * mul);
  }
}

// dK/dV pass: a CTA owns 128 key rows (64 a consumer, K and V resident as
// the A operands of Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ) and walks the 64-row query
// tiles; pᵀ and dSᵀ in registers are the A operands of dV += pᵀ·dO and
// dK += dSᵀ·Q (B = dO and Q, MN-major).
__global__ void __launch_bounds__(B64_THREADS, 1)
    flash_bwd_d64_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse, const float* __restrict__ dd,
                             bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Skv, int kv_end,
                             BwdStrides st, float scale, float scale_log2) {
  constexpr int ST = B64_STAGES, QB = B64_STREAM;
  extern __shared__ __align__(1024) unsigned char smem_dkv[];
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kv0 = blockIdx.x * B64_ROWS;
  bf16* dkb = dk + b * st.dk_b + h * st.dk_h;
  bf16* dvb = dv + b * st.dv_b + h * st.dv_h;
  if (kv0 >= kv_end) {  // masked keys: zero gradients
    zero_rows<B64_ROWS, 64, B64_THREADS>(dkb, st.dk_s, kv0, Skv);
    zero_rows<B64_ROWS, 64, B64_THREADS>(dvb, st.dv_s, kv0, Skv);
    return;
  }
  const uint32_t pad = ((smem_u32(smem_dkv) + 1023u) & ~1023u) - smem_u32(smem_dkv);
  const uint32_t base = smem_u32(smem_dkv) + pad;
  const uint32_t sK = base, sV = base + 2 * B64_TILE, sQ0 = base + DKV_STAGE_OFF;  // stage s: Q, then dO
  float* stat0 = reinterpret_cast<float*>(smem_dkv + pad + DKV_STAT_OFF);        // stage s: lse·log2e, then D
  const uint32_t full_kv = base + DKV_BAR_OFF, full0 = full_kv + 8, empty0 = full0 + 8 * ST;
  const int n_tiles = (Sq + QB - 1) / QB;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 32);  // the producer warp's lanes: the statistics are plain stores
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x < 256 + 32) {
      const long long stat_row = static_cast<long long>(blockIdx.y) * Sq;
      if (lane == 0) {
        mbar_arrive_expect_tx(full_kv, 4 * B64_TILE);
        tma_load_4d(sK, &tm_k, full_kv, 0, kv0, h, b);
        tma_load_4d(sV, &tm_v, full_kv, 0, kv0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        mbar_wait(empty0 + 8 * s, ((j / ST) & 1) ^ 1);
        float* stat = stat0 + s * 2 * QB;
        for (int i = lane; i < QB; i += 32) {
          const int row = j * QB + i;
          stat[i] = row < Sq ? lse[stat_row + row] * LOG2E : 0.f;
          stat[QB + i] = row < Sq ? dd[stat_row + row] : 0.f;
        }
        if (lane == 0) {
          const uint32_t sQ = sQ0 + s * 2 * B64_TILE;
          mbar_arrive_expect_tx(full0 + 8 * s, 2 * B64_TILE);
          tma_load_4d(sQ, &tm_q, full0 + 8 * s, 0, j * QB, h, b);
          tma_load_4d(sQ + B64_TILE, &tm_do, full0 + 8 * s, 0, j * QB, h, b);
        } else {
          mbar_arrive(full0 + 8 * s);
        }
      }
    }
  } else {  // consumers
    setmaxnreg_inc<232>();
    const int w = (threadIdx.x >> 5) & 3, g = lane >> 2, t4 = lane & 3;
    const uint32_t sKw = sK + wg * B64_TILE, sVw = sV + wg * B64_TILE;
    const int kw0 = kv0 + wg * 64;                 // this warpgroup's first key
    const int r0 = kw0 + w * 16 + g, r1 = r0 + 8;  // this thread's key rows
    float dk_acc[32], dv_acc[32], s_acc[32], dp_acc[32];
    uint32_t pa[16], da[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    fence_regs(dk_acc);  // zeroed here, not later next to a wgmma in flight
    fence_regs(dv_acc);

    mbar_wait(full_kv, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST;
      const uint32_t sQ = sQ0 + s * 2 * B64_TILE, sdO = sQ + B64_TILE;
      mbar_wait(full0 + 8 * s, (j / ST) & 1);
      fence_regs(s_acc);
      fence_regs(dp_acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_ss_m64n64(s_acc, desc_k(sKw + 32 * k), desc_k(sQ + 32 * k), k);
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_ss_m64n64(dp_acc, desc_k(sVw + 32 * k), desc_k(sdO + 32 * k), k);
      wgmma_commit();
      wgmma_wait<1>();  // dV and dK of tile j-1 are done: release its stage
      fence_regs(pa);
      fence_regs(da);
      mbar_arrive_if(empty0 + 8 * ((j + ST - 1) % ST), lane == 0 && j > 0);
      wgmma_wait<0>();
      fence_regs(s_acc);
      fence_regs(dp_acc);

      // pᵀ = exp2(s·scale·log2e − lse·log2e); dSᵀ = pᵀ ∘ (dPᵀ − D)
      const float* sl = stat0 + s * 2 * QB;
      const float* sd = sl + QB;
      const int q0 = j * QB;
      const bool ragged = q0 + QB > Sq || kw0 + 64 > kv_end;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 l2s = *reinterpret_cast<const float2*>(sl + i * 8 + t4 * 2);
        const float2 dsums = *reinterpret_cast<const float2*>(sd + i * 8 + t4 * 2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = i * 8 + t4 * 2 + e;
          const float l2 = e ? l2s.y : l2s.x, dsum = e ? dsums.y : dsums.x;
          float p0 = ex2(fmaf(s_acc[4 * i + e], scale_log2, -l2));
          float p1 = ex2(fmaf(s_acc[4 * i + 2 + e], scale_log2, -l2));
          if (ragged) {
            const bool qlive = q0 + c < Sq;
            if (!(qlive && r0 < kv_end)) p0 = 0.f;
            if (!(qlive && r1 < kv_end)) p1 = 0.f;
          }
          s_acc[4 * i + e] = p0;
          s_acc[4 * i + 2 + e] = p1;
          dp_acc[4 * i + e] = p0 * (dp_acc[4 * i + e] - dsum);
          dp_acc[4 * i + 2 + e] = p1 * (dp_acc[4 * i + 2 + e] - dsum);
        }
      }
      pack_a<4>(pa, s_acc);
      pack_a<4>(da, dp_acc);
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        wgmma_rs_m64n64_mn(dv_acc, pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2], pa[4 * kc + 3],
                           desc_mn(sdO + 2048 * kc));
        wgmma_rs_m64n64_mn(dk_acc, da[4 * kc], da[4 * kc + 1], da[4 * kc + 2], da[4 * kc + 3],
                           desc_mn(sQ + 2048 * kc));
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(pa);
    fence_regs(da);
    store_rows(dkb, st.dk_s, dk_acc, r0, Skv, t4, scale);
    store_rows(dvb, st.dv_s, dv_acc, r0, Skv, t4, 1.f);
  }
}

// dQ pass: a CTA owns 128 query rows (64 a consumer, Q and dO resident as
// the A operands of S = Q·Kᵀ and dP = dO·Vᵀ) and walks the 64-row key tiles
// up to kv_end; dS in registers is the A operand of dQ += dS·K (B = K,
// MN-major).
__global__ void __launch_bounds__(B64_THREADS, 1)
    flash_bwd_d64_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ lse, const float* __restrict__ dd, bf16* __restrict__ dq,
                            int H, int Sq, int kv_end, BwdStrides st, float scale, float scale_log2) {
  constexpr int ST = B64_STAGES, KB = B64_STREAM;
  extern __shared__ __align__(1024) unsigned char smem_dq[];
  const uint32_t base = (smem_u32(smem_dq) + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + 2 * B64_TILE, sK0 = base + DQ_STAGE_OFF;  // stage s: K, then V
  const uint32_t full_qd = base + DQ_BAR_OFF, full0 = full_qd + 8, empty0 = full0 + 8 * ST;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * B64_ROWS;
  const int n_tiles = (kv_end + KB - 1) / KB;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(full_qd, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(full_qd, 4 * B64_TILE);
      tma_load_4d(sQ, &tm_q, full_qd, 0, q0, h, b);
      tma_load_4d(sdO, &tm_do, full_qd, 0, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        const uint32_t sK = sK0 + s * 2 * B64_TILE;
        mbar_wait(empty0 + 8 * s, ((j / ST) & 1) ^ 1);
        mbar_arrive_expect_tx(full0 + 8 * s, 2 * B64_TILE);
        tma_load_4d(sK, &tm_k, full0 + 8 * s, 0, j * KB, h, b);
        tma_load_4d(sK + B64_TILE, &tm_v, full0 + 8 * s, 0, j * KB, h, b);
      }
    }
  } else {  // consumers
    setmaxnreg_inc<232>();
    const int w = (threadIdx.x >> 5) & 3, g = lane >> 2, t4 = lane & 3;
    const uint32_t sQw = sQ + wg * B64_TILE, sdOw = sdO + wg * B64_TILE;
    const int row0 = q0 + wg * 64 + w * 16 + g, row1 = row0 + 8;  // this thread's query rows
    const long long stat = static_cast<long long>(blockIdx.y) * Sq;
    const float l2_0 = row0 < Sq ? lse[stat + row0] * LOG2E : 0.f;
    const float l2_1 = row1 < Sq ? lse[stat + row1] * LOG2E : 0.f;
    const float dd0 = row0 < Sq ? dd[stat + row0] : 0.f;
    const float dd1 = row1 < Sq ? dd[stat + row1] : 0.f;
    float dq_acc[32], s_acc[32], dp_acc[32];
    uint32_t da[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
    fence_regs(dq_acc);  // zeroed here, not later next to a wgmma in flight

    mbar_wait(full_qd, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST;
      const uint32_t sK = sK0 + s * 2 * B64_TILE, sV = sK + B64_TILE;
      mbar_wait(full0 + 8 * s, (j / ST) & 1);
      fence_regs(s_acc);
      fence_regs(dp_acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_ss_m64n64(s_acc, desc_k(sQw + 32 * k), desc_k(sK + 32 * k), k);
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_ss_m64n64(dp_acc, desc_k(sdOw + 32 * k), desc_k(sV + 32 * k), k);
      wgmma_commit();
      wgmma_wait<1>();  // dQ of tile j-1 is done: release its stage
      fence_regs(da);
      mbar_arrive_if(empty0 + 8 * ((j + ST - 1) % ST), lane == 0 && j > 0);
      wgmma_wait<0>();
      fence_regs(s_acc);
      fence_regs(dp_acc);

      // p = exp2(s·scale·log2e − lse·log2e); dS = p ∘ (dP − D)
      const int kv0 = j * KB;
      const bool ragged = kv0 + KB > kv_end;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = ex2(fmaf(s_acc[4 * i + e], scale_log2, -l2_0));
          float p1 = ex2(fmaf(s_acc[4 * i + 2 + e], scale_log2, -l2_1));
          if (ragged && kv0 + i * 8 + t4 * 2 + e >= kv_end) p0 = p1 = 0.f;
          dp_acc[4 * i + e] = p0 * (dp_acc[4 * i + e] - dd0);
          dp_acc[4 * i + 2 + e] = p1 * (dp_acc[4 * i + 2 + e] - dd1);
        }
      }
      pack_a<4>(da, dp_acc);
      fence_regs(dq_acc);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs_m64n64_mn(dq_acc, da[4 * kc], da[4 * kc + 1], da[4 * kc + 2], da[4 * kc + 3],
                           desc_mn(sK + 2048 * kc));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_regs(da);
    store_rows(dq + b * st.dq_b + h * st.dq_h, st.dq_s, dq_acc, row0, Sq, t4, scale);
  }
}

// ---------------------------------------------------------------------------
// D % 128 == 0 (K6, D <= 512; on the main path the train step's VAE decode
// mid-block attention, one 512-wide head), in the head-dim split of K2
// (flash_fwd.cu) and of flash_f32.cu's backward.
//
// The register arithmetic that sets the design. A 64-row fp32 accumulator
// over one half of D = 512 (64 × 256) is 128 registers a thread of one
// warpgroup, and a consumer warpgroup gets at most 232 (setmaxnreg; 384
// threads a CTA). So a CTA's two consumer warpgroups hold one 64 × D output
// tile between them, one half each, and never dK and dV together (256
// registers a thread). Three passes, each one launch writing one output,
// all on one pipeline:
//   dV  a CTA owns 64 key rows (K resident) and walks 64-row query tiles:
//       Sᵀ = K·Qⱼᵀ, pᵀ = exp2(Sᵀ·scale·log2e − lse·log2e), dV += pᵀ·dOⱼ;
//   dK  64 key rows (K and V resident), 32-row query tiles: Sᵀ, dPᵀ =
//       V·dOⱼᵀ, dSᵀ = pᵀ∘(dPᵀ − D), dK += dSᵀ·Qⱼ;
//   dQ  64 query rows (Q and dO resident), 32-row key tiles up to kv_end:
//       S = Q·Kⱼᵀ, dP = dO·Vⱼᵀ, dS = p∘(dP − D), dQ += dS·Kⱼ.
// flash_bwd_wide_dkv launches dV, then dK; flash_bwd_wide_dq launches dQ.
// Tensor work: 8 products of 2·Sq·Skv·D a head (S three times, dP twice,
// dV, dK, dQ), 16·B·H·Sq·Skv·D in all, against the 10·B·H·Sq·Skv·D the bound
// counts (each product once): at 4 × 4096² × 512, 0.555 ms of bf16 tensor
// time on an H100 SXM against the 0.347 ms bound.
// Shared memory at D = 512: dV holds K (64 KB), Qⱼ (64 KB), dOⱼ (64 KB) and
// the exchange (32 KB); dK and dQ two resident tiles (128 KB), two 32-row
// streamed tiles (2 × 32 KB) and the exchange: 224 KB each. The 32-row tiles
// are what fits beside two resident ones; their first products are
// m64n32k16.
//
// In a CTA, consumer warpgroup wg owns head-dim columns [wg·D/2, (wg + 1)·D/2):
// it computes its partial first products over its half (wgmma SS: A the
// resident tile, B the streamed one, both K-major), the two swap partials
// through shared memory and add them (mine + other's: the same bits in
// both), each computes p (and dS) for the whole tile, packs it to bf16 A
// fragments in registers and accumulates its half of the output (wgmma RS,
// B the streamed tile read MN-major: bf16 has the transpose flag, so no
// transposed copy and no pre-pass). The producer warpgroup (setmaxnreg 40;
// the consumers 232): warp 8 loads the resident tiles once, then the first
// streamed tensor (Qⱼ; in dQ Kⱼ), its 32 lanes writing the tile's
// lse·log2e and D into a two-slot buffer in the dV and dK passes; warp 9's
// lane 0 loads the second (dOⱼ; in dQ Vⱼ). One stage each, behind a
// full/empty mbarrier pair each. Order per tile in dK and dQ: tile j's
// second product and tile j+1's dP are issued together; the first streamed
// tile is released when the second product is done, and the next one loads
// under dP; then S. In dV, K2's order: pⱼ·dOⱼ, then Sⱼ₊₁ (Qⱼ₊₁ loads under
// pⱼ·dOⱼ, dOⱼ₊₁ under Sⱼ₊₁ and the exchange).
// TMA boxes: 64 columns × 64 rows (resident tiles, dV's streamed tiles) or
// × 32 rows, 128-byte swizzled; 4-D maps (D, S, H, B) take the strided
// q/k/v views of a fused projection; rows past Sq (or kv_end) read as zeros.
// Kept from the mma.sync kernels this replaces: p rounded to bf16 before dV,
// dS rounded to bf16, fp32 accumulation, keys >= kv_end get zero dK and dV
// (CTAs past kv_end write zeros; in the tile that holds kv_end p is masked),
// queries past Sq are masked, and no atomics (deterministic).
// ---------------------------------------------------------------------------

enum WideMode { WIDE_DV, WIDE_DK, WIDE_DQ };

template <int D, int MODE>
struct WideBwd {
  static constexpr int BN = MODE == WIDE_DV ? 64 : 32;  // rows of a streamed tile
  static constexpr int NR = MODE == WIDE_DV ? 1 : 2;    // resident tiles
  static constexpr int NBOX = D / 64;                    // 64-column boxes of a row tile
  static constexpr int HB = NBOX / 2;                    // the boxes of one consumer's half
  static constexpr int RBOX = 64 * 128, SBOX = BN * 128;  // bytes of a resident, a streamed box
  static constexpr int RTILE = NBOX * RBOX, STILE = NBOX * SBOX;
  static constexpr int S1_OFF = NR * RTILE, S2_OFF = S1_OFF + STILE;
  static constexpr int X_OFF = S2_OFF + STILE;        // the exchange: 2 × 32 registers × 128 threads, fp32
  static constexpr int STAT_OFF = X_OFF + 2 * 16384;  // 2 slots × (lse·log2e, D) × BN, fp32
  static constexpr int BAR_OFF = STAT_OFF + 2 * 2 * BN * 4;
  // resident full; first streamed full, empty; second streamed full, empty; alignment
  static constexpr int SMEM = BAR_OFF + 8 * 5 + 1024;
  static constexpr int THREADS = 384, PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  // the launch allocates 168 registers a thread (65536 / 384, rounded down
  // to 8); the consumers' setmaxnreg.inc takes what the producers' dec frees
  static_assert(128 * (PRODUCER_REGS + 2 * CONSUMER_REGS) <= THREADS * 168, "register file");
  static_assert(SMEM <= 232448, "shared memory");
};

// the first products: m64n64k16 for 64-row streamed tiles, m64n32k16 for 32
__device__ __forceinline__ void wgmma_ss_rows(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  wgmma_ss_m64n64(d, da, db, accumulate);
}
__device__ __forceinline__ void wgmma_ss_rows(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  wgmma_ss_m64n32(d, da, db, accumulate);
}

// One pass (MODE) for the CTA of 64 rows blockIdx.x · 64 of (b·h) blockIdx.y.
// tm_r1, tm_r2: the resident tensors (dV: K; dK: K, V; dQ: Q, dO); tm_s1,
// tm_s2: the streamed ones (dV, dK: Q, dO; dQ: K, V). out: dV, dK or dQ with
// element strides (b, s, h) and rows_out rows (Skv, or Sq); `mul` scales it.
template <int D, int MODE>
__global__ void __launch_bounds__(WideBwd<D, MODE>::THREADS, 1)
    flash_bwd_wide_kernel(const __grid_constant__ CUtensorMap tm_r1, const __grid_constant__ CUtensorMap tm_r2,
                          const __grid_constant__ CUtensorMap tm_s1, const __grid_constant__ CUtensorMap tm_s2,
                          const float* __restrict__ lse, const float* __restrict__ dd, bf16* __restrict__ out,
                          long long o_b, long long o_s, long long o_h, int H, int Sq, int rows_out, int kv_end,
                          float mul, float scale_log2) {
  using C = WideBwd<D, MODE>;
  constexpr int BN = C::BN, NCB = D / 128, KS = D / 32;  // a consumer's 64-column output blocks, k16 slices
  constexpr int NS = BN / 2;                              // registers of a first product's accumulator
  constexpr bool DQ = MODE == WIDE_DQ, DV = MODE == WIDE_DV;
  extern __shared__ __align__(1024) unsigned char smem_wbwd[];
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int row0 = blockIdx.x * 64;
  bf16* ob = out + b * o_b + h * o_h;
  if (!DQ && row0 >= kv_end) {  // masked keys: zero gradients
    zero_rows<64, D, C::THREADS>(ob, o_s, row0, rows_out);
    return;
  }
  const uint32_t raw = smem_u32(smem_wbwd), base = (raw + 1023u) & ~1023u;
  const uint32_t sR = base, sS1 = base + C::S1_OFF, sS2 = base + C::S2_OFF;
  float* stat = reinterpret_cast<float*>(smem_wbwd + (base - raw) + C::STAT_OFF);
  const uint32_t full_r = base + C::BAR_OFF, full1 = full_r + 8, empty1 = full_r + 16, full2 = full_r + 24,
                 empty2 = full_r + 32;
  const int n_tiles = ((DQ ? kv_end : Sq) + BN - 1) / BN;
  const long long srow = static_cast<long long>(blockIdx.y) * Sq;  // lse and D rows of this (b, h)
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(full_r, 1);
    mbar_init(full1, 32);  // warp 8's lanes: the statistics are plain stores
    mbar_init(full2, 1);
    mbar_init(empty1, 8);  // one arrival per consumer warp
    mbar_init(empty2, 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producers: warp 8 the resident tiles and the first streamed tensor, warp 9 the second
    setmaxnreg_dec<C::PRODUCER_REGS>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 8) {
      if (lane == 0) {
        mbar_arrive_expect_tx(full_r, C::NR * C::RTILE);
        for (int c = 0; c < C::NBOX; ++c) tma_load_4d(sR + c * C::RBOX, &tm_r1, full_r, 64 * c, row0, h, b);
        if (C::NR == 2)
          for (int c = 0; c < C::NBOX; ++c)
            tma_load_4d(sR + C::RTILE + c * C::RBOX, &tm_r2, full_r, 64 * c, row0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(empty1, (j & 1) ^ 1);
        if (!DQ) {
          float* st = stat + (j & 1) * 2 * BN;
          for (int i = lane; i < BN; i += 32) {
            const int row = j * BN + i;
            st[i] = row < Sq ? lse[srow + row] * LOG2E : 0.f;
            st[BN + i] = row < Sq ? dd[srow + row] : 0.f;
          }
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full1, C::STILE);
          for (int c = 0; c < C::NBOX; ++c) tma_load_4d(sS1 + c * C::SBOX, &tm_s1, full1, 64 * c, j * BN, h, b);
        } else {
          mbar_arrive(full1);
        }
      }
    } else if (warp == 9 && lane == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(empty2, (j & 1) ^ 1);
        mbar_arrive_expect_tx(full2, C::STILE);
        for (int c = 0; c < C::NBOX; ++c) tma_load_4d(sS2 + c * C::SBOX, &tm_s2, full2, 64 * c, j * BN, h, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns head-dim columns [wg·D/2, (wg + 1)·D/2)
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, t4 = lane & 3, tid = threadIdx.x & 127;
  float* xbuf = reinterpret_cast<float*>(smem_wbwd + (base - raw) + C::X_OFF);
  const int r0 = row0 + w * 16 + (lane >> 2), r1 = r0 + 8;  // this thread's rows (keys; queries in dQ)
  float l2_0 = 0.f, l2_1 = 0.f, dd0 = 0.f, dd1 = 0.f;       // dQ: its rows' lse·log2e and D
  if (DQ) {
    if (r0 < Sq) l2_0 = lse[srow + r0] * LOG2E, dd0 = dd[srow + r0];
    if (r1 < Sq) l2_1 = lse[srow + r1] * LOG2E, dd1 = dd[srow + r1];
  }
  float acc[NCB][32], s_acc[NS], dp_acc[NS];
  uint32_t pa[NS / 2];  // p (dV) or dS as bf16 A fragments: BN/16 k16 slices
#pragma unroll
  for (int i = 0; i < NS; ++i) s_acc[i] = dp_acc[i] = 0.f;
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
    fence_regs(acc[cb]);  // zeroed here, not later next to a wgmma in flight
  }

  // S (or Sᵀ), this warpgroup's partial: the resident tile times the first streamed one
  auto issue_s = [&]() {
    fence_regs(s_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t box = wg * C::HB + kk / 4;
      wgmma_ss_rows(s_acc, desc_k(opaque(sR) + box * C::RBOX + 32 * (kk % 4)),
                    desc_k(opaque(sS1) + box * C::SBOX + 32 * (kk % 4)), kk > 0);
    }
    wgmma_commit();
  };
  // dP (or dPᵀ), its partial: the second resident tile times the second streamed one
  auto issue_dp = [&]() {
    fence_regs(dp_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t box = wg * C::HB + kk / 4;
      wgmma_ss_rows(dp_acc, desc_k(opaque(sR) + C::RTILE + box * C::RBOX + 32 * (kk % 4)),
                    desc_k(opaque(sS2) + box * C::SBOX + 32 * (kk % 4)), kk > 0);
    }
    wgmma_commit();
  };
  // the output half += pa · (dV: dOⱼ; dK: Qⱼ; dQ: Kⱼ)[:, half], B MN-major
  auto issue_out = [&]() {
    fence_regs(pa);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) fence_regs(acc[cb]);
    wgmma_fence();
    const uint32_t sB = DV ? sS2 : sS1;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
        wgmma_rs_m64n64_mn(acc[cb], pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2], pa[4 * kc + 3],
                           desc_mn(opaque(sB) + (wg * C::HB + cb) * C::SBOX + 2048 * kc));
    wgmma_commit();
  };
  // the full S (and dP): mine + the other half's, swapped through shared
  // memory (barrier 2 + wg: the other warpgroup has read my previous partials)
  auto exchange = [&](int j) {
    if (j > 0) named_bar_sync(2 + wg, 256);
#pragma unroll
    for (int i = 0; i < NS; ++i) xbuf[(wg * 32 + i) * 128 + tid] = s_acc[i];
    if (!DV) {
#pragma unroll
      for (int i = 0; i < NS; ++i) xbuf[(wg * 32 + NS + i) * 128 + tid] = dp_acc[i];
    }
    named_bar_sync(1, 256);
#pragma unroll
    for (int i = 0; i < NS; ++i) s_acc[i] += xbuf[((1 - wg) * 32 + i) * 128 + tid];
    if (!DV) {
#pragma unroll
      for (int i = 0; i < NS; ++i) dp_acc[i] += xbuf[((1 - wg) * 32 + NS + i) * 128 + tid];
    }
    if (j + 1 < n_tiles) named_bar_arrive(2 + (1 - wg), 256);
  };
  // p = exp2(s·scale·log2e − lse·log2e) and dS = p∘(dP − D) of tile j,
  // packed to bf16; S's and dP's registers zeroed (their values end here,
  // not at the next wgmma)
  auto grads = [&](int j) {
    const int c0 = j * BN;  // the tile's first column: a query (dV, dK) or a key (dQ)
    if (DQ) {
      const bool ragged = c0 + BN > kv_end;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = ex2(fmaf(s_acc[4 * i + e], scale_log2, -l2_0));
          float p1 = ex2(fmaf(s_acc[4 * i + 2 + e], scale_log2, -l2_1));
          if (ragged && c0 + i * 8 + t4 * 2 + e >= kv_end) p0 = p1 = 0.f;
          dp_acc[4 * i + e] = p0 * (dp_acc[4 * i + e] - dd0);
          dp_acc[4 * i + 2 + e] = p1 * (dp_acc[4 * i + 2 + e] - dd1);
        }
    } else {
      const float* sl = stat + (j & 1) * 2 * BN;
      const bool ragged = c0 + BN > Sq || row0 + 64 > kv_end;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const float2 l2s = *reinterpret_cast<const float2*>(sl + i * 8 + t4 * 2);
        const float2 dsums = *reinterpret_cast<const float2*>(sl + BN + i * 8 + t4 * 2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l2 = e ? l2s.y : l2s.x, dsum = e ? dsums.y : dsums.x;
          float p0 = ex2(fmaf(s_acc[4 * i + e], scale_log2, -l2));
          float p1 = ex2(fmaf(s_acc[4 * i + 2 + e], scale_log2, -l2));
          if (ragged) {
            const bool qlive = c0 + i * 8 + t4 * 2 + e < Sq;
            if (!(qlive && r0 < kv_end)) p0 = 0.f;
            if (!(qlive && r1 < kv_end)) p1 = 0.f;
          }
          if (DV) {
            s_acc[4 * i + e] = p0;
            s_acc[4 * i + 2 + e] = p1;
          } else {
            dp_acc[4 * i + e] = p0 * (dp_acc[4 * i + e] - dsum);
            dp_acc[4 * i + 2 + e] = p1 * (dp_acc[4 * i + 2 + e] - dsum);
          }
        }
      }
    }
    pack_a<BN / 16>(pa, DV ? s_acc : dp_acc);
#pragma unroll
    for (int i = 0; i < NS; ++i) s_acc[i] = dp_acc[i] = 0.f;
  };

  mbar_wait(full_r, 0);
  if (DV) {
    mbar_wait(full1, 0);
    issue_s();
    wgmma_wait<0>();
    fence_regs(s_acc);
    mbar_arrive_if(empty1, lane == 0);
    exchange(0);
    grads(0);
    // iteration j: pⱼ·dOⱼ, then Sⱼ₊₁, on the tensor cores; dOⱼ released when
    // its product is done, Qⱼ₊₁ when Sⱼ₊₁ is; then the exchange and pⱼ₊₁
    for (int j = 0; j < n_tiles; ++j) {
      mbar_wait(full2, j & 1);
      issue_out();
      if (j + 1 < n_tiles) {
        mbar_wait(full1, (j + 1) & 1);
        issue_s();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) fence_regs(acc[cb]);
      fence_regs(pa);
      mbar_arrive_if(empty2, lane == 0);
      if (j + 1 < n_tiles) {
        wgmma_wait<0>();
        fence_regs(s_acc);
        mbar_arrive_if(empty1, lane == 0);
        exchange(j + 1);
        grads(j + 1);
      }
    }
  } else {
    mbar_wait(full1, 0);
    issue_s();
    mbar_wait(full2, 0);
    issue_dp();
    wgmma_wait<0>();
    fence_regs(s_acc);
    fence_regs(dp_acc);
    mbar_arrive_if(empty2, lane == 0);
    exchange(0);
    grads(0);
    // iteration j: dSⱼ·(Qⱼ or Kⱼ), then dPⱼ₊₁, on the tensor cores; the
    // first streamed tile j released when its second product is done (tile
    // j+1 loads under dPⱼ₊₁); then Sⱼ₊₁, the exchange and dSⱼ₊₁
    for (int j = 0; j < n_tiles; ++j) {
      issue_out();
      if (j + 1 < n_tiles) {
        mbar_wait(full2, (j + 1) & 1);
        issue_dp();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) fence_regs(acc[cb]);
      fence_regs(pa);
      mbar_arrive_if(empty1, lane == 0);
      if (j + 1 < n_tiles) {
        mbar_wait(full1, (j + 1) & 1);
        issue_s();
        wgmma_wait<0>();
        fence_regs(s_acc);
        fence_regs(dp_acc);
        mbar_arrive_if(empty2, lane == 0);
        exchange(j + 1);
        grads(j + 1);
      }
    }
  }

  bf16* obh = ob + wg * (D / 2) + 2 * t4;
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 64 * cb + 8 * i;
      if (r0 < rows_out)
        *reinterpret_cast<uint32_t*>(obh + r0 * o_s + col) = pack_bf16(acc[cb][4 * i] * mul, acc[cb][4 * i + 1] * mul);
      if (r1 < rows_out)
        *reinterpret_cast<uint32_t*>(obh + r1 * o_s + col) =
            pack_bf16(acc[cb][4 * i + 2] * mul, acc[cb][4 * i + 3] * mul);
    }
}

BwdStrides make_strides(const long long* s) {
  BwdStrides st;
  long long* dst = &st.q_b;
  for (int i = 0; i < 21; ++i) dst[i] = s[i];
  return st;
}

// The 4-D map (D, S, H, B) of a (B, S, H, D) bf16 view with element strides
// (b, s, h), boxes of 64 columns × `box_rows` rows, 128-byte swizzled; rows
// at or past S read as zeros. Returns a cudaError_t.
int wide_map(CUtensorMap* map, const void* base, int D, int S, int H, int B, long long s_s, long long s_h,
             long long s_b, int box_rows) {
  const long long dims[4] = {D, S, H, B}, strides[3] = {2 * s_s, 2 * s_h, 2 * s_b};
  const int box[4] = {64, box_rows, 1, 1};
  return make_map(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D, int MODE>
int launch_wide(const CUtensorMap& r1, const CUtensorMap& r2, const CUtensorMap& s1, const CUtensorMap& s2,
                const void* lse, const void* dd, void* out, long long o_b, long long o_s, long long o_h, int B,
                int H, int Sq, int rows_out, int kv_end, float mul, float scale, cudaStream_t stream) {
  using C = WideBwd<D, MODE>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_wide_kernel<D, MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  dim3 grid((rows_out + 63) / 64, B * H);
  flash_bwd_wide_kernel<D, MODE><<<grid, C::THREADS, C::SMEM, stream>>>(
      r1, r2, s1, s2, static_cast<const float*>(lse), static_cast<const float*>(dd), static_cast<bf16*>(out), o_b,
      o_s, o_h, H, Sq, rows_out, kv_end, mul, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// dV, then dK; keys at or past kv_end lie outside the K and V maps and read as zeros
template <int D>
int wide_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* dd,
             void* dk, void* dv, int B, int H, int Sq, int Skv, int kv_end, const BwdStrides& st, float scale,
             cudaStream_t stream) {
  CUtensorMap tk, tv, tq64, tdo64, tq32, tdo32;
  int err = wide_map(&tk, k, D, kv_end, H, B, st.k_s, st.k_h, st.k_b, 64);
  if (err == 0) err = wide_map(&tv, v, D, kv_end, H, B, st.v_s, st.v_h, st.v_b, 64);
  if (err == 0) err = wide_map(&tq64, q, D, Sq, H, B, st.q_s, st.q_h, st.q_b, 64);
  if (err == 0) err = wide_map(&tdo64, dout, D, Sq, H, B, st.do_s, st.do_h, st.do_b, 64);
  if (err == 0) err = wide_map(&tq32, q, D, Sq, H, B, st.q_s, st.q_h, st.q_b, 32);
  if (err == 0) err = wide_map(&tdo32, dout, D, Sq, H, B, st.do_s, st.do_h, st.do_b, 32);
  if (err == 0)
    err = launch_wide<D, WIDE_DV>(tk, tk, tq64, tdo64, lse, dd, dv, st.dv_b, st.dv_s, st.dv_h, B, H, Sq, Skv,
                                  kv_end, 1.f, scale, stream);
  if (err == 0)
    err = launch_wide<D, WIDE_DK>(tk, tv, tq32, tdo32, lse, dd, dk, st.dk_b, st.dk_s, st.dk_h, B, H, Sq, Skv,
                                  kv_end, scale, scale, stream);
  return err;
}

template <int D>
int wide_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* dd,
            void* dq, int B, int H, int Sq, int kv_end, const BwdStrides& st, float scale, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  int err = wide_map(&tq, q, D, Sq, H, B, st.q_s, st.q_h, st.q_b, 64);
  if (err == 0) err = wide_map(&tdo, dout, D, Sq, H, B, st.do_s, st.do_h, st.do_b, 64);
  if (err == 0) err = wide_map(&tk, k, D, kv_end, H, B, st.k_s, st.k_h, st.k_b, 32);
  if (err == 0) err = wide_map(&tv, v, D, kv_end, H, B, st.v_s, st.v_h, st.v_b, 32);
  if (err == 0)
    err = launch_wide<D, WIDE_DQ>(tq, tdo, tk, tv, lse, dd, dq, st.dq_b, st.dq_s, st.dq_h, B, H, Sq, Sq, kv_end,
                                  scale, scale, stream);
  return err;
}

}  // namespace

extern "C" {

// q: (B, Sq, H, D), k/v: (B, Skv, H, D), dout: (B, Sq, H, D), bf16, head dim
// contiguous; lse and dd (= rowsum(dO ∘ O)): (B, H, Sq) fp32 contiguous;
// dq: (B, Sq, H, D), dk/dv: (B, Skv, H, D) bf16. strides: 21 values in
// elements, (b, s, h) of q, k, v, dout, dq, dk, dv in that order. Keys
// [kv_end, Skv) get zero dk and dv.
int flash_bwd_d64_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dd, void* dk, void* dv, int B, int H, int Sq,
                      int Skv, int kv_end, const long long* strides, float scale, void* stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_d64_dkv_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const BwdStrides st = make_strides(strides);
  // keys at or past kv_end lie outside the K and V maps and read as zeros
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map_d64(&tq, q, Sq, H, B, st.q_s, st.q_h, st.q_b, B64_STREAM);
  if (err == 0) err = make_map_d64(&tdo, dout, Sq, H, B, st.do_s, st.do_h, st.do_b, B64_STREAM);
  if (err == 0) err = make_map_d64(&tk, k, kv_end, H, B, st.k_s, st.k_h, st.k_b, B64_ROWS);
  if (err == 0) err = make_map_d64(&tv, v, kv_end, H, B, st.v_s, st.v_h, st.v_b, B64_ROWS);
  if (err != 0) return err;
  dim3 grid((Skv + B64_ROWS - 1) / B64_ROWS, B * H);
  flash_bwd_d64_dkv_kernel<<<grid, B64_THREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(dd), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Sq, Skv, kv_end, st, scale, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

int flash_bwd_d64_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                     const void* dd, void* dq, int B, int H, int Sq, int kv_end,
                     const long long* strides, float scale, void* stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_d64_dq_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const BwdStrides st = make_strides(strides);
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map_d64(&tq, q, Sq, H, B, st.q_s, st.q_h, st.q_b, B64_ROWS);
  if (err == 0) err = make_map_d64(&tdo, dout, Sq, H, B, st.do_s, st.do_h, st.do_b, B64_ROWS);
  if (err == 0) err = make_map_d64(&tk, k, kv_end, H, B, st.k_s, st.k_h, st.k_b, B64_STREAM);
  if (err == 0) err = make_map_d64(&tv, v, kv_end, H, B, st.v_s, st.v_h, st.v_b, B64_STREAM);
  if (err != 0) return err;
  dim3 grid((Sq + B64_ROWS - 1) / B64_ROWS, B * H);
  flash_bwd_d64_dq_kernel<<<grid, B64_THREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(dd), static_cast<bf16*>(dq), H,
      Sq, kv_end, st, scale, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// The same contracts for D in {128, 256, 384, 512}; flash_bwd_wide_dkv
// makes two launches (dV, then dK), flash_bwd_wide_dq one.
int flash_bwd_wide_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dd, void* dk, void* dv, int B, int H, int Sq,
                       int Skv, int kv_end, int D, const long long* strides, float scale,
                       void* stream) {
  const BwdStrides st = make_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return wide_dkv<128>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Skv, kv_end, st, scale, s);
    case 256: return wide_dkv<256>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Skv, kv_end, st, scale, s);
    case 384: return wide_dkv<384>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Skv, kv_end, st, scale, s);
    case 512: return wide_dkv<512>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Skv, kv_end, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_bwd_wide_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dd, void* dq, int B, int H, int Sq, int kv_end,
                      int D, const long long* strides, float scale, void* stream) {
  const BwdStrides st = make_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return wide_dq<128>(q, k, v, dout, lse, dd, dq, B, H, Sq, kv_end, st, scale, s);
    case 256: return wide_dq<256>(q, k, v, dout, lse, dd, dq, B, H, Sq, kv_end, st, scale, s);
    case 384: return wide_dq<384>(q, k, v, dout, lse, dd, dq, B, H, Sq, kv_end, st, scale, s);
    case 512: return wide_dq<512>(q, k, v, dout, lse, dd, dq, B, H, Sq, kv_end, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
