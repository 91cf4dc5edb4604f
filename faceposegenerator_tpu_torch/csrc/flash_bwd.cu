// Flash-attention backward for Hopper (sm_90a): the gradients of
// o = softmax(q·kᵀ·scale)·v with respect to q, k and v, over bf16 tensors in
// (B, S, H, D) layout, from the forward's per-row log-sum-exp (flash_fwd.cu).
//
// Four kernels, two passes for each of the two TPU kernel pairs they replace
// (faceposegenerator_tpu/ops/flash_attention.py):
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
// Structure: two passes, as on the TPU, so that every output tile is owned by
// one CTA and nothing needs atomics (the result is deterministic). The dK/dV
// pass gives each CTA a tile of key rows and walks the query tiles; the dQ
// pass gives each CTA a tile of query rows and walks the key tiles. Each pass
// recomputes the scores, so the five products S, dP, dV, dK, dQ cost
// 10·Sq·Skv·D FLOPs per head in all (S and dP are computed twice).
//
// What bounds them on the card: at the 4096-token self-attention the work
// is ~10·Sq·Skv·D tensor-core FLOPs per head against ~(4·Sq + 4·Skv)·D·2
// bytes, far above the ~295 FLOP/byte ridge: tensor cores first, then the
// exp of every score on the special-function units (recomputed in both
// passes) and the chain that turns each score into the operand of the next
// product. The 77-key cross-attention backward moves q, dO and dq once for
// few FLOPs: bytes and launches bound.
//
// What the design does about it:
//   * D = 64 (sm90_common.cuh): wgmma on 64-row warpgroup tiles. In the
//     dK/dV pass a CTA keeps 128 key rows of K and V resident in shared
//     memory as the A operands of Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so no K or V
//     fragments sit in registers (the mma.sync version held 254 registers a
//     thread); the dQ pass keeps 128 query rows of Q and dO resident the
//     same way. The streamed tiles (Q and dO with their lse and D slices, or
//     K and V) arrive by TMA from a producer warpgroup into a three-stage
//     mbarrier ring, read straight by the tensor cores (once per warpgroup,
//     not four times per warp as with ldmatrix). pᵀ, dSᵀ (or dS) are
//     re-packed in registers as the A operand of dV += pᵀ·dO and dK += dSᵀ·Q
//     (or dQ += dS·K), with B read MN-major. Each consumer issues the score
//     products of the next streamed tile before it waits for the gradient
//     products of the last, so p and dS are computed while the tensor cores
//     run, and the two consumer warpgroups interleave.
//   * D = 512: a 64-row fp32 dK+dV accumulator would be 256 KB, so the
//     dK/dV pass takes 16 key rows per CTA and splits their 512 columns over
//     the 8 warps (64 fp32 registers a thread for dK and dV together), and
//     the dQ pass takes 32 query rows split the same way. The 16×32 (or
//     32×32) score and dP tiles are computed one 16×8 MMA tile per warp over
//     all of D, go through shared memory in fp32, and come back as bf16 p and
//     dS for the column-split products.
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

// ldmatrix lane → row/column offsets within a 16×16 operand block
__device__ __forceinline__ int lm_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int lm_col(int lane) { return (lane >> 4) * 8; }

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
// D % 128 == 0 (D <= 512), dK/dV pass: one CTA per (b·h, 16 key rows), 8
// warps. Per 32-row query tile: warps 0-3 compute the four 16×8 tiles of Sᵀ,
// warps 4-7 those of dPᵀ, each over all of D; then p and dS in shared memory;
// then warp w accumulates dK and dV for columns [w·D/8, (w+1)·D/8).
// ---------------------------------------------------------------------------

template <int D>
struct WideDkvSmem {
  static constexpr int BN = 16, BM = 32, SST = D + 8, SFS = BM + 1, PST = BM + 8;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + BN * SST * sizeof(bf16);
  static constexpr size_t q_off = v_off + BN * SST * sizeof(bf16);
  static constexpr size_t do_off = q_off + BM * SST * sizeof(bf16);
  static constexpr size_t s_off = do_off + BM * SST * sizeof(bf16);
  static constexpr size_t dp_off = s_off + BN * SFS * sizeof(float);
  static constexpr size_t p_off = dp_off + BN * SFS * sizeof(float);
  static constexpr size_t ds_off = p_off + BN * PST * sizeof(bf16);
  static constexpr size_t stat_off = ds_off + BN * PST * sizeof(bf16);
  static constexpr size_t bytes = stat_off + 2 * BM * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_wide_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dd,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Skv,
                              int kv_end, BwdStrides st, float scale, float scale_log2) {
  using L = WideDkvSmem<D>;
  constexpr int BM = L::BM, BN = L::BN, SST = L::SST, SFS = L::SFS, PST = L::PST, NT = 256;
  constexpr int DW = D / 8;    // dK/dV columns per warp
  constexpr int NDT = DW / 8;  // 8-column MMA tiles per warp
  extern __shared__ __align__(16) unsigned char smem_wdkv[];
  bf16* sK = reinterpret_cast<bf16*>(smem_wdkv + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem_wdkv + L::v_off);
  bf16* sQ = reinterpret_cast<bf16*>(smem_wdkv + L::q_off);
  bf16* sdO = reinterpret_cast<bf16*>(smem_wdkv + L::do_off);
  float* sS = reinterpret_cast<float*>(smem_wdkv + L::s_off);
  float* sDP = reinterpret_cast<float*>(smem_wdkv + L::dp_off);
  bf16* sP = reinterpret_cast<bf16*>(smem_wdkv + L::p_off);
  bf16* sDS = reinterpret_cast<bf16*>(smem_wdkv + L::ds_off);
  float* sL2 = reinterpret_cast<float*>(smem_wdkv + L::stat_off);
  float* sDd = sL2 + BM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kv0 = blockIdx.x * BN;
  const bf16* qb = q + b * st.q_b + h * st.q_h;
  const bf16* kb = k + b * st.k_b + h * st.k_h;
  const bf16* vb = v + b * st.v_b + h * st.v_h;
  const bf16* dob = dout + b * st.do_b + h * st.do_h;
  bf16* dkb = dk + b * st.dk_b + h * st.dk_h;
  bf16* dvb = dv + b * st.dv_b + h * st.dv_h;
  const long long stat0 = static_cast<long long>(blockIdx.y) * Sq;

  if (kv0 >= kv_end) {  // masked keys: zero gradients
    zero_rows<BN, D, NT>(dkb, st.dk_s, kv0, Skv);
    zero_rows<BN, D, NT>(dvb, st.dv_s, kv0, Skv);
    return;
  }
  load_tile<BN, D, SST, NT>(sK, kb, st.k_s, kv0, kv_end);
  load_tile<BN, D, SST, NT>(sV, vb, st.v_s, kv0, kv_end);

  const int lr = lm_row(lane), lc = lm_col(lane);
  float dka[NDT][4], dva[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  // this warp's 16×8 tile of Sᵀ (warps 0-3) or dPᵀ (warps 4-7)
  const bf16* sA = warp < 4 ? sK : sV;
  const bf16* sB = warp < 4 ? sQ : sdO;
  float* sOut = warp < 4 ? sS : sDP;
  const int nt = warp & 3;

  for (int q0 = 0; q0 < Sq; q0 += BM) {
    __syncthreads();  // the previous tile's Q, dO, p and dS are consumed
    load_tile<BM, D, SST, NT>(sQ, qb, st.q_s, q0, Sq);
    load_tile<BM, D, SST, NT>(sdO, dob, st.do_s, q0, Sq);
    if (tid < BM) {
      const bool live = q0 + tid < Sq;
      sL2[tid] = live ? lse[stat0 + q0 + tid] * LOG2E : 0.f;
      sDd[tid] = live ? dd[stat0 + q0 + tid] : 0.f;
    }
    __syncthreads();

    {
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int p = 0; p < D / 32; ++p) {
        uint32_t a0[4], a1[4], bb[4];
        ldsm_x4(a0, sA + lr * SST + p * 32 + lc);
        ldsm_x4(a1, sA + lr * SST + p * 32 + 16 + lc);
        ldsm_x4(bb, sB + (nt * 8 + (lane & 7)) * SST + p * 32 + (lane >> 3) * 8);
        mma_16816(c0, a0, bb[0], bb[1]);
        mma_16816(c1, a1, bb[2], bb[3]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sOut[g * SFS + nt * 8 + t4 * 2 + e] = c0[e] + c1[e];
        sOut[(g + 8) * SFS + nt * 8 + t4 * 2 + e] = c0[2 + e] + c1[2 + e];
      }
    }
    __syncthreads();

    // pᵀ and dSᵀ over the 16×32 tile, two elements a thread
#pragma unroll
    for (int i = 0; i < (BN * BM) / NT; ++i) {
      const int idx = tid + i * NT, r = idx / BM, c = idx % BM;
      float p = 0.f;
      if (kv0 + r < kv_end && q0 + c < Sq) p = ex2(fmaf(sS[r * SFS + c], scale_log2, -sL2[c]));
      sP[r * PST + c] = __float2bfloat16_rn(p);
      sDS[r * PST + c] = __float2bfloat16_rn(p * (sDP[r * SFS + c] - sDd[c]));
    }
    __syncthreads();

    // dV[:, warp's columns] += pᵀ·dO; dK[:, warp's columns] += dSᵀ·Q
#pragma unroll
    for (int kc = 0; kc < BM / 16; ++kc) {
      uint32_t pa[4], da[4];
      ldsm_x4(pa, sP + lr * PST + kc * 16 + lc);
      ldsm_x4(da, sDS + lr * PST + kc * 16 + lc);
#pragma unroll
      for (int jj = 0; jj < DW / 16; ++jj) {
        uint32_t of[4], qt[4];
        ldsm_x4_trans(of, sdO + (kc * 16 + lr) * SST + warp * DW + jj * 16 + lc);
        mma_16816(dva[2 * jj], pa, of[0], of[1]);
        mma_16816(dva[2 * jj + 1], pa, of[2], of[3]);
        ldsm_x4_trans(qt, sQ + (kc * 16 + lr) * SST + warp * DW + jj * 16 + lc);
        mma_16816(dka[2 * jj], da, qt[0], qt[1]);
        mma_16816(dka[2 * jj + 1], da, qt[2], qt[3]);
      }
    }
  }

  const int r0 = kv0 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    const int col = warp * DW + dt * 8 + t4 * 2;
    if (r0 < Skv) {
      *reinterpret_cast<uint32_t*>(dkb + r0 * st.dk_s + col) = pack_bf16(dka[dt][0] * scale, dka[dt][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + r0 * st.dv_s + col) = pack_bf16(dva[dt][0], dva[dt][1]);
    }
    if (r1 < Skv) {
      *reinterpret_cast<uint32_t*>(dkb + r1 * st.dk_s + col) = pack_bf16(dka[dt][2] * scale, dka[dt][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + r1 * st.dv_s + col) = pack_bf16(dva[dt][2], dva[dt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// D % 128 == 0 (D <= 512), dQ pass: one CTA per (b·h, 32 query rows), 8
// warps. Per 32-row key tile: warp w computes the 16×8 tile (w & 1, w >> 1)
// of both S and dP over all of D; then dS in shared memory; then warp w
// accumulates dQ for columns [w·D/8, (w+1)·D/8).
// ---------------------------------------------------------------------------

template <int D>
struct WideDqSmem {
  static constexpr int BM = 32, BN = 32, SST = D + 8, SFS = BN + 1, PST = BN + 8;
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + BM * SST * sizeof(bf16);
  static constexpr size_t k_off = do_off + BM * SST * sizeof(bf16);
  static constexpr size_t v_off = k_off + BN * SST * sizeof(bf16);
  static constexpr size_t s_off = v_off + BN * SST * sizeof(bf16);
  static constexpr size_t dp_off = s_off + BM * SFS * sizeof(float);
  static constexpr size_t ds_off = dp_off + BM * SFS * sizeof(float);
  static constexpr size_t stat_off = ds_off + BM * PST * sizeof(bf16);
  static constexpr size_t bytes = stat_off + 2 * BM * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_wide_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ dd,
                             bf16* __restrict__ dq, int H, int Sq, int kv_end, BwdStrides st,
                             float scale, float scale_log2) {
  using L = WideDqSmem<D>;
  constexpr int BM = L::BM, BN = L::BN, SST = L::SST, SFS = L::SFS, PST = L::PST, NT = 256;
  constexpr int DW = D / 8;
  constexpr int NDT = DW / 8;
  extern __shared__ __align__(16) unsigned char smem_wdq[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_wdq + L::q_off);
  bf16* sdO = reinterpret_cast<bf16*>(smem_wdq + L::do_off);
  bf16* sK = reinterpret_cast<bf16*>(smem_wdq + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem_wdq + L::v_off);
  float* sS = reinterpret_cast<float*>(smem_wdq + L::s_off);
  float* sDP = reinterpret_cast<float*>(smem_wdq + L::dp_off);
  bf16* sDS = reinterpret_cast<bf16*>(smem_wdq + L::ds_off);
  float* sL2 = reinterpret_cast<float*>(smem_wdq + L::stat_off);
  float* sDd = sL2 + BM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;
  const bf16* qb = q + b * st.q_b + h * st.q_h;
  const bf16* kb = k + b * st.k_b + h * st.k_h;
  const bf16* vb = v + b * st.v_b + h * st.v_h;
  const bf16* dob = dout + b * st.do_b + h * st.do_h;
  bf16* dqb = dq + b * st.dq_b + h * st.dq_h;
  const long long stat0 = static_cast<long long>(blockIdx.y) * Sq;

  load_tile<BM, D, SST, NT>(sQ, qb, st.q_s, q0, Sq);
  load_tile<BM, D, SST, NT>(sdO, dob, st.do_s, q0, Sq);
  if (tid < BM) {
    const bool live = q0 + tid < Sq;
    sL2[tid] = live ? lse[stat0 + q0 + tid] * LOG2E : 0.f;
    sDd[tid] = live ? dd[stat0 + q0 + tid] : 0.f;
  }

  const int lr = lm_row(lane), lc = lm_col(lane);
  float acc[2][NDT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < NDT; ++i) acc[mt][i][0] = acc[mt][i][1] = acc[mt][i][2] = acc[mt][i][3] = 0.f;

  const int smt = warp & 1, snt = warp >> 1;  // this warp's S and dP tile

  for (int kv0 = 0; kv0 < kv_end; kv0 += BN) {
    __syncthreads();  // the previous tile's K, V and dS are consumed
    load_tile<BN, D, SST, NT>(sK, kb, st.k_s, kv0, kv_end);
    load_tile<BN, D, SST, NT>(sV, vb, st.v_s, kv0, kv_end);
    __syncthreads();

    {
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
      float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int p = 0; p < D / 32; ++p) {
        uint32_t a0[4], a1[4], bb[4];
        ldsm_x4(a0, sQ + (smt * 16 + lr) * SST + p * 32 + lc);
        ldsm_x4(a1, sQ + (smt * 16 + lr) * SST + p * 32 + 16 + lc);
        ldsm_x4(bb, sK + (snt * 8 + (lane & 7)) * SST + p * 32 + (lane >> 3) * 8);
        mma_16816(s0, a0, bb[0], bb[1]);
        mma_16816(s1, a1, bb[2], bb[3]);
        ldsm_x4(a0, sdO + (smt * 16 + lr) * SST + p * 32 + lc);
        ldsm_x4(a1, sdO + (smt * 16 + lr) * SST + p * 32 + 16 + lc);
        ldsm_x4(bb, sV + (snt * 8 + (lane & 7)) * SST + p * 32 + (lane >> 3) * 8);
        mma_16816(p0, a0, bb[0], bb[1]);
        mma_16816(p1, a1, bb[2], bb[3]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = snt * 8 + t4 * 2 + e, r = smt * 16 + g;
        sS[r * SFS + c] = s0[e] + s1[e];
        sS[(r + 8) * SFS + c] = s0[2 + e] + s1[2 + e];
        sDP[r * SFS + c] = p0[e] + p1[e];
        sDP[(r + 8) * SFS + c] = p0[2 + e] + p1[2 + e];
      }
    }
    __syncthreads();

    // dS over the 32×32 tile, four elements a thread
#pragma unroll
    for (int i = 0; i < (BM * BN) / NT; ++i) {
      const int idx = tid + i * NT, r = idx / BN, c = idx % BN;
      float p = 0.f;
      if (kv0 + c < kv_end) p = ex2(fmaf(sS[r * SFS + c], scale_log2, -sL2[r]));
      sDS[r * PST + c] = __float2bfloat16_rn(p * (sDP[r * SFS + c] - sDd[r]));
    }
    __syncthreads();

    // dQ[:, warp's columns] += dS·K
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        uint32_t a[4];
        ldsm_x4(a, sDS + (mt * 16 + lr) * PST + kc * 16 + lc);
#pragma unroll
        for (int jj = 0; jj < DW / 16; ++jj) {
          uint32_t kt[4];
          ldsm_x4_trans(kt, sK + (kc * 16 + lr) * SST + warp * DW + jj * 16 + lc);
          mma_16816(acc[mt][2 * jj], a, kt[0], kt[1]);
          mma_16816(acc[mt][2 * jj + 1], a, kt[2], kt[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = q0 + mt * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      const int col = warp * DW + dt * 8 + t4 * 2;
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(dqb + r0 * st.dq_s + col) =
            pack_bf16(acc[mt][dt][0] * scale, acc[mt][dt][1] * scale);
      if (r1 < Sq)
        *reinterpret_cast<uint32_t*>(dqb + r1 * st.dq_s + col) =
            pack_bf16(acc[mt][dt][2] * scale, acc[mt][dt][3] * scale);
    }
  }
}

BwdStrides make_strides(const long long* s) {
  BwdStrides st;
  long long* dst = &st.q_b;
  for (int i = 0; i < 21; ++i) dst[i] = s[i];
  return st;
}

template <int D>
cudaError_t launch_wide_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                            const float* lse, const float* dd, bf16* dk, bf16* dv, int B, int H,
                            int Sq, int Skv, int kv_end, const BwdStrides& st, float scale,
                            cudaStream_t stream) {
  using L = WideDkvSmem<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_wide_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + L::BN - 1) / L::BN, B * H);
  flash_bwd_wide_dkv_kernel<D><<<grid, 256, L::bytes, stream>>>(
      q, k, v, dout, lse, dd, dk, dv, H, Sq, Skv, kv_end, st, scale, scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wide_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                           const float* lse, const float* dd, bf16* dq, int B, int H, int Sq,
                           int kv_end, const BwdStrides& st, float scale, cudaStream_t stream) {
  using L = WideDqSmem<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_wide_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + L::BM - 1) / L::BM, B * H);
  flash_bwd_wide_dq_kernel<D><<<grid, 256, L::bytes, stream>>>(q, k, v, dout, lse, dd, dq, H, Sq,
                                                               kv_end, st, scale, scale * LOG2E);
  return cudaGetLastError();
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

// The same contracts for D in {128, 256, 384, 512}.
int flash_bwd_wide_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dd, void* dk, void* dv, int B, int H, int Sq,
                       int Skv, int kv_end, int D, const long long* strides, float scale,
                       void* stream) {
  const BwdStrides st = make_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k);
  const bf16 *vv = static_cast<const bf16*>(v), *oo = static_cast<const bf16*>(dout);
  const float *ll = static_cast<const float*>(lse), *de = static_cast<const float*>(dd);
  bf16 *gk = static_cast<bf16*>(dk), *gv = static_cast<bf16*>(dv);
  switch (D) {
    case 128: return static_cast<int>(launch_wide_dkv<128>(qq, kk, vv, oo, ll, de, gk, gv, B, H, Sq, Skv, kv_end, st, scale, s));
    case 256: return static_cast<int>(launch_wide_dkv<256>(qq, kk, vv, oo, ll, de, gk, gv, B, H, Sq, Skv, kv_end, st, scale, s));
    case 384: return static_cast<int>(launch_wide_dkv<384>(qq, kk, vv, oo, ll, de, gk, gv, B, H, Sq, Skv, kv_end, st, scale, s));
    case 512: return static_cast<int>(launch_wide_dkv<512>(qq, kk, vv, oo, ll, de, gk, gv, B, H, Sq, Skv, kv_end, st, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_bwd_wide_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dd, void* dq, int B, int H, int Sq, int kv_end,
                      int D, const long long* strides, float scale, void* stream) {
  const BwdStrides st = make_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k);
  const bf16 *vv = static_cast<const bf16*>(v), *oo = static_cast<const bf16*>(dout);
  const float *ll = static_cast<const float*>(lse), *de = static_cast<const float*>(dd);
  bf16* gq = static_cast<bf16*>(dq);
  switch (D) {
    case 128: return static_cast<int>(launch_wide_dq<128>(qq, kk, vv, oo, ll, de, gq, B, H, Sq, kv_end, st, scale, s));
    case 256: return static_cast<int>(launch_wide_dq<256>(qq, kk, vv, oo, ll, de, gq, B, H, Sq, kv_end, st, scale, s));
    case 384: return static_cast<int>(launch_wide_dq<384>(qq, kk, vv, oo, ll, de, gq, B, H, Sq, kv_end, st, scale, s));
    case 512: return static_cast<int>(launch_wide_dq<512>(qq, kk, vv, oo, ll, de, gq, B, H, Sq, kv_end, st, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
