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
// bytes, far above the ~295 FLOP/byte ridge: tensor-core and exp bound. The
// 77-key cross-attention backward moves q, dO and dq once for few FLOPs:
// bytes and launches bound.
//
// What the design does about it (mma.sync + ldmatrix + cp.async; wgmma/TMA
// and warp specialisation are later work):
//   * D = 64: each warp owns 16 rows of its CTA's tile and keeps the operand
//     fragments of those rows (k and v in the dK/dV pass, q and dO in the dQ
//     pass) in registers for the whole loop; the streamed tile (q and dO, or
//     k and v) is double-buffered in shared memory with cp.async. The score
//     and dP fragments never leave registers: they are re-packed in place as
//     the A operand of the next product (the forward's P·V trick), and the
//     operand that must be transposed is read with ldmatrix.trans.
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
// D = 64, dK/dV pass: one CTA per (b·h, 64 key rows), 4 warps of 16 key rows.
// Query tiles of 64 rows (q, dO, lse, D) are double-buffered with cp.async.
// ---------------------------------------------------------------------------

constexpr int B64_BM = 64, B64_BN = 64, B64_SST = 64 + 8, B64_THREADS = 128;
// K, V, two (Q, dO) buffers, two (lse, D) buffers
constexpr int B64_DKV_SMEM =
    (2 * B64_BN + 4 * B64_BM) * B64_SST * static_cast<int>(sizeof(bf16)) + 4 * B64_BM * 4;
// Q, dO, two (K, V) buffers
constexpr int B64_DQ_SMEM = (2 * B64_BM + 4 * B64_BN) * B64_SST * static_cast<int>(sizeof(bf16));

__global__ void __launch_bounds__(B64_THREADS)
    flash_bwd_d64_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ dd,
                             bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Skv,
                             int kv_end, BwdStrides st, float scale, float scale_log2) {
  constexpr int BM = B64_BM, BN = B64_BN, SST = B64_SST, D = 64, NT = B64_THREADS;
  extern __shared__ __align__(16) unsigned char smem_dkv[];
  bf16* sK = reinterpret_cast<bf16*>(smem_dkv);
  bf16* sV = sK + BN * SST;
  bf16* sQD = sV + BN * SST;  // buffer i: Q at sQD + 2i·BM·SST, dO right after it
  float* sStat = reinterpret_cast<float*>(sQD + 4 * BM * SST);  // buffer i: lse, then D

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kv0 = blockIdx.x * BN;
  const bf16* qb = q + b * st.q_b + h * st.q_h;
  const bf16* kb = k + b * st.k_b + h * st.k_h;
  const bf16* vb = v + b * st.v_b + h * st.v_h;
  const bf16* dob = dout + b * st.do_b + h * st.do_h;
  bf16* dkb = dk + b * st.dk_b + h * st.dk_h;
  bf16* dvb = dv + b * st.dv_b + h * st.dv_h;
  const float* lseb = lse + static_cast<long long>(blockIdx.y) * Sq;
  const float* ddb = dd + static_cast<long long>(blockIdx.y) * Sq;

  if (kv0 >= kv_end) {  // masked keys: zero gradients
    zero_rows<BN, D, NT>(dkb, st.dk_s, kv0, Skv);
    zero_rows<BN, D, NT>(dvb, st.dv_s, kv0, Skv);
    return;
  }
  const int n_tiles = (Sq + BM - 1) / BM;

  auto load_q_tile = [&](int j) {
    bf16* dst = sQD + (j & 1) * 2 * BM * SST;
    cp_tile_d64<BM, SST, NT>(dst, qb, st.q_s, j * BM, Sq);
    cp_tile_d64<BM, SST, NT>(dst + BM * SST, dob, st.do_s, j * BM, Sq);
    float* stat = sStat + (j & 1) * 2 * BM;
    for (int i = threadIdx.x; i < 2 * BM; i += NT) {
      const int row = j * BM + (i % BM);
      const float* src = (i < BM ? lseb : ddb) + row;
      cp_async_4(stat + i, row < Sq ? src : lseb, row < Sq ? 4 : 0);
    }
    cp_async_commit();
  };

  cp_tile_d64<BN, SST, NT>(sK, kb, st.k_s, kv0, kv_end);
  cp_tile_d64<BN, SST, NT>(sV, vb, st.v_s, kv0, kv_end);
  load_q_tile(0);

  const int lr = lm_row(lane), lc = lm_col(lane);
  const int r0 = kv0 + warp * 16 + g, r1 = r0 + 8;  // this thread's key rows
  uint32_t kf[D / 16][4], vf[D / 16][4];
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_q_tile(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        ldsm_x4(kf[kc], sK + (warp * 16 + lr) * SST + kc * 16 + lc);
        ldsm_x4(vf[kc], sV + (warp * 16 + lr) * SST + kc * 16 + lc);
      }
    }
    const bf16* sQ = sQD + (j & 1) * 2 * BM * SST;
    const bf16* sdO = sQ + BM * SST;
    const float* sL = sStat + (j & 1) * 2 * BM;
    const float* sDd = sL + BM;
    const int q0 = j * BM;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for this warp's 16 key rows × 64 query columns
    float s[BM / 8][4], dp[BM / 8][4];
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int p = 0; p < D / 32; ++p) {
        uint32_t qf[4], df[4];
        ldsm_x4(qf, sQ + (nt * 8 + (lane & 7)) * SST + p * 32 + (lane >> 3) * 8);
        mma_16816(s[nt], kf[2 * p], qf[0], qf[1]);
        mma_16816(s[nt], kf[2 * p + 1], qf[2], qf[3]);
        ldsm_x4(df, sdO + (nt * 8 + (lane & 7)) * SST + p * 32 + (lane >> 3) * 8);
        mma_16816(dp[nt], vf[2 * p], df[0], df[1]);
        mma_16816(dp[nt], vf[2 * p + 1], df[2], df[3]);
      }
    }

    // pᵀ = exp2(s·scale·log2e − lse·log2e); dSᵀ = pᵀ ∘ (dPᵀ − D)
    const bool ragged = q0 + BM > Sq || kv0 + BN > kv_end;
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + t4 * 2 + e;
        const float l2 = sL[c] * LOG2E, dsum = sDd[c];
        float p0 = ex2(fmaf(s[nt][e], scale_log2, -l2));
        float p1 = ex2(fmaf(s[nt][2 + e], scale_log2, -l2));
        if (ragged) {
          const bool qlive = q0 + c < Sq;
          if (!(qlive && r0 < kv_end)) p0 = 0.f;
          if (!(qlive && r1 < kv_end)) p1 = 0.f;
        }
        s[nt][e] = p0;
        s[nt][2 + e] = p1;
        dp[nt][e] = p0 * (dp[nt][e] - dsum);
        dp[nt][2 + e] = p1 * (dp[nt][2 + e] - dsum);
      }
    }

    // dV += pᵀ·dO and dK += dSᵀ·Q over the 64 query rows of this tile
#pragma unroll
    for (int kc = 0; kc < BM / 16; ++kc) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      da[0] = pack_bf16(dp[2 * kc][0], dp[2 * kc][1]);
      da[1] = pack_bf16(dp[2 * kc][2], dp[2 * kc][3]);
      da[2] = pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]);
      da[3] = pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3]);
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t of[4], qt[4];
        ldsm_x4_trans(of, sdO + (kc * 16 + lr) * SST + p * 16 + lc);
        mma_16816(dva[2 * p], pa, of[0], of[1]);
        mma_16816(dva[2 * p + 1], pa, of[2], of[3]);
        ldsm_x4_trans(qt, sQ + (kc * 16 + lr) * SST + p * 16 + lc);
        mma_16816(dka[2 * p], da, qt[0], qt[1]);
        mma_16816(dka[2 * p + 1], da, qt[2], qt[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles from now
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t4 * 2;
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
// D = 64, dQ pass: one CTA per (b·h, 64 query rows), 4 warps of 16 query
// rows; key/value tiles of 64 rows double-buffered with cp.async.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(B64_THREADS)
    flash_bwd_d64_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ dd,
                            bf16* __restrict__ dq, int H, int Sq, int kv_end, BwdStrides st,
                            float scale, float scale_log2) {
  constexpr int BM = B64_BM, BN = B64_BN, SST = B64_SST, D = 64, NT = B64_THREADS;
  extern __shared__ __align__(16) unsigned char smem_dq[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_dq);
  bf16* sdO = sQ + BM * SST;
  bf16* sKV = sdO + BM * SST;  // buffer i: K at sKV + 2i·BN·SST, V right after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;
  const bf16* qb = q + b * st.q_b + h * st.q_h;
  const bf16* kb = k + b * st.k_b + h * st.k_h;
  const bf16* vb = v + b * st.v_b + h * st.v_h;
  const bf16* dob = dout + b * st.do_b + h * st.do_h;
  bf16* dqb = dq + b * st.dq_b + h * st.dq_h;
  const int n_tiles = (kv_end + BN - 1) / BN;

  cp_tile_d64<BM, SST, NT>(sQ, qb, st.q_s, q0, Sq);
  cp_tile_d64<BM, SST, NT>(sdO, dob, st.do_s, q0, Sq);
  cp_tile_d64<BN, SST, NT>(sKV, kb, st.k_s, 0, kv_end);
  cp_tile_d64<BN, SST, NT>(sKV + BN * SST, vb, st.v_s, 0, kv_end);
  cp_async_commit();

  const int lr = lm_row(lane), lc = lm_col(lane);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;  // this thread's query rows
  const long long stat0 = static_cast<long long>(blockIdx.y) * Sq;
  const float l2_0 = row0 < Sq ? lse[stat0 + row0] * LOG2E : 0.f;
  const float l2_1 = row1 < Sq ? lse[stat0 + row1] * LOG2E : 0.f;
  const float dd0 = row0 < Sq ? dd[stat0 + row0] : 0.f;
  const float dd1 = row1 < Sq ? dd[stat0 + row1] : 0.f;

  uint32_t qf[D / 16][4], df[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      bf16* nk = sKV + ((j + 1) & 1) * 2 * BN * SST;
      cp_tile_d64<BN, SST, NT>(nk, kb, st.k_s, (j + 1) * BN, kv_end);
      cp_tile_d64<BN, SST, NT>(nk + BN * SST, vb, st.v_s, (j + 1) * BN, kv_end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        ldsm_x4(qf[kc], sQ + (warp * 16 + lr) * SST + kc * 16 + lc);
        ldsm_x4(df[kc], sdO + (warp * 16 + lr) * SST + kc * 16 + lc);
      }
    }
    const bf16* sK = sKV + (j & 1) * 2 * BN * SST;
    const bf16* sV = sK + BN * SST;
    const int kv0 = j * BN;

    // S = Q·Kᵀ and dP = dO·Vᵀ for this warp's 16 query rows × 64 key columns
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int p = 0; p < D / 32; ++p) {
        uint32_t kt[4], vt[4];
        ldsm_x4(kt, sK + (nt * 8 + (lane & 7)) * SST + p * 32 + (lane >> 3) * 8);
        mma_16816(s[nt], qf[2 * p], kt[0], kt[1]);
        mma_16816(s[nt], qf[2 * p + 1], kt[2], kt[3]);
        ldsm_x4(vt, sV + (nt * 8 + (lane & 7)) * SST + p * 32 + (lane >> 3) * 8);
        mma_16816(dp[nt], df[2 * p], vt[0], vt[1]);
        mma_16816(dp[nt], df[2 * p + 1], vt[2], vt[3]);
      }
    }

    // p = exp2(s·scale·log2e − lse·log2e); dS = p ∘ (dP − D)
    const bool ragged = kv0 + BN > kv_end;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = ex2(fmaf(s[nt][e], scale_log2, -l2_0));
        float p1 = ex2(fmaf(s[nt][2 + e], scale_log2, -l2_1));
        if (ragged && kv0 + nt * 8 + t4 * 2 + e >= kv_end) p0 = p1 = 0.f;
        dp[nt][e] = p0 * (dp[nt][e] - dd0);
        dp[nt][2 + e] = p1 * (dp[nt][2 + e] - dd1);
      }
    }

    // dQ += dS·K over the 64 keys of this tile
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(dp[2 * kc][0], dp[2 * kc][1]);
      a[1] = pack_bf16(dp[2 * kc][2], dp[2 * kc][3]);
      a[2] = pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]);
      a[3] = pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3]);
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t kt[4];
        ldsm_x4_trans(kt, sK + (kc * 16 + lr) * SST + p * 16 + lc);
        mma_16816(acc[2 * p], a, kt[0], kt[1]);
        mma_16816(acc[2 * p + 1], a, kt[2], kt[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles from now
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(dqb + row0 * st.dq_s + col) = pack_bf16(acc[dt][0] * scale, acc[dt][1] * scale);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(dqb + row1 * st.dq_s + col) = pack_bf16(acc[dt][2] * scale, acc[dt][3] * scale);
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
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, B64_DKV_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  dim3 grid((Skv + B64_BN - 1) / B64_BN, B * H);
  flash_bwd_d64_dkv_kernel<<<grid, B64_THREADS, B64_DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Skv, kv_end, make_strides(strides), scale,
      scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

int flash_bwd_d64_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                     const void* dd, void* dq, int B, int H, int Sq, int kv_end,
                     const long long* strides, float scale, void* stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_d64_dq_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, B64_DQ_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  dim3 grid((Sq + B64_BM - 1) / B64_BM, B * H);
  flash_bwd_d64_dq_kernel<<<grid, B64_THREADS, B64_DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<bf16*>(dq), H, Sq, kv_end, make_strides(strides), scale, scale * LOG2E);
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
