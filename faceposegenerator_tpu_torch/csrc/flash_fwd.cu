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
// ridge: they are bound by the tensor cores (and, at D = 64, by the exp of every
// score on the special-function units, which costs about as much). The
// 77-token cross-attention reads q and writes o once for few FLOPs: it is
// bound by bytes, and the small levels (64 and 256 query tokens) by launches.
//
// What the design does about it (wgmma/TMA and warp specialisation are later work):
//   * Scores and P·V run on the tensor cores with mma.sync m16n8k16
//     bf16 → fp32. The S tile never leaves registers at D = 64 (the register
//     fragment of S is re-packed in place as the A operand of P·V), so the
//     O(S²) score matrix is never written to memory.
//   * D = 64: 128 query rows per CTA, so each K/V tile fetched from L2 serves
//     8 warps; K/V tiles are double-buffered with cp.async, so the next tile
//     loads while this one's MMAs run; operands come by ldmatrix from padded
//     shared-memory rows (no bank conflicts).
//   * exp is exp2 of a score pre-multiplied by scale·log2(e): one FMA and one
//     MUFU op per score.
//   * The TPU kernel's head-pair lane packing and ones-column MXU row sum are
//     not carried over: Hopper's MMA tile is 16×8×16, so D = 64 is native and
//     an odd head count needs no zero head.
//   * D = 512: a 64×512 fp32 O tile does not fit in registers, so the wide
//     kernel uses 32-row Q and K/V tiles in shared memory (~105 KB of dynamic
//     shared memory) and splits the O accumulator by D-columns over 8 warps
//     (64 fp32 registers per thread); scores go through a 32×32 tile in
//     shared memory.
//   * Loop bounds stop at kv_end, so masked tiles are never loaded; the
//     ragged last tile is zero-filled and its columns masked to -inf before
//     the row max.
//   * For training both kernels also write each row's log-sum-exp (natural
//     log, scaled logits; `save_lse` in the JAX package) when given a
//     buffer for it: one fp32 per query row, from the statistics they keep
//     anyway. flash_bwd.cu recomputes the normalised p from it.
//
// Plain C interface, loaded with ctypes. Every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "flash_common.cuh"

namespace {

struct Strides {
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

// ---------------------------------------------------------------------------
// D = 64: one CTA per (b·h, 128-row Q tile), 8 warps of 16 Q rows each. K/V
// tiles of 64 rows are double-buffered in shared memory with cp.async (the
// next tile loads while the MMAs run on this one); every MMA operand comes
// from shared memory by ldmatrix (.trans for V).
// ---------------------------------------------------------------------------

constexpr int D64_BM = 128, D64_BN = 64, D64_SST = 64 + 8, D64_THREADS = 256;
// Q tile + two (K, V) tile pairs
constexpr int D64_SMEM = (D64_BM + 4 * D64_BN) * D64_SST * static_cast<int>(sizeof(bf16));

__global__ void __launch_bounds__(D64_THREADS, 2)
    flash_fwd_d64_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int H, int Sq, int kv_end, Strides st,
                         float scale_log2) {
  constexpr int BM = D64_BM, BN = D64_BN, SST = D64_SST, D = 64;
  extern __shared__ __align__(16) unsigned char smem_d64[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_d64);
  bf16* sKV = sQ + BM * SST;  // buffer i: K at sKV + 2i·BN·SST, V right after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;
  const bf16* qb = q + b * st.q_b + h * st.q_h;
  const bf16* kb = k + b * st.k_b + h * st.k_h;
  const bf16* vb = v + b * st.v_b + h * st.v_h;
  bf16* ob = o + b * st.o_b + h * st.o_h;
  const int n_tiles = (kv_end + BN - 1) / BN;

  cp_tile_d64<BM, SST, D64_THREADS>(sQ, qb, st.q_s, q0, Sq);
  cp_tile_d64<BN, SST, D64_THREADS>(sKV, kb, st.k_s, 0, kv_end);
  cp_tile_d64<BN, SST, D64_THREADS>(sKV + BN * SST, vb, st.v_s, 0, kv_end);
  cp_async_commit();

  // ldmatrix lane → row/column offsets within a 16×16 operand block
  const int lm_row = (lane & 7) + ((lane >> 3) & 1) * 8;  // A (Q) and V (.trans)
  const int lm_col = (lane >> 4) * 8;
  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {  // prefetch the next K/V tile into the other buffer
      bf16* nk = sKV + ((j + 1) & 1) * 2 * BN * SST;
      cp_tile_d64<BN, SST, D64_THREADS>(nk, kb, st.k_s, (j + 1) * BN, kv_end);
      cp_tile_d64<BN, SST, D64_THREADS>(nk + BN * SST, vb, st.v_s, (j + 1) * BN, kv_end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        ldsm_x4(qf[kc], sQ + (warp * 16 + lm_row) * SST + kc * 16 + lm_col);
    }
    const bf16* sK = sKV + (j & 1) * 2 * BN * SST;
    const bf16* sV = sK + BN * SST;
    const int kv0 = j * BN;

    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int p = 0; p < D / 32; ++p) {  // 4 8×8 blocks: k columns p·32 .. p·32+31
        uint32_t kf[4];
        ldsm_x4(kf, sK + (nt * 8 + (lane & 7)) * SST + p * 32 + (lane >> 3) * 8);
        mma_16816(s[nt], qf[2 * p], kf[0], kf[1]);
        mma_16816(s[nt], qf[2 * p + 1], kf[2], kf[3]);
      }
    }

    // Statistics stay in raw-score units (scale > 0 commutes with max); the
    // scale and the max shift fold into one FMA in front of each ex2. Only
    // the tile that holds kv_end needs masking.
    if (kv0 + BN > kv_end) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (kv0 + nt * 8 + t4 * 2 + e >= kv_end) s[nt][e] = s[nt][2 + e] = neg_inf();
        }
      }
    }
    float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float base0 = (mn0 == neg_inf() ? 0.f : mn0) * scale_log2;
    const float base1 = (mn1 == neg_inf() ? 0.f : mn1) * scale_log2;
    const float al0 = ex2(fmaf(m0, scale_log2, -base0)), al1 = ex2(fmaf(m1, scale_log2, -base1));
    m0 = mn0;
    m1 = mn1;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = ex2(fmaf(s[nt][0], scale_log2, -base0));
      s[nt][1] = ex2(fmaf(s[nt][1], scale_log2, -base0));
      s[nt][2] = ex2(fmaf(s[nt][2], scale_log2, -base1));
      s[nt][3] = ex2(fmaf(s[nt][3], scale_log2, -base1));
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * al0 + rs0;  // per-thread partial row sums; summed over the quad at the end
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= al0;
      acc[dt][1] *= al0;
      acc[dt][2] *= al1;
      acc[dt][3] *= al1;
    }

#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[4];  // the score fragment, re-packed as the A operand of P·V
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {  // output column tiles 2p and 2p+1
        uint32_t vf[4];
        ldsm_x4_trans(vf, sV + (kc * 16 + lm_row) * SST + p * 16 + lm_col);
        mma_16816(acc[2 * p], a, vf[0], vf[1]);
        mma_16816(acc[2 * p + 1], a, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles from now
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + row0 * st.o_s + col) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + row1 * st.o_s + col) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
  // natural-log LSE of the scaled logits: the running max is in raw-score
  // units and the sum in the log2 domain of the ex2 above
  if (lse != nullptr && t4 == 0) {
    float* lb = lse + static_cast<long long>(blockIdx.y) * Sq;
    if (row0 < Sq) lb[row0] = (m0 * scale_log2 + log2f(l0)) * LN2;
    if (row1 < Sq) lb[row1] = (m1 * scale_log2 + log2f(l1)) * LN2;
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
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_d64_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, D64_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const Strides st = make_strides(q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h);
  dim3 grid((Sq + D64_BM - 1) / D64_BM, B * H);
  flash_fwd_d64_kernel<<<grid, D64_THREADS, D64_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, Sq, kv_end, st, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
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
