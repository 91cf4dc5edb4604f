// Flash attention in fp32 for Hopper (sm_90a): the fp32 instance of the
// forward kernels (K1, K2) and of the backward kernels (K5, K6), for the
// fp32 compute policy (`StableDiffusionPipeline.from_random()`'s default, the
// parity policy of the train step).
//
//   flash_fwd_f32      softmax(q·kᵀ·scale)·v, keys >= kv_end excluded, and the
//                      natural-log log-sum-exp of each row when asked;
//   flash_bwd_f32_dkv  dK = scale·dSᵀ·Q, dV = Pᵀ·dO;
//   flash_bwd_f32_dq   dQ = scale·dS·K;
// with P = exp(S·scale − lse) recomputed from the forward's LSE and
// dS = P∘(dO·Vᵀ − D), D = rowsum(dO∘O) (computed by the wrapper), as
// `attention_bwd_plain` does. Two passes, no atomics: deterministic.
//
// Replaces faceposegenerator_tpu/ops/flash_attention.py at fp32 operands:
// `_fwd_kernel_packed` (:258) and `_fwd_kernel` (:104) forward,
// `_bwd_kernel_packed_dkv/_dq` (:711, :777) and `_bwd_kernel_plain_dkv/_dq`
// (:542, :585) backward; JAX's `flash_supported` sends fp32 to the same
// kernels as bf16 (flash_attention.py:87-101).
//
// What bounds it on the card. fp32 arithmetic means FFMA on the CUDA cores
// (TF32 tensor cores would round the operands to 10 bits, which the fp32
// policy forbids): 67 TFLOP/s against 989 for bf16 wgmma, so every shape
// with more than ~20 key columns a query row is bound by operations: 4·Sq·Skv·D
// a head forward, 10·Sq·Skv·D backward.
//
// The design is simple and right first (making it fast is later work):
//   * 256 threads as 16 × 16, each owning a 4 × 4 block of a 64 × 64 tile of
//     scores (query rows × keys) and of the outputs;
//   * every product runs over 64-deep chunks of two tiles in shared memory
//     whose reduction dimension is the row index, so a thread reads its four
//     rows and its four columns as two float4 loads (a transposed load puts
//     q, k, v and dO in that layout);
//   * the forward keeps the whole 64-row Q tile in shared memory (D / 64
//     chunks, 128 KB at D = 512), streams K in d-chunks for S and V in
//     column chunks for P·V, and runs the online softmax with the row
//     statistics in registers (a row lives in 16 lanes of one warp). The
//     log-sum-exp is held to 1e-5, ~10 ulps at 4096 keys, so the sums are
//     kept relative to the rounded base b = fl(m · scale · log2 e) of the
//     running max, and a tile rescales them by exactly 2^(b_old − b_new):
//     rescaling by 2^(m_old · scale · log2 e − b_new) instead, as K1 does,
//     multiplies them by 2^(its rounding error) on every tile, a drift
//     past the gate over 64 tiles (chip_smoke.py phase 11; PERF.md).
//   * the backward passes split the head dim into column chunks of at most
//     128 over the grid's z axis, so a thread's dK and dV (or dQ) stay at 32
//     or 64 registers at any D; S and dO·Vᵀ are recomputed for each chunk.
//
// Plain C interface, loaded with ctypes. Every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;    // the rows of every tile and the depth of every product chunk
constexpr int NT = 256;  // 16 × 16 threads
constexpr int TT = T * T;
constexpr float LOG2E_F = 1.4426950408889634f, LN2_F = 0.6931471805599453f;

struct Strides {
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

struct BwdStrides {
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s, do_h, dq_b, dq_s, dq_h, dk_b, dk_s, dk_h,
      dv_b, dv_s, dv_h;
};

__device__ __forceinline__ float neg_inf_f() { return __int_as_float(0xff800000); }

// Rows [row0, row0 + 64) and columns [c0, c0 + 64) of a (rows, D) slice with
// row stride `rs`, transposed into dst[c][r]; rows >= nrows read as 0.
// Consecutive threads take consecutive rows, so the stores are conflict-free.
__device__ __forceinline__ void load_t(float* dst, const float* __restrict__ src, long long rs, int row0, int nrows,
                                       int c0) {
#pragma unroll
  for (int i = 0; i < TT / 4 / NT; ++i) {
    const int idx = threadIdx.x + i * NT, r = idx & (T - 1), c = (idx >> 6) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows) v = *reinterpret_cast<const float4*>(src + (row0 + r) * rs + c0 + c);
    dst[(c + 0) * T + r] = v.x;
    dst[(c + 1) * T + r] = v.y;
    dst[(c + 2) * T + r] = v.z;
    dst[(c + 3) * T + r] = v.w;
  }
}

// Rows [row0, row0 + 64) and columns [c0, c0 + W) row-major into dst[r][c].
template <int W>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, long long rs, int row0, int nrows,
                                          int c0) {
  constexpr int V4 = W / 4;
#pragma unroll
  for (int i = 0; i < T * V4 / NT; ++i) {
    const int idx = threadIdx.x + i * NT, r = idx / V4, c = (idx % V4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows) v = *reinterpret_cast<const float4*>(src + (row0 + r) * rs + c0 + c);
    *reinterpret_cast<float4*>(dst + r * W + c) = v;
  }
}

// acc[i][j] += Σ_{d < 64} a[d·as + a0 + i] · b[d·bs + b0 + j]
__device__ __forceinline__ void mm(float (&acc)[4][4], const float* a, int as, int a0, const float* b, int bs,
                                   int b0) {
#pragma unroll 8
  for (int d = 0; d < T; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(a + d * as + a0);
    const float4 y = *reinterpret_cast<const float4*>(b + d * bs + b0);
    const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// the 16 lanes of one row group (tx = lane % 16)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// forward: one CTA per (64 query rows, b·h); thread (ty, tx) owns rows
// 4ty..4ty+3 and, of every 64-wide chunk of S or O, columns 4tx..4tx+3.
// ---------------------------------------------------------------------------

template <int D>
struct Fwd {
  static constexpr int DC = D / T;
  static constexpr int SMEM = (DC * TT + 3 * TT) * 4;  // Q (all chunks), a K chunk, a V chunk, P
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         float* __restrict__ o, float* __restrict__ lse, int H, int Sq, int kv_end, Strides st,
                         float scale_log2) {
  constexpr int DC = Fwd<D>::DC;
  extern __shared__ float4 smem_f4[];
  float* sQ = reinterpret_cast<float*>(smem_f4);  // [DC][64 d][64 q]
  float* sK = sQ + DC * TT;                       // [64 d][64 k]
  float* sV = sK + TT;                            // [64 k][64 c]
  float* sP = sV + TT;                            // [64 k][64 q]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * T;
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;

#pragma unroll
  for (int dc = 0; dc < DC; ++dc) load_t(sQ + dc * TT, qb, st.q_s, q0, Sq, dc * T);

  float acc[DC][4][4];
#pragma unroll
  for (int dc = 0; dc < DC; ++dc) zero(acc[dc]);
  float m[4], mb[4], l[4];  // running max (raw-score units), its base b (log2 units), row sum relative to b
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg_inf_f();
    mb[i] = l[i] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += T) {
    float s[4][4];
    zero(s);
#pragma unroll 1
    for (int dc = 0; dc < DC; ++dc) {
      __syncthreads();  // the previous chunk's K (and, at dc 0, Q) are in place or read
      load_t(sK, kb, st.k_s, k0, kv_end, dc * T);
      __syncthreads();
      mm(s, sQ + dc * TT, T, 4 * ty, sK, T, 4 * tx);
    }
    // online softmax in raw-score units; scale and max shift fold into one FMA
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + 4 * tx + j >= kv_end) s[0][j] = s[1][j] = s[2][j] = s[3][j] = neg_inf_f();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mn = fmaxf(m[i], row_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]))));
      const float base = (mn == neg_inf_f() ? 0.f : mn) * scale_log2;
      const float alpha = m[i] == neg_inf_f() ? 0.f : exp2f(mb[i] - base);  // 1 exactly while the max holds
      m[i] = mn;
      mb[i] = base;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(fmaf(s[i][j], scale_log2, -base));
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + rs;  // this thread's partial row sum
#pragma unroll
      for (int dc = 0; dc < DC; ++dc)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[dc][i][j] *= alpha;
    }
    // P into shared memory, key-major: the P·V product reduces over keys
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sP + (4 * tx + j) * T + 4 * ty) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
#pragma unroll  // acc[dc] must stay in registers: no runtime index into it
    for (int dc = 0; dc < DC; ++dc) {
      __syncthreads();  // P written; the previous V chunk read
      load_rows<T>(sV, vb, st.v_s, k0, kv_end, dc * T);
      __syncthreads();
      mm(acc[dc], sP, T, 4 * ty, sV, T, 4 * tx);
    }
  }

  float* ob = o + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = row_sum(l[i]);
    const int row = q0 + 4 * ty + i;
    if (row < Sq) {
#pragma unroll
      for (int dc = 0; dc < DC; ++dc)
        *reinterpret_cast<float4*>(ob + row * st.o_s + dc * T + 4 * tx) =
            make_float4(acc[dc][i][0] / li, acc[dc][i][1] / li, acc[dc][i][2] / li, acc[dc][i][3] / li);
      // natural-log LSE of the scaled logits: l sums 2^(s · scale · log2 e − b)
      if (lse != nullptr && tx == 0)
        lse[static_cast<long long>(blockIdx.y) * Sq + row] = fmaf(mb[i], LN2_F, logf(li));
    }
  }
}

// ---------------------------------------------------------------------------
// backward: S and dP = dO·Vᵀ of a 64 × 64 (query, key) tile over d-chunks,
// then P = exp(S·scale − lse) and dS = P∘(dP − D), masked to 0 at rows >= Sq
// and keys >= kv_end. Thread (ty, tx) holds query rows 4ty.. and keys 4tx..
// ---------------------------------------------------------------------------

constexpr int COLS_MAX = 128;  // head-dim columns of dK, dV or dQ per CTA

__device__ __forceinline__ void p_ds(float (&s)[4][4], float (&dp)[4][4], const float* __restrict__ lse_bh,
                                     const float* __restrict__ dd_bh, int q0, int Sq, int k0, int kv_end,
                                     float scale_log2, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    const float lse2 = row < Sq ? lse_bh[row] * LOG2E_F : 0.f, ddr = row < Sq ? dd_bh[row] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool live = row < Sq && k0 + 4 * tx + j < kv_end;
      const float p = live ? exp2f(fmaf(s[i][j], scale_log2, -lse2)) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - ddr);
    }
  }
}

// S and dP of query tile q0 and key tile k0 over the D / 64 d-chunks
template <int D>
__device__ __forceinline__ void scores_bwd(float (&s)[4][4], float (&dp)[4][4], float* sQt, float* sOt, float* sKt,
                                           float* sVt, const float* qb, const float* dob, const float* kb,
                                           const float* vb, const BwdStrides& st, int q0, int Sq, int k0,
                                           int kv_end, int tx, int ty) {
  zero(s);
  zero(dp);
#pragma unroll 1
  for (int dc = 0; dc < D / T; ++dc) {
    __syncthreads();
    load_t(sQt, qb, st.q_s, q0, Sq, dc * T);
    load_t(sOt, dob, st.do_s, q0, Sq, dc * T);
    load_t(sKt, kb, st.k_s, k0, kv_end, dc * T);
    load_t(sVt, vb, st.v_s, k0, kv_end, dc * T);
    __syncthreads();
    mm(s, sQt, T, 4 * ty, sKt, T, 4 * tx);
    mm(dp, sOt, T, 4 * ty, sVt, T, 4 * tx);
  }
}

template <int D>
struct Bwd {
  static constexpr int COLS = D < COLS_MAX ? D : COLS_MAX, NJ = COLS / T;
  // four transposed d-chunks, two 64 × 64 score tiles, two 64 × COLS row tiles
  static constexpr int SMEM = (4 * TT + 2 * TT + 2 * T * COLS) * 4;
};

// one CTA per (64 keys, b·h, column chunk); thread (ty, tx) accumulates keys
// 4ty.. and columns 4tx.. of each 64-wide part of the chunk
template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_f32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                             const float* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ dd, float* __restrict__ dk, float* __restrict__ dv, int H,
                             int Sq, int Skv, int kv_end, BwdStrides st, float scale, float scale_log2) {
  using C = Bwd<D>;
  constexpr int COLS = C::COLS, NJ = C::NJ;
  extern __shared__ float4 smem_f4[];
  float* sQt = reinterpret_cast<float*>(smem_f4);
  float* sOt = sQt + TT;
  float* sKt = sOt + TT;
  float* sVt = sKt + TT;
  float* sP = sVt + TT;   // [64 q][64 k]
  float* sdS = sP + TT;   // [64 q][64 k]
  float* sQr = sdS + TT;  // [64 q][COLS]
  float* sOr = sQr + T * COLS;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H, k0 = blockIdx.x * T, c0 = blockIdx.z * COLS;
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;
  const float* dob = dout + b * st.do_b + h * st.do_h;
  const float* lse_bh = lse + static_cast<long long>(blockIdx.y) * Sq;
  const float* dd_bh = dd + static_cast<long long>(blockIdx.y) * Sq;

  float acc_k[NJ][4][4], acc_v[NJ][4][4];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    zero(acc_k[jj]);
    zero(acc_v[jj]);
  }
  for (int q0 = 0; q0 < Sq; q0 += T) {
    float s[4][4], dp[4][4];
    scores_bwd<D>(s, dp, sQt, sOt, sKt, sVt, qb, dob, kb, vb, st, q0, Sq, k0, kv_end, tx, ty);
    p_ds(s, dp, lse_bh, dd_bh, q0, Sq, k0, kv_end, scale_log2, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(sP + (4 * ty + i) * T + 4 * tx) = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(sdS + (4 * ty + i) * T + 4 * tx) =
          make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
    }
    load_rows<COLS>(sQr, qb, st.q_s, q0, Sq, c0);
    load_rows<COLS>(sOr, dob, st.do_s, q0, Sq, c0);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      mm(acc_v[jj], sP, T, 4 * ty, sOr + jj * T, COLS, 4 * tx);
      mm(acc_k[jj], sdS, T, 4 * ty, sQr + jj * T, COLS, 4 * tx);
    }
  }
  float* dkb = dk + b * st.dk_b + h * st.dk_h;
  float* dvb = dv + b * st.dv_b + h * st.dv_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= Skv) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = c0 + jj * T + 4 * tx;
      *reinterpret_cast<float4*>(dkb + key * st.dk_s + col) = make_float4(
          acc_k[jj][i][0] * scale, acc_k[jj][i][1] * scale, acc_k[jj][i][2] * scale, acc_k[jj][i][3] * scale);
      *reinterpret_cast<float4*>(dvb + key * st.dv_s + col) =
          make_float4(acc_v[jj][i][0], acc_v[jj][i][1], acc_v[jj][i][2], acc_v[jj][i][3]);
    }
  }
}

// one CTA per (64 query rows, b·h, column chunk); dS goes to shared memory
// key-major, since dQ reduces over keys
template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                            const float* __restrict__ dout, const float* __restrict__ lse,
                            const float* __restrict__ dd, float* __restrict__ dq, int H, int Sq, int kv_end,
                            BwdStrides st, float scale, float scale_log2) {
  using C = Bwd<D>;
  constexpr int COLS = C::COLS, NJ = C::NJ;
  extern __shared__ float4 smem_f4[];
  float* sQt = reinterpret_cast<float*>(smem_f4);
  float* sOt = sQt + TT;
  float* sKt = sOt + TT;
  float* sVt = sKt + TT;
  float* sdSt = sVt + TT;       // [64 k][64 q]
  float* sKr = sdSt + 2 * TT;   // [64 k][COLS]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * T, c0 = blockIdx.z * COLS;
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;
  const float* dob = dout + b * st.do_b + h * st.do_h;
  const float* lse_bh = lse + static_cast<long long>(blockIdx.y) * Sq;
  const float* dd_bh = dd + static_cast<long long>(blockIdx.y) * Sq;

  float acc[NJ][4][4];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) zero(acc[jj]);
  for (int k0 = 0; k0 < kv_end; k0 += T) {
    float s[4][4], dp[4][4];
    scores_bwd<D>(s, dp, sQt, sOt, sKt, sVt, qb, dob, kb, vb, st, q0, Sq, k0, kv_end, tx, ty);
    p_ds(s, dp, lse_bh, dd_bh, q0, Sq, k0, kv_end, scale_log2, tx, ty);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sdSt + (4 * tx + j) * T + 4 * ty) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    load_rows<COLS>(sKr, kb, st.k_s, k0, kv_end, c0);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) mm(acc[jj], sdSt, T, 4 * ty, sKr + jj * T, COLS, 4 * tx);
  }
  float* dqb = dq + b * st.dq_b + h * st.dq_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      *reinterpret_cast<float4*>(dqb + row * st.dq_s + c0 + jj * T + 4 * tx) = make_float4(
          acc[jj][i][0] * scale, acc[jj][i][1] * scale, acc[jj][i][2] * scale, acc[jj][i][3] * scale);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int B, int H, int Sq,
               int kv_end, const Strides& st, float scale, cudaStream_t stream) {
  cudaError_t err = set_smem(flash_fwd_f32_kernel<D>, Fwd<D>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + T - 1) / T, B * H);
  flash_fwd_f32_kernel<D><<<grid, NT, Fwd<D>::SMEM, stream>>>(q, k, v, o, lse, H, Sq, kv_end, st, scale * LOG2E_F);
  return static_cast<int>(cudaGetLastError());
}

BwdStrides make_bwd_strides(const long long* s) {
  BwdStrides st;
  long long* dst = &st.q_b;
  for (int i = 0; i < 21; ++i) dst[i] = s[i];
  return st;
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* dd,
               void* dk, void* dv, int B, int H, int Sq, int Skv, int kv_end, const BwdStrides& st, float scale,
               cudaStream_t stream) {
  cudaError_t err = set_smem(flash_bwd_f32_dkv_kernel<D>, Bwd<D>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Skv + T - 1) / T, B * H, D / Bwd<D>::COLS);
  flash_bwd_f32_dkv_kernel<D><<<grid, NT, Bwd<D>::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Skv, kv_end, st, scale, scale * LOG2E_F);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* dd,
              void* dq, int B, int H, int Sq, int kv_end, const BwdStrides& st, float scale, cudaStream_t stream) {
  cudaError_t err = set_smem(flash_bwd_f32_dq_kernel<D>, Bwd<D>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + T - 1) / T, B * H, D / Bwd<D>::COLS);
  flash_bwd_f32_dq_kernel<D><<<grid, NT, Bwd<D>::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<float*>(dq), H, Sq, kv_end, st, scale, scale * LOG2E_F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (B, Sq, H, D), k/v: (B, Skv, H, D), o: (B, Sq, H, D), fp32, D in {64,
// 128, 256, 384, 512}; strides in elements, head dim contiguous, rows 16-byte
// aligned; keys [kv_end, Skv) are excluded. lse: null, or (B, H, Sq) fp32
// contiguous, which receives each row's natural-log log-sum-exp.
int flash_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Sq, int kv_end,
                  int D, int q_b, int q_s, int q_h, int k_b, int k_s, int k_h, int v_b, int v_s, int v_h, int o_b,
                  int o_s, int o_h, float scale, void* stream) {
  const Strides st = {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h};
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(o);
  float* ll = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_fwd<64>(qq, kk, vv, oo, ll, B, H, Sq, kv_end, st, scale, s);
    case 128: return launch_fwd<128>(qq, kk, vv, oo, ll, B, H, Sq, kv_end, st, scale, s);
    case 256: return launch_fwd<256>(qq, kk, vv, oo, ll, B, H, Sq, kv_end, st, scale, s);
    case 384: return launch_fwd<384>(qq, kk, vv, oo, ll, B, H, Sq, kv_end, st, scale, s);
    case 512: return launch_fwd<512>(qq, kk, vv, oo, ll, B, H, Sq, kv_end, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward passes on the forward's lse and dd = rowsum(dO ∘ O), both
// (B, H, Sq) fp32 contiguous; dout, dq: (B, Sq, H, D), dk/dv: (B, Skv, H, D)
// fp32. strides: 21 values in elements, (b, s, h) of q, k, v, dout, dq, dk,
// dv in that order. Keys [kv_end, Skv) get zero dk and dv.
int flash_bwd_f32_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* dd,
                      void* dk, void* dv, int B, int H, int Sq, int Skv, int kv_end, int D, const long long* strides,
                      float scale, void* stream) {
  const BwdStrides st = make_bwd_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_dkv<64>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Skv, kv_end, st, scale, s);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Skv, kv_end, st, scale, s);
    case 256: return launch_dkv<256>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Skv, kv_end, st, scale, s);
    case 384: return launch_dkv<384>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Skv, kv_end, st, scale, s);
    case 512: return launch_dkv<512>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Skv, kv_end, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_bwd_f32_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* dd,
                     void* dq, int B, int H, int Sq, int kv_end, int D, const long long* strides, float scale,
                     void* stream) {
  const BwdStrides st = make_bwd_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_dq<64>(q, k, v, dout, lse, dd, dq, B, H, Sq, kv_end, st, scale, s);
    case 128: return launch_dq<128>(q, k, v, dout, lse, dd, dq, B, H, Sq, kv_end, st, scale, s);
    case 256: return launch_dq<256>(q, k, v, dout, lse, dd, dq, B, H, Sq, kv_end, st, scale, s);
    case 384: return launch_dq<384>(q, k, v, dout, lse, dd, dq, B, H, Sq, kv_end, st, scale, s);
    case 512: return launch_dq<512>(q, k, v, dout, lse, dd, dq, B, H, Sq, kv_end, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
