// K8: int8 attention for Hopper (sm_90a), head dim 64, inference only.
//
// Replaces faceposegenerator_tpu/ops/flash_attention.py
// `_fwd_kernel_packed_int8` (reached through `flash_attention_int8`). Inputs
// are the int8 codes of q, k and v under per-tensor scales, made by a few torch
// ops in the wrapper as XLA makes them in JAX, and two fp32 constants:
// c_qk = sq·sk·softmax_scale and c_v = sv·fl(1/127). Per query row:
//
//   s  = float(q8·k8ᵀ) · c_qk,  keys >= kv_end masked
//   m  = max of s over the live keys
//   p  = exp(s − m),  p8 = trunc(p·127 + 0.5),  l = Σ p
//   o  = float(Σ p8·v8) · c_v / l
//
// p is quantized against the row's full max, as the TPU kernel does with its
// single 4096-key block: an online softmax over 64-key tiles would quantize
// against a running max and compute another function. So the kernel sweeps
// the keys twice: the first sweep finds the integer row max of q8·k8ᵀ
// (float(·)·c_qk is monotone, so its max is the max of s), the second
// recomputes the scores and accumulates l and P·V. exp is expf (not the ex2
// of K1), and every product and sum that feeds a rounding step is written with
// an _rn intrinsic, so no multiply-add is contracted: the kernel computes what
// attention_int8_plain computes.
//
// What bounds it on the card: 4·Sq·Skv·64 int8 tensor-core operations per
// head (twice Sq·Skv·64 for the second QKᵀ sweep) and one expf per score,
// against ~Sq·64 + 2·Skv·64 bytes of codes and 2·Sq·64 of output: at the
// 4096-token self-attention the exps on the FP32 pipes and the tensor cores
// bound it, at the 77-key cross-attention the bytes and the launch.
//
// The output is q's dtype: bf16 (`flash_int8`) or fp32 (`flash_int8_f32`,
// as JAX's `flash_attention_int8` passes q.dtype through); the codes, the
// kernel and every rounding before the last are the same.
//
// Design: one CTA per (b·h, 128 query rows), 8 warps of 16 rows; 64-key tiles
// double-buffered with cp.async; mma.sync m16n8k32 s8·s8 → s32 for both
// products. The score fragment of an m16n8 tile holds keys 2t..2t+1 and
// 8+2t..8+2t+1 of each 16 in a thread's registers; it becomes the A operand
// of P·V as it is, with its key order permuted within each 32 keys, and the
// wrapper writes V's codes transposed, (B, H, 64, Skv padded to 64), in that
// same permuted key order (ldmatrix.trans exists only for 16-bit elements).
//
// Plain C interface, loaded with ctypes: launches on the given stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128, BN = 64, D = 64, NTHREADS = 256;
constexpr int ST = 64 + 16;  // shared row stride, bytes (conflict-free ldmatrix)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + ROWS) of a (rows, 64) int8 slice with row stride `stride`
// (bytes) into shared memory; rows >= nrows are zero-filled
template <int ROWS>
__device__ __forceinline__ void cp_rows(unsigned char* dst, const int8_t* src, long long stride, int row0,
                                        int nrows) {
  for (int c = threadIdx.x; c < ROWS * 4; c += NTHREADS) {
    const int r = c >> 2, cc = (c & 3) * 16, row = row0 + r;
    const bool live = row < nrows;
    cp_async_16(dst + r * ST + cc, live ? src + row * stride + cc : src, live ? 16 : 0);
  }
}

// the 16×64 score tile of one warp over keys [kv0, kv0 + 64): s[nt] holds
// rows g, g+8 and keys nt·8 + 2t4, +1
__device__ __forceinline__ void scores(int (&s)[8][4], const uint32_t (&qf)[2][4], const unsigned char* sK,
                                       int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    uint32_t kf[4];
    ldsm_x4(kf, sK + (nt * 8 + (lane & 7)) * ST + (lane >> 3) * 16);
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0;
    mma_s8(s[nt], qf[0], kf[0], kf[1]);
    mma_s8(s[nt], qf[1], kf[2], kf[3]);
  }
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }

template <typename OutT>
__global__ void __launch_bounds__(NTHREADS)
    flash_int8_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8, const int8_t* __restrict__ vt8,
                      OutT* __restrict__ o, const float* __restrict__ scalars, int H, int Sq, int Skv, int kv_end) {
  __shared__ __align__(16) unsigned char sQ[BM * ST];
  __shared__ __align__(16) unsigned char sK[2][BN * ST];
  __shared__ __align__(16) unsigned char sV[2][D * ST];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;
  const int skv_p = (Skv + BN - 1) / BN * BN;
  const long long row_stride = static_cast<long long>(H) * D;  // q8/k8: (B, S, H, 64)
  const int8_t* qb = q8 + (static_cast<long long>(b) * Sq * H + h) * D;
  const int8_t* kb = k8 + (static_cast<long long>(b) * Skv * H + h) * D;
  const int8_t* vb = vt8 + static_cast<long long>(blockIdx.y) * D * skv_p;  // (B·H, 64, skv_p)
  const float c_qk = scalars[0], c_v = scalars[1];
  const int n_tiles = (kv_end + BN - 1) / BN;
  const int lm_row = (lane & 7) + ((lane >> 3) & 1) * 8, lm_col = (lane >> 4) * 16;

  // sweep 1: the integer row max of q8·k8ᵀ over the live keys
  cp_rows<BM>(sQ, qb, row_stride, q0, Sq);
  cp_rows<BN>(sK[0], kb, row_stride, 0, kv_end);
  cp_async_commit();
  uint32_t qf[2][4];
  int mx0 = INT32_MIN, mx1 = INT32_MIN;
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      cp_rows<BN>(sK[(j + 1) & 1], kb, row_stride, (j + 1) * BN, kv_end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
      ldsm_x4(qf[0], sQ + (warp * 16 + lm_row) * ST + lm_col);
      ldsm_x4(qf[1], sQ + (warp * 16 + lm_row) * ST + 32 + lm_col);
    }
    int s[8][4];
    scores(s, qf, sK[j & 1], lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (j * BN + nt * 8 + 2 * t4 + e < kv_end) {
          mx0 = max(mx0, s[nt][e]);
          mx1 = max(mx1, s[nt][2 + e]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two tiles from now
  }
  mx0 = max(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = max(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = max(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = max(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float m0 = __fmul_rn(static_cast<float>(mx0), c_qk), m1 = __fmul_rn(static_cast<float>(mx1), c_qk);

  // sweep 2: p, p8, l and P·V
  auto load_kv = [&](int j, int buf) {
    cp_rows<BN>(sK[buf], kb, row_stride, j * BN, kv_end);
    for (int c = threadIdx.x; c < D * 4; c += NTHREADS) {  // 64 rows (d) × 64 keys of vᵀ
      const int r = c >> 2, cc = (c & 3) * 16;
      cp_async_16(sV[buf] + r * ST + cc, vb + static_cast<long long>(r) * skv_p + j * BN + cc, 16);
    }
    cp_async_commit();
  };
  load_kv(0, 0);
  int acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
  float l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_kv(j + 1, (j + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int s[8][4];
    scores(s, qf, sK[j & 1], lane);
    uint32_t p8[8][2];  // per key tile nt: row g's two codes (low bytes), row g+8's
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t c[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = j * BN + nt * 8 + 2 * t4 + (e & 1) < kv_end;
        const float p = live ? expf(__fsub_rn(__fmul_rn(static_cast<float>(s[nt][e]), c_qk), e < 2 ? m0 : m1)) : 0.f;
        if (e < 2) l0 = __fadd_rn(l0, p); else l1 = __fadd_rn(l1, p);
        c[e] = static_cast<uint32_t>(static_cast<int>(__fadd_rn(__fmul_rn(p, 127.f), 0.5f)));
      }
      p8[nt][0] = c[0] | (c[1] << 8);
      p8[nt][1] = c[2] | (c[3] << 8);
    }
    uint32_t a[2][4];  // per 32 keys (score tiles 4kc .. 4kc+3), the A operand of P·V
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      a[kc][0] = p8[4 * kc][0] | (p8[4 * kc + 1][0] << 16);
      a[kc][1] = p8[4 * kc][1] | (p8[4 * kc + 1][1] << 16);
      a[kc][2] = p8[4 * kc + 2][0] | (p8[4 * kc + 3][0] << 16);
      a[kc][3] = p8[4 * kc + 2][1] | (p8[4 * kc + 3][1] << 16);
    }
    const unsigned char* tV = sV[j & 1];
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      uint32_t vf[4];  // b0, b1 of keys 0..31 of this tile, then of keys 32..63
      ldsm_x4(vf, tV + (dt * 8 + (lane & 7)) * ST + (lane >> 3) * 16);
      mma_s8(acc[dt], a[0], vf[0], vf[1]);
      mma_s8(acc[dt], a[1], vf[2], vf[3]);
    }
    __syncthreads();
  }

  l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, 1));
  l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, 2));
  l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, 1));
  l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, 2));
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  OutT* ob = o + (static_cast<long long>(b) * Sq * H + h) * D;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = dt * 8 + 2 * t4;
    if (row0 < Sq)
      store2(ob + row0 * row_stride + col, __fdiv_rn(__fmul_rn(static_cast<float>(acc[dt][0]), c_v), l0),
             __fdiv_rn(__fmul_rn(static_cast<float>(acc[dt][1]), c_v), l0));
    if (row1 < Sq)
      store2(ob + row1 * row_stride + col, __fdiv_rn(__fmul_rn(static_cast<float>(acc[dt][2]), c_v), l1),
             __fdiv_rn(__fmul_rn(static_cast<float>(acc[dt][3]), c_v), l1));
  }
}

template <typename OutT>
int launch(const void* q8, const void* k8, const void* vt8, void* o, const void* scalars, int B, int H, int Sq,
           int Skv, int kv_end, void* stream) {
  const dim3 grid((Sq + BM - 1) / BM, B * H);
  flash_int8_kernel<OutT><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8), static_cast<const int8_t*>(vt8),
      static_cast<OutT*>(o), static_cast<const float*>(scalars), H, Sq, Skv, kv_end);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q8: (B, Sq, H, 64) int8, k8: (B, Skv, H, 64) int8, both contiguous; vt8:
// (B, H, 64, Skv rounded up to 64) int8, contiguous, keys permuted within each
// 32 as the header says; o: (B, Sq, H, 64) bf16 contiguous; scalars: fp32
// {c_qk, c_v} on the device. Keys [kv_end, Skv) are excluded.
int flash_int8(const void* q8, const void* k8, const void* vt8, void* o, const void* scalars, int B, int H,
               int Sq, int Skv, int kv_end, void* stream) {
  return launch<bf16>(q8, k8, vt8, o, scalars, B, H, Sq, Skv, kv_end, stream);
}

// The same contract with o (B, Sq, H, 64) fp32.
int flash_int8_f32(const void* q8, const void* k8, const void* vt8, void* o, const void* scalars, int B, int H,
                   int Sq, int Skv, int kv_end, void* stream) {
  return launch<float>(q8, k8, vt8, o, scalars, B, H, Sq, Skv, kv_end, stream);
}

}  // extern "C"
