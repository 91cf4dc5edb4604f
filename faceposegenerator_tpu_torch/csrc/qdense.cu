// K7: fused-quantize int8 dense for Hopper (sm_90a).
//
//   y = (round(x / sx) · qᵀ) · sx · s     dynamic: sx = max(rowmax|x|, 1e-8) · fl(1/127)
//   y = (round(x / a) · qᵀ) · (a · s)     static: one calibrated per-tensor scale a
//
// x (M, K) row-major, q int8 (N, K) row-major (the torch Linear
// orientation), s fp32 (N,), y (M, N) in x's dtype: bf16 (`qdense`) or fp32
// (`qdense_f32`, the fp32 instance: JAX's `_qdense_kernel` quantizes any x
// and writes `o_ref.dtype`). Codes are round-half-to-even of a true
// division, clipped to ±127; the products accumulate in int32; the rescale
// is fp32 in the JAX package's order, rounded once to bf16 (or kept, fp32).
//
// Replaces faceposegenerator_tpu/ops/quant_pallas.py `_qdense_kernel` (and
// the static branch of quant._qdense_impl, which JAX leaves to XLA).
//
// What bounds it on the card. At the UNet's shapes the work is 2·M·N·K int8
// tensor-core operations against 2·M·K + N·K + 2·M·N bytes: at K = 320 (the
// fused q/k/v and the GEGLU input at 64² tokens) that is ~250 operations per
// byte, below the int8 ridge (~590), so those calls are bound by bytes,
// mostly the bf16 output; at K = 5120 (the GEGLU output at 1280 channels) they
// are bound by the tensor cores.
//
// What the design does about it (wgmma/TMA are later work):
//   * The TPU kernel holds a whole (bm, K) row block in VMEM and row-reduces
//     it; at K = 5120 that does not fit an SM. Here a small pre-pass kernel
//     (one warp per row) writes sx, and the GEMM quantizes each x tile as it
//     moves from registers to shared memory. The static mode skips the pre-pass.
//   * 128×128 output tile per CTA, 8 warps of 64×32, K in steps of 64;
//     mma.sync m16n8k32 s8·s8 → s32. The weight tile (N rows of K bytes) is
//     already the "col" B operand, copied by cp.async; operands come from
//     shared memory by ldmatrix (rows padded to 80 bytes: conflict-free). One
//     tile of x is loaded into registers while the previous one multiplies.
//   * The epilogue rescales in fp32 and stages the bf16 tile through shared
//     memory, so each thread stores 16 contiguous bytes; an fp32 tile is
//     stored from registers, two values a thread.
//   * Ragged M and N are masked (zero-filled loads, skipped stores); K must be
//     a multiple of 32, N of 8 (the wrapper checks).
//
// Plain C interface, loaded with ctypes: launches on the given stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128, BN = 128, BK = 64, NTHREADS = 256;
constexpr int ST = BK + 16;        // shared row stride of an int8 tile, bytes
constexpr int CST = BN + 8;        // shared row stride of the bf16 output tile, elements
constexpr int TILE = BM * ST;      // bytes of one int8 tile (BM == BN)
constexpr int SMEM = 4 * TILE;     // two x tiles and two weight tiles
static_assert(BM * CST * 2 <= SMEM, "the output tile reuses the operand buffers");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8×8 b16 matrices (8 rows × 16 bytes of int8 each)
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
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// A (16×32 int8, row), B (32×8 int8, col), C/D (16×8 int32)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// int8 code of x against scale: round half to even of the true quotient, clipped
__device__ __forceinline__ uint32_t code(float x, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
}

// Eight consecutive activations of a row, as loaded: one 16-byte vector of
// bf16 or two of fp32, and their values.
template <typename T>
struct X8;

template <>
struct X8<bf16> {
  uint4 v;
  __device__ __forceinline__ void load(const bf16* p) { v = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void clear() { v = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void values(float (&f)[8]) const {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      f[2 * i] = __low2float(p);
      f[2 * i + 1] = __high2float(p);
    }
  }
};

template <>
struct X8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void clear() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void values(float (&f)[8]) const {
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
};

// the codes of eight activations, four to a word
template <typename T>
__device__ __forceinline__ uint2 codes8(const X8<T>& x, float scale) {
  float f[8];
  x.values(f);
  uint2 r;
  r.x = code(f[0], scale) | (code(f[1], scale) << 8) | (code(f[2], scale) << 16) | (code(f[3], scale) << 24);
  r.y = code(f[4], scale) | (code(f[5], scale) << 8) | (code(f[6], scale) << 16) | (code(f[7], scale) << 24);
  return r;
}

// sx[m] = max(max_k |x[m, k]|, 1e-8) · fl(1/127): one warp per row
template <typename T>
__global__ void __launch_bounds__(NTHREADS) row_scale_kernel(const T* __restrict__ x, float* __restrict__ sx, int M,
                                                             int K) {
  const int row = blockIdx.x * (NTHREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + static_cast<long long>(row) * K;
  float m = 0.f;
  for (int c = lane * 8; c < K; c += 256) {  // K % 32 == 0: eight values a lane are whole
    X8<T> v;
    v.load(xr + c);
    float f[8];
    v.values(f);
#pragma unroll
    for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(f[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) sx[row] = __fmul_rn(fmaxf(m, 1e-8f), 1.f / 127.f);
}

// two CTAs an SM for bf16; the fp32 instance holds twice the x registers
template <bool STATIC, typename T>
__global__ void __launch_bounds__(NTHREADS, sizeof(T) == 2 ? 2 : 1)
    qdense_kernel(const T* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
                  const float* __restrict__ sx, T* __restrict__ y, int M, int N, int K, float a) {
  __shared__ __align__(16) unsigned char smem[SMEM];
  __shared__ float s_row[BM];
  unsigned char* sA = smem;             // x codes, buffers 0 and 1
  unsigned char* sB = smem + 2 * TILE;  // weight codes, buffers 0 and 1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // this warp's 64×32 sub-tile
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  if (!STATIC) {
    for (int r = tid; r < BM; r += NTHREADS) s_row[r] = m0 + r < M ? sx[m0 + r] : 1.f;
  }

  // x tile: 128 rows × 8 chunks of 8 activations; 4 chunks per thread
  X8<T> xr[4];
  auto load_x = [&](int kt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * NTHREADS, r = c >> 3, col = kt * BK + (c & 7) * 8;
      xr[i].clear();
      if (m0 + r < M && col < K) xr[i].load(x + static_cast<long long>(m0 + r) * K + col);
    }
  };
  auto store_x = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * NTHREADS, r = c >> 3;
      const float scale = STATIC ? a : s_row[r];
      *reinterpret_cast<uint2*>(sA + buf * TILE + r * ST + (c & 7) * 8) = codes8(xr[i], scale);
    }
  };
  // weight tile: 128 rows × 4 chunks of 16 bytes; 2 chunks per thread
  auto load_w = [&](int kt, int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * NTHREADS, r = c >> 2, col = kt * BK + (c & 3) * 16;
      const bool live = n0 + r < N && col < K;
      cp_async_16(sB + buf * TILE + r * ST + (c & 3) * 16,
                  live ? q + static_cast<long long>(n0 + r) * K + col : q, live ? 16 : 0);
    }
    cp_async_commit();
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  // ldmatrix lane → row / byte offsets of a 16×32 int8 A block
  const int lm_row = (lane & 7) + ((lane >> 3) & 1) * 8, lm_col = (lane >> 4) * 16;

  load_x(0);
  load_w(0, 0);
  __syncthreads();  // s_row
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    store_x(buf);
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < nk) {  // the next tiles load while this one multiplies
      load_x(kt + 1);
      load_w(kt + 1, buf ^ 1);
    }
    const unsigned char* tA = sA + buf * TILE;
    const unsigned char* tB = sB + buf * TILE;
    uint32_t bw[4][4];  // per 8-column tile: b0, b1 of k 0..31, then of k 32..63
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) ldsm_x4(bw[nt], tB + (wn + nt * 8 + (lane & 7)) * ST + (lane >> 3) * 16);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[4];
        ldsm_x4(af, tA + (wm + mt * 16 + lm_row) * ST + ks * 32 + lm_col);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af, bw[nt][2 * ks], bw[nt][2 * ks + 1]);
      }
    }
  }
  __syncthreads();  // the operand buffers become the output tile

  bf16* sC = reinterpret_cast<bf16*>(smem);  // the bf16 tile; an fp32 one goes straight out
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int cl = wn + nt * 8 + 2 * t4, col = n0 + cl;
    const float s0 = col < N ? s[col] : 0.f, s1 = col + 1 < N ? s[col + 1] : 0.f;
    const float as0 = __fmul_rn(a, s0), as1 = __fmul_rn(a, s1);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wm + mt * 16 + g + 8 * h;
        const float f0 = static_cast<float>(acc[mt][nt][2 * h]), f1 = static_cast<float>(acc[mt][nt][2 * h + 1]);
        float v0, v1;
        if (STATIC) {
          v0 = __fmul_rn(f0, as0);
          v1 = __fmul_rn(f1, as1);
        } else {
          v0 = __fmul_rn(__fmul_rn(f0, s_row[rl]), s0);
          v1 = __fmul_rn(__fmul_rn(f1, s_row[rl]), s1);
        }
        if constexpr (sizeof(T) == 4) {
          if (m0 + rl < M && col < N)  // N % 8 == 0: a column pair is whole or out
            *reinterpret_cast<float2*>(y + static_cast<long long>(m0 + rl) * N + col) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(sC + rl * CST + cl) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
  if constexpr (sizeof(T) == 4) return;
  __syncthreads();
  // 128 rows × 16 chunks of 8 bf16; N % 8 == 0, so a chunk is whole or out
  for (int c = tid; c < BM * (BN / 8); c += NTHREADS) {
    const int r = c >> 4, cc = (c & 15) * 8;
    if (m0 + r < M && n0 + cc < N)
      *reinterpret_cast<uint4*>(y + static_cast<long long>(m0 + r) * N + n0 + cc) =
          *reinterpret_cast<const uint4*>(sC + r * CST + cc);
  }
}

template <typename T>
int launch(const void* x, const void* q, const void* s, void* y, void* sx, int M, int N, int K, float a,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const T* xx = static_cast<const T*>(x);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* ss = static_cast<const float*>(s);
  T* yy = static_cast<T*>(y);
  if (sx == nullptr) {
    qdense_kernel<true, T><<<grid, NTHREADS, 0, st>>>(xx, qq, ss, nullptr, yy, M, N, K, a);
  } else {
    float* rs = static_cast<float*>(sx);
    row_scale_kernel<T><<<(M + NTHREADS / 32 - 1) / (NTHREADS / 32), NTHREADS, 0, st>>>(xx, rs, M, K);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    qdense_kernel<false, T><<<grid, NTHREADS, 0, st>>>(xx, qq, ss, rs, yy, M, N, K, 0.f);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (M, K) bf16, q: (N, K) int8, s: (N,) fp32, y: (M, N) bf16, all
// contiguous with 16-byte aligned rows; K % 32 == 0, N % 8 == 0. sx: an (M,)
// fp32 scratch buffer for the dynamic row scales, or null for the static mode,
// in which every activation is quantized against `a`.
int qdense(const void* x, const void* q, const void* s, void* y, void* sx, int M, int N, int K, float a,
           void* stream) {
  return launch<bf16>(x, q, s, y, sx, M, N, K, a, stream);
}

// The same contract with x and y fp32.
int qdense_f32(const void* x, const void* q, const void* s, void* y, void* sx, int M, int N, int K, float a,
               void* stream) {
  return launch<float>(x, q, s, y, sx, M, N, K, a, stream);
}

}  // extern "C"
