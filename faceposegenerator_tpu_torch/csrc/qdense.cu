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
// Replaces faceposegenerator_tpu/ops/quant_pallas.py:47 `_qdense_kernel`
// (and the static branch of quant._qdense_impl, which JAX leaves to XLA).
// The TPU kernel quantizes each row block once (`@pl.when(j == 0)`, into
// VMEM) and sweeps N with the codes resident; this kernel does the same.
//
// What bounds it on the card. The work is 2·M·N·K int8 tensor-core
// operations against 2·M·K + N·K + 2·M·N bytes (bf16). At K = 320 (the fused
// q/k/v and the GEGLU input at 64² tokens) that is ~250 operations a byte,
// below the int8 ridge (~590): those calls are bound by bytes, mostly the
// bf16 output (335 of the 378 MB at the GEGLU input). At K = 5120 (the GEGLU
// output at 1280 channels) they are bound by the tensor cores. Each output
// also costs CUDA-core work: an int → float conversion (I2FP), two fp32
// products and a bf16 pack; with the stores, that epilogue is what holds
// the K = 320 shapes above their bound (PERF.md has the ablation).
//
// Design (csrc/sm90_common.cuh), 384 threads: two consumer warpgroups of 64
// rows each and a producer warpgroup, two of whose threads issue the TMA
// loads (the weights; x).
//   * A CTA owns BM = 128 rows of x and sweeps a run of N tiles of BN = 128
//     (the wrapper picks the run so that the grid fills the SMs; at small M,
//     such as the cross-attention k/v rows, a run is one tile).
//   * Fused instance, K <= 1280 (every shape of the UNet but the GEGLU
//     outputs at 640 and 1280 channels): the consumers quantize the CTA's
//     rows once, into shared memory, as 64-deep K-major chunks under the
//     64-byte swizzle (swz64), the A operand of an SS wgmma. A second
//     producer thread brings x by TMA in 128-byte-wide chunks of the 128
//     rows, 2 to 6 in flight (a warp loading its own rows kept the quantize
//     waiting on latency); static mode makes one pass with a true division
//     by `a`; dynamic mode two, the row amax, then the codes (x from
//     shared memory again when all its chunks fit, K <= 384; else from L2).
//     The row scales stay in shared memory; there is no separate launch.
//   * Wide instance, K > 1280 (128·K codes no longer fit beside the ring),
//     and below 2048 rows (16 row blocks: the fused quantize, a serial phase
//     of each CTA, would run on few SMs; the cross-attention k/v and the
//     mid block): the wrapper runs `qdense_quant` first (a warp a row, two
//     passes: the amax, then the codes; codes and row scales to global),
//     and the GEMM brings A by TMA through the ring beside B. The source
//     note of ops/qdense.py lists which UNet calls take it.
//   * The weight tiles (N rows of K bytes) are K-major already: the producer
//     streams 128 × 64-byte chunks by TMA, 64-byte swizzled, through a ring
//     of mbarrier-guarded stages that both consumers read, as many as fit
//     (up to 12: the weights come from L2, and with 4 stages the products
//     waited on them).
//   * Each consumer runs m64n128k32 s8 wgmma into one of two s32
//     accumulators, in turn: the epilogue of tile t − 1 runs while the first
//     chunk of tile t is on the tensor cores (and the other warpgroup's
//     products fill the rest).
//   * The epilogue rescales in fp32 exactly as the plain version (static
//     f·(a·s), dynamic (f·sx)·s, every product __fmul_rn). bf16: it writes
//     the tile into shared memory under the 128-byte swizzle (conflict-free)
//     and one thread stores it with two TMA stores, which run on while the
//     next tile's products do; fp32: float2 stores from registers (a quad's
//     four make one 32-byte sector).
//   * Ragged M and N: TMA zero-fills loads and skips stores outside the
//     tensors. K must be a multiple of 32, N of 8 (the wrapper checks); the
//     last 64-deep chunk is zero-padded.
//
// Plain C interface, loaded with ctypes: launches on the given stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>

#include "sm90_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128, BN = 128, BK = 64;  // rows a CTA, columns a tile, K bytes a chunk
constexpr int THREADS = 384, MAX_RING = 12, SMEM_MAX = 232448;
constexpr int CHUNK = BM * BK;              // one 64-deep chunk of 128 rows: 8 KB (BN == BM)
constexpr int FUSED_MAX_K = 1280;           // the fused instance's codes: up to 160 KB
constexpr int OUT_TILE = 64 * 128 * 2;      // a consumer's bf16 output tile: two 64 × 64 boxes
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * (PRODUCER_REGS + 2 * CONSUMER_REGS) <= THREADS * 168, "register file");
constexpr float INV127 = 1.f / 127.f;

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Shared memory, from a 1024-byte aligned base: the x codes (fused), the
// ring of `rs` stages, the x staging (the fused instance's x chunks of 128
// rows × 128 bytes, `xs` of them; its first two are the bf16 output
// staging after the quantize), the row scales, the mbarriers (the ring's
// full and empty, then the x stages'). x takes what leaves 4 ring stages,
// 2 to 6 chunks; the ring what is left, up to MAX_RING stages. Each stage
// in flight hides part of a TMA's latency from L2: with 4 weight stages
// the products waited on their weights, with 2 x chunks the quantize of a
// 1024-wide row block waited on x.
#define HD __host__ __device__
template <bool WIDE, typename T>
struct Layout {
  static constexpr int STAGE = WIDE ? 2 * CHUNK : CHUNK, XSTAGE = 128 * 128, MAX_XS = 6;
  static HD constexpr int xs(int kc) {
    if (WIDE) return sizeof(T) == 2 ? 2 : 0;
    const int n = (SMEM_MAX - 2048 - kc * CHUNK - 4 * STAGE) / XSTAGE;
    return n < 2 ? 2 : n > MAX_XS ? MAX_XS : n;
  }
  static HD constexpr int ring(int kc) { return WIDE ? 0 : kc * CHUNK; }
  static HD constexpr int stage_out(int kc, int rs) { return ring(kc) + rs * STAGE; }
  static HD constexpr int rows(int kc, int rs) { return stage_out(kc, rs) + xs(kc) * XSTAGE; }
  static HD constexpr int bars(int kc, int rs) { return rows(kc, rs) + 4 * BM; }
  static HD constexpr int smem(int kc, int rs) { return bars(kc, rs) + 16 * (rs + xs(kc)) + 1024; }
  // the most ring stages that fit
  static HD constexpr int stages(int kc) {
    int rs = MAX_RING;
    while (rs > 3 && smem(kc, rs) > SMEM_MAX) --rs;
    return rs;
  }
};
#undef HD
static_assert(Layout<false, bf16>::smem(FUSED_MAX_K / BK, 3) <= SMEM_MAX, "shared memory");
static_assert(Layout<false, float>::smem(FUSED_MAX_K / BK, 3) <= SMEM_MAX, "shared memory");
static_assert(Layout<true, bf16>::smem(0, MAX_RING) <= SMEM_MAX, "shared memory");

// The int8 code of x against scale (round half to even of the true
// quotient, clipped to ±127) as the low byte of the returned word: rint by
// the magic-number add (q + 1.5·2²³ rounded to nearest even has the bits
// 0x4B400000 + rint(q) for |q| < 2²²), the clip on those bits (a larger |q|
// lands past a bound, so it clips too). No op on the conversion pipe but
// the division's reciprocal.
__device__ __forceinline__ uint32_t code(float x, float scale) {
  const int t = __float_as_int(__fadd_rn(__fdiv_rn(x, scale), 12582912.f));
  return static_cast<uint32_t>(min(max(t, 0x4B400000 - 127), 0x4B400000 + 127));
}

// the low bytes of a, b, c, d in one word, a lowest
__device__ __forceinline__ uint32_t code4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// Eight consecutive activations of a row, as loaded: one 16-byte vector of
// bf16 or two of fp32, and their values.
template <typename T>
struct X8;

template <>
struct X8<bf16> {
  uint4 v;
  __device__ __forceinline__ void load(const bf16* p) { v = *reinterpret_cast<const uint4*>(p); }
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
  __device__ __forceinline__ void values(float (&f)[8]) const {
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
};

template <typename T>
__device__ __forceinline__ float amax8(const X8<T>& x) {
  float f[8];
  x.values(f);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(f[i]));
  return m;
}

// the codes of eight activations, four to a word, lowest column lowest
template <typename T>
__device__ __forceinline__ uint2 codes8(const X8<T>& x, float scale) {
  float f[8];
  x.values(f);
  uint2 r;
  r.x = code4(code(f[0], scale), code(f[1], scale), code(f[2], scale), code(f[3], scale));
  r.y = code4(code(f[4], scale), code(f[5], scale), code(f[6], scale), code(f[7], scale));
  return r;
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// the row scale of the dynamic mode from the row's amax
__device__ __forceinline__ float row_scale(float amax) { return __fmul_rn(fmaxf(amax, 1e-8f), INV127); }

// ---------------------------------------------------------------------------
// the wide instance's quantize pass: one warp a row; the amax over the row,
// then the codes (the row again, from L1/L2) and the row scale to global
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) qdense_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ codes,
                                                           float* __restrict__ sx, int M, int K, float a, int dynamic) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + static_cast<long long>(row) * K;
  float scale = a;
  if (dynamic) {
    float m = 0.f;
    for (int c = lane * 8; c < K; c += 256) {  // K % 32 == 0: eight values a lane are whole
      X8<T> v;
      v.load(xr + c);
      m = fmaxf(m, amax8(v));
    }
    scale = row_scale(warp_max(m));
    if (lane == 0) sx[row] = scale;
  }
  int8_t* cr = codes + static_cast<long long>(row) * K;
  for (int c = lane * 8; c < K; c += 256) {
    X8<T> v;
    v.load(xr + c);
    *reinterpret_cast<uint2*>(cr + c) = codes8(v, scale);
  }
}

// ---------------------------------------------------------------------------
// the GEMM
// ---------------------------------------------------------------------------

// the values of 16 bytes of x: 8 bf16 or 4 fp32
__device__ __forceinline__ void unpack16(uint4 v, float* f, bf16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    f[2 * i] = __low2float(p);
    f[2 * i + 1] = __high2float(p);
  }
}

__device__ __forceinline__ void unpack16(uint4 v, float* f, float) {
  f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y), f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
}

template <bool WIDE, typename T>
__global__ void __launch_bounds__(THREADS, 1)
    qdense_kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_y,
                  const float* __restrict__ s, const float* __restrict__ sx, T* __restrict__ y, int M, int N, int K,
                  float a, int run, int dynamic) {
  using L = Layout<WIDE, T>;
  constexpr int STAGE = L::STAGE;
  extern __shared__ __align__(1024) unsigned char smem_qd[];
  const uint32_t raw = smem_u32(smem_qd);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int KC = (K + BK - 1) / BK, RING = L::stages(KC);
  const uint32_t s_codes = base, s_ring = base + L::ring(KC), s_out = base + L::stage_out(KC, RING);
  float* rows = reinterpret_cast<float*>(smem_qd + (base - raw) + L::rows(KC, RING));
  const uint32_t full0 = base + L::bars(KC, RING), empty0 = full0 + 8 * RING;
  // the fused instance's x chunks: 128 rows × XC columns (128 bytes), NX of
  // them a pass, one pass (static) or two (dynamic: the amax, then the
  // codes); when all NX fit the stages (K <= 384 in bf16), they are loaded
  // once and both passes read them
  constexpr int XC = 128 / sizeof(T), XCHUNK = L::XSTAGE;
  const int XS = L::xs(KC), NX = KC * BK / XC;
  const bool resident = NX <= XS;
  const int x_loads = dynamic && !resident ? 2 * NX : NX;
  const uint32_t xfull0 = empty0 + 8 * RING, xempty0 = xfull0 + 8 * XS;

  const int m0 = blockIdx.x * BM;
  const int n_tiles = (N + BN - 1) / BN;
  const int t0 = blockIdx.y * run, t1 = min(t0 + run, n_tiles);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int i = 0; i < RING; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < XS; ++i) {
      mbar_init(xfull0 + 8 * i, 1);
      mbar_init(xempty0 + 8 * i, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = t0; t < t1; ++t)
        for (int kc = 0; kc < KC; ++kc, ++it) {
          const int st = it % RING;
          mbar_wait(empty0 + 8 * st, ((it / RING) & 1) ^ 1);
          mbar_arrive_expect_tx(full0 + 8 * st, STAGE);
          tma_load_2d(s_ring + st * STAGE, &tm_w, full0 + 8 * st, kc * BK, t * BN);
          if (WIDE) tma_load_2d(s_ring + st * STAGE + CHUNK, &tm_a, full0 + 8 * st, kc * BK, m0);
        }
    } else if (!WIDE && threadIdx.x == 288) {  // x, into the output staging
      for (int i = 0; i < x_loads; ++i) {
        const int slot = i % XS;
        mbar_wait(xempty0 + 8 * slot, ((i / XS) & 1) ^ 1);
        mbar_arrive_expect_tx(xfull0 + 8 * slot, XCHUNK);
        tma_load_2d(s_out + slot * XCHUNK, &tm_x, xfull0 + 8 * slot, (i % NX) * XC, m0);
      }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, t4 = lane & 3;

  if (!WIDE) {
    // quantize rows [m0, m0 + 128) once, from the x chunks the second
    // producer thread brings (128-byte swizzle: 16-byte unit c of row r at
    // c ^ (r % 8)); thread 2r + h takes units 4h..4h + 3 of row r
    constexpr int XV = 16 / sizeof(T), VPT = 4 * XV;  // values a unit, a thread's values of a chunk
    const int r = threadIdx.x >> 1, h = threadIdx.x & 1;
    auto load_x = [&](int i, float (&f)[VPT]) {
      const int slot = i % XS;
      mbar_wait(xfull0 + 8 * slot, (i / XS) & 1);
      const uint32_t row = s_out + slot * XCHUNK + 128 * r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint4 v;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "r"(row + (((4 * h + q) ^ (r & 7)) << 4)));
        unpack16(v, f + q * XV, T());
      }
    };
    auto release_x = [&](int i) {
      __syncwarp();
      mbar_arrive_if(xempty0 + 8 * (i % XS), lane == 0);
    };
    float scale = a;
    if (dynamic) {
      float m = 0.f;
      for (int xc = 0; xc < NX; ++xc) {
        float f[VPT];
        load_x(xc, f);
#pragma unroll
        for (int e = 0; e < VPT; ++e) m = fmaxf(m, fabsf(f[e]));
        if (!resident) release_x(xc);
      }
      scale = row_scale(fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1)));
      if (h == 0) rows[r] = scale;
    }
    for (int xc = 0; xc < NX; ++xc) {
      const int i = dynamic && !resident ? NX + xc : xc;
      float f[VPT];
      load_x(i, f);
      uint32_t wd[VPT / 4];
#pragma unroll
      for (int e = 0; e < VPT / 4; ++e)
        wd[e] = code4(code(f[4 * e], scale), code(f[4 * e + 1], scale), code(f[4 * e + 2], scale),
                      code(f[4 * e + 3], scale));
      release_x(i);
      const int col = xc * XC + h * VPT;  // the first of this thread's columns
#pragma unroll
      for (int u = 0; u < VPT / 16; ++u)
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         s_codes + (col / BK) * CHUNK + swz64(r, col % BK + 16 * u)),
                     "r"(wd[4 * u]), "r"(wd[4 * u + 1]), "r"(wd[4 * u + 2]), "r"(wd[4 * u + 3])
                     : "memory");
    }
    fence_proxy_async();  // the codes are read by wgmma (the async proxy)
  } else if (dynamic) {
    for (int r = threadIdx.x; r < BM; r += 256) rows[r] = m0 + r < M ? sx[m0 + r] : 1.f;
  }
  named_bar_sync(1, 256);

  // row scales of this thread's two rows in the warpgroup's 64
  const int rl0 = 64 * wg + 16 * w + g;
  const float sx0 = dynamic ? rows[rl0] : 0.f, sx1 = dynamic ? rows[rl0 + 8] : 0.f;
  const uint32_t a_wg = 64 * 64 * wg;  // this warpgroup's rows in a chunk
  const uint32_t out_wg = s_out + wg * OUT_TILE;

  // chunk kc of a tile: both k32 slices into acc, once the stage has landed
  auto issue = [&](uint32_t(&acc)[64], int kc, int it) {
    const int st = it % RING;
    mbar_wait(full0 + 8 * st, (it / RING) & 1);
    const uint32_t sa = (WIDE ? s_ring + st * STAGE + CHUNK : s_codes + kc * CHUNK) + a_wg;
    const uint32_t sb = s_ring + st * STAGE;
    fence_regs(acc);
    wgmma_fence();
    wgmma_s8_ss_m64n128(acc, desc_k64(sa), desc_k64(sb), kc > 0);
    wgmma_s8_ss_m64n128(acc, desc_k64(sa + 32), desc_k64(sb + 32), 1);
    wgmma_commit();
  };
  auto release = [&](int it) { mbar_arrive_if(empty0 + 8 * (it % RING), lane == 0); };

  // the rescale and store of tile t
  // (the mode is a compile-time flag here and the weight scales are loaded
  // first, so the 16 column pairs' loads, conversions and products
  // interleave; the staging stores carry no memory clobber for the same
  // reason: the fence after them orders them)
  auto epilogue_mode = [&](uint32_t(&acc)[64], int t, auto dyn) {
    constexpr bool DYN = decltype(dyn)::value;
    const int n0 = t * BN;
    float2 sc[BN / 8];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * t4;
      sc[i] = col < N ? __ldg(reinterpret_cast<const float2*>(s + col)) : make_float2(0.f, 0.f);
    }
    if constexpr (sizeof(T) == 2) {
      if ((threadIdx.x & 127) == 0) bulk_wait_read<0>();  // the previous tile's stores have read the staging
      named_bar_sync(2 + wg, 128);
    }
    const int rg0 = m0 + rl0, rg1 = rg0 + 8;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * t4;
      const float f00 = static_cast<float>(static_cast<int>(acc[4 * i])),
                  f01 = static_cast<float>(static_cast<int>(acc[4 * i + 1])),
                  f10 = static_cast<float>(static_cast<int>(acc[4 * i + 2])),
                  f11 = static_cast<float>(static_cast<int>(acc[4 * i + 3]));
      float v00, v01, v10, v11;
      if constexpr (DYN) {
        v00 = __fmul_rn(__fmul_rn(f00, sx0), sc[i].x);
        v01 = __fmul_rn(__fmul_rn(f01, sx0), sc[i].y);
        v10 = __fmul_rn(__fmul_rn(f10, sx1), sc[i].x);
        v11 = __fmul_rn(__fmul_rn(f11, sx1), sc[i].y);
      } else {
        const float as0 = __fmul_rn(a, sc[i].x), as1 = __fmul_rn(a, sc[i].y);
        v00 = __fmul_rn(f00, as0);
        v01 = __fmul_rn(f01, as1);
        v10 = __fmul_rn(f10, as0);
        v11 = __fmul_rn(f11, as1);
      }
      if constexpr (sizeof(T) == 2) {
        // row r of a 64 × 64 box at 128·r, its 16-byte chunk c at c ^ (r % 8)
        const int r = 16 * w + g;
        const uint32_t at = out_wg + (i / 8) * (OUT_TILE / 2) + 128 * r + (((i % 8) ^ (r & 7)) << 4) + 4 * t4;
        const __nv_bfloat162 p0 = __floats2bfloat162_rn(v00, v01), p1 = __floats2bfloat162_rn(v10, v11);
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(*reinterpret_cast<const uint32_t*>(&p0)));
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at + 8 * 128), "r"(*reinterpret_cast<const uint32_t*>(&p1)));
      } else {
        if (col < N) {  // N % 8 == 0: a column pair is whole or out
          if (rg0 < M) *reinterpret_cast<float2*>(y + static_cast<long long>(rg0) * N + col) = make_float2(v00, v01);
          if (rg1 < M) *reinterpret_cast<float2*>(y + static_cast<long long>(rg1) * N + col) = make_float2(v10, v11);
        }
      }
    }
    if constexpr (sizeof(T) == 2) {
      fence_proxy_async();
      named_bar_sync(2 + wg, 128);
      if ((threadIdx.x & 127) == 0) {
        const int my0 = m0 + 64 * wg;
        tma_store_2d(&tm_y, out_wg, n0, my0);
        if (n0 + 64 < N) tma_store_2d(&tm_y, out_wg + OUT_TILE / 2, n0 + 64, my0);
        bulk_commit();
      }
    }
  };
  auto epilogue = [&](uint32_t(&acc)[64], int t) {
    if (dynamic)
      epilogue_mode(acc, t, Flag<true>());
    else
      epilogue_mode(acc, t, Flag<false>());
  };

  // tile t into `cur`; the epilogue of the previous tile (in `prev`) while
  // this tile's first chunk is on the tensor cores
  int it = 0;
  uint32_t acc0[64], acc1[64];
  auto tile = [&](uint32_t(&cur)[64], int t, uint32_t(&prev)[64], bool has_prev) {
    issue(cur, 0, it);
    if (has_prev) {
      wgmma_wait<1>();
      fence_regs(prev);
      release(it - 1);
      epilogue(prev, t - 1);
    }
    for (int kc = 1; kc < KC; ++kc) {
      issue(cur, kc, it + kc);
      wgmma_wait<1>();
      release(it + kc - 1);
    }
    it += KC;
  };
  int t = t0;
  for (; t + 1 < t1; t += 2) {
    tile(acc0, t, acc1, t > t0);
    tile(acc1, t + 1, acc0, true);
  }
  if (t < t1) {
    tile(acc0, t, acc1, t > t0);
    wgmma_wait<0>();
    fence_regs(acc0);
    release(it - 1);
    epilogue(acc0, t);
  } else {
    wgmma_wait<0>();
    fence_regs(acc1);
    release(it - 1);
    epilogue(acc1, t - 1);
  }
  if constexpr (sizeof(T) == 2) {
    if ((threadIdx.x & 127) == 0) bulk_wait<0>();  // the staging outlives the stores
  }
}

template <bool WIDE, typename T>
int launch_gemm(const void* x, const void* q, const void* s, void* y, const void* codes, const void* sx, int M, int N,
                int K, float a, int run, int dynamic, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err =
        cudaFuncSetAttribute(qdense_kernel<WIDE, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int KC = (K + BK - 1) / BK;
  // weights (K, N) and x codes (K, M): 64-byte × 128-row boxes, 64-byte
  // swizzled; y (N, M) bf16: 64 × 64 boxes, 128-byte swizzled
  CUtensorMap tw{}, ta{}, tx{}, ty{};
  const int box[2] = {BK, 128};
  const long long wd[2] = {K, N}, ws[1] = {K};
  int err = make_map(&tw, q, 2, wd, ws, box, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err == 0 && WIDE) {
    const long long ad[2] = {K, M};
    err = make_map(&ta, codes, 2, ad, ws, box, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  }
  if (err == 0 && !WIDE) {  // x (K, M): 128-byte × 128-row boxes, 128-byte swizzled
    const long long xd[2] = {K, M}, xs[1] = {static_cast<long long>(sizeof(T)) * K};
    const int xbox[2] = {128 / static_cast<int>(sizeof(T)), 128};
    err = make_map(&tx, x, 2, xd, xs, xbox, CU_TENSOR_MAP_SWIZZLE_128B,
                   sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  }
  if (err == 0 && sizeof(T) == 2) {
    const long long yd[2] = {N, M}, ys[1] = {2LL * N};
    const int ybox[2] = {64, 64};
    err = make_map(&ty, y, 2, yd, ys, ybox, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != 0) return err;
  const int n_tiles = (N + BN - 1) / BN;
  const dim3 grid((M + BM - 1) / BM, (n_tiles + run - 1) / run);
  using L = Layout<WIDE, T>;
  qdense_kernel<WIDE, T><<<grid, THREADS, L::smem(KC, L::stages(KC)), stream>>>(
      tw, ta, tx, ty, static_cast<const float*>(s), static_cast<const float*>(sx), static_cast<T*>(y), M, N, K, a,
      run, dynamic);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* q, const void* s, void* y, const void* codes, const void* sx, int M, int N,
           int K, float a, int run, int dynamic, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (run < 1 || (K > FUSED_MAX_K && codes == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (codes == nullptr) return launch_gemm<false, T>(x, q, s, y, codes, sx, M, N, K, a, run, dynamic, st);
  return launch_gemm<true, T>(x, q, s, y, codes, sx, M, N, K, a, run, dynamic, st);
}

}  // namespace

extern "C" {

// x: (M, K) bf16, q: (N, K) int8, s: (N,) fp32, y: (M, N) bf16, all
// contiguous with 16-byte aligned rows; K % 32 == 0, N % 8 == 0. `dynamic`:
// 1 for per-row scales, 0 for the static mode, in which every activation is
// quantized against `a`. `codes` and `sx` null: the fused instance (K <=
// 1280). Else the wide instance: `codes` (M, K) int8 and, dynamic, `sx`
// (M,) fp32 as qdense_quant wrote them (required above K = 1280). `run`: N
// tiles of 128 a CTA.
int qdense(const void* x, const void* q, const void* s, void* y, const void* codes, const void* sx, int M, int N,
           int K, float a, int run, int dynamic, void* stream) {
  return launch<bf16>(x, q, s, y, codes, sx, M, N, K, a, run, dynamic, stream);
}

// The same contract with x and y fp32.
int qdense_f32(const void* x, const void* q, const void* s, void* y, const void* codes, const void* sx, int M, int N,
               int K, float a, int run, int dynamic, void* stream) {
  return launch<float>(x, q, s, y, codes, sx, M, N, K, a, run, dynamic, stream);
}

// The wide instance's quantize pass: x (M, K) bf16 (f32 = 0) or fp32 (f32 =
// 1) → codes (M, K) int8 and, dynamic, the row scales sx (M,) fp32.
int qdense_quant(const void* x, void* codes, void* sx, int M, int K, float a, int dynamic, int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (M + 7) / 8;
  if (f32)
    qdense_quant_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(x), static_cast<int8_t*>(codes),
                                                       static_cast<float*>(sx), M, K, a, dynamic);
  else
    qdense_quant_kernel<bf16><<<blocks, 256, 0, st>>>(static_cast<const bf16*>(x), static_cast<int8_t*>(codes),
                                                      static_cast<float*>(sx), M, K, a, dynamic);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
