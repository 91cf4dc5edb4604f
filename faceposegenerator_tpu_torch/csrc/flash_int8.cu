// K8: int8 attention for Hopper (sm_90a), head dim 64, inference only.
//
// Replaces faceposegenerator_tpu/ops/flash_attention.py:1108
// `_fwd_kernel_packed_int8` (reached through `flash_attention_int8`, :1261),
// with the per-tensor quantize of q, k and v that JAX leaves to XLA in front
// of it. Three launches a call:
//
//   flash_int8_amax   max |x| of q, k and v: a block max, then atomicMax on
//                     the bits of the non-negative float (exact: the max
//                     does not depend on the order);
//   flash_int8_codes  the codes in the layouts the attention reads, and its
//                     two fp32 constants, on the device: s_x = max(amax_x,
//                     1e-8)·fl(1/127), code = round-half-even(x / s_x)
//                     clipped to ±127 (a true division, as quantize() does),
//                     c_qk = (s_q·s_k)·scale, c_v = s_v·fl(1/127);
//                       q8 (B·H, Sq, 64), k8 (B·H, Skv, 64) int8;
//                       v8ᵀ (B·H, 64, Skv rounded up to 128) int8, the keys of
//                       each 32 permuted (position 16h + 4t + e holds key
//                       16h + 2t + e for e < 2, 16h + 8 + 2t + e − 2 else),
//                       zeros past Skv;
//   flash_int8 /      the attention, writing bf16 or fp32 (as JAX's
//   flash_int8_f32    `flash_attention_int8` passes q.dtype through).
//
// Per query row, over blocks of 4096 keys (JAX's DEFAULT_BLOCK_K, :52: its
// grid walks the keys in such blocks and quantizes p against each block's
// own row max, :1157-1185):
//
//   s  = float(q8·k8ᵀ) · c_qk,  keys >= kv_end masked
//   m' = max(m, max of s over the block's live keys), α = exp(m − m')
//   p  = exp(s − m'),  p8 = trunc(p·127 + 0.5)
//   acc = acc·α + float(Σ p8·v8)·c_v,  l = l·α + Σ p,  m = m'
//   o  = acc / l
//
// p is quantized against the block's full row max, so each block is swept
// twice: the first sweep finds the integer row max of q8·k8ᵀ (float(·)·c_qk
// is monotone, so its max is the max of s), the second recomputes the scores
// and accumulates l and P·V. exp is expf, and every product and sum that
// feeds a rounding step is an _rn intrinsic, so no multiply-add is
// contracted: the kernel computes what attention_int8_plain computes, and
// the blocks merge in fp32 in its order.
//
// What bounds it on the card: 6·Sq·Skv·64 int8 tensor-core operations per
// head (QKᵀ twice, P·V once; the function itself needs 4) and per score one
// exp and the quantize of p, against ~2·(Sq + 2·Skv)·64 bytes of bf16 in and
// 2·Sq·64 out. At the 4096-token self-attention the per-score work bounds it:
// 1.34·10⁹ scores at 80 × 4096², each with the MUFU.EX2 inside expf on the
// quarter-rate pipe (~16 an SM a clock) and ~15 more instructions; the
// 77-key cross-attention is bound by bytes and launches.
//
// Design (csrc/sm90_common.cuh): one CTA per (b·h, 128 query rows), 384
// threads: two consumer warpgroups of 64 rows each and a producer
// warpgroup whose one thread issues TMA loads: Q once (64-byte swizzle),
// then per block the K tiles of sweep 1 and the K and V̂ᵀ tiles of sweep 2
// (128 keys × 64 bytes, 64-byte swizzle; 64 × 128 keys, 128-byte swizzle)
// through a ring of eight mbarrier-guarded stages.
//   * S = q8·k8ᵀ is m64n128k32 s8 wgmma, SS (int8 wgmma takes K-major
//     operands only, which q8 and k8 are); P·V is m64n64k32 RS with p8 in
//     registers and V̂ᵀ K-major: the s32 score accumulator has mma.sync
//     m16n8's layout, so a thread's codes of four 8-key chunks pack into the
//     s8 A fragment of a 32-key slice once V's keys are permuted as above.
//   * Per score, off the quarter-rate pipe where that is exact: trunc(y)
//     for y = p·127 + 0.5 ∈ [0.5, 127.5] as the low byte of
//     __fadd_rz(y, 2²³) (no F2I), the codes packed by PRMT. The score goes
//     to float by a plain conversion, which ptxas emits as I2FP (not the
//     quarter-rate I2F) on sm_90: measured 2% faster than the magic-number
//     add (__int_as_float(s + 0x4B400000) − 12582912), which it replaced.
//     One MUFU.EX2 a score is left, inside expf (exact expf is what keeps
//     the codes: __expf's ~2-ulp error would flip a p8 code in ~1 of 10⁴
//     scores).
//   * Sweep 2 runs K1's pipeline: the codes of S_{j-1} are packed, S_j and
//     P_{j-1}·V_{j-1} issued, and the p of S_j computed while P_{j-1}·V_{j-1}
//     runs. K1's ping-pong of the two warpgroups (named barriers) was tried
//     and measured no faster here (PERF.md, K8's findings): the score work,
//     not the tensor cores, is what the warpgroups share.
//   * Only the key tile that holds kv_end is masked; blocks past kv_end are
//     never loaded.
//
// Plain C interface, loaded with ctypes: launches on the given stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>

#include "sm90_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 128, BK = 128, KBLOCK = 4096, THREADS = 384, RING = 8;
constexpr int Q_BYTES = BQ * 64, K_BYTES = BK * 64, V_BYTES = 64 * BK, STAGE = K_BYTES + V_BYTES;
constexpr int BAR_OFF = Q_BYTES + RING * STAGE;
constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * RING) + 1024;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * (PRODUCER_REGS + 2 * CONSUMER_REGS) <= THREADS * 168, "register file");
constexpr float INV127 = 1.f / 127.f;
constexpr float NEG_BIG = -1e30f;  // the plain version's mask value and initial running max

// ---------------------------------------------------------------------------
// the quantize launches
// ---------------------------------------------------------------------------

// q, k, v: (B, S, H, 64) views, head dim contiguous, element strides (b, s, h)
struct Views {
  const void* p[3];
  long long sb[3], ss[3], sh[3];
  int S[3];
};

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

// eight values of row (b, s, h) of tensor z, from column 8·d8
template <typename T>
__device__ __forceinline__ X8<T> load8(const Views& v, int z, int b, int s, int h, int d8) {
  X8<T> x;
  x.load(static_cast<const T*>(v.p[z]) + b * v.sb[z] + s * v.ss[z] + h * v.sh[z] + 8 * d8);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(256) flash_int8_amax_kernel(Views v, int B, int H, float* __restrict__ amax) {
  const int z = blockIdx.y, S = v.S[z];
  const long long chunks = static_cast<long long>(B) * S * H * 8, stride = gridDim.x * 256LL;
  float m = 0.f;
  // four loads in flight a thread
  for (long long c0 = blockIdx.x * 256LL + threadIdx.x; c0 < chunks; c0 += 4 * stride) {
    X8<T> x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long c = c0 + u * stride;
      if (c < chunks) {
        const int row = static_cast<int>(c >> 3), bs = row / H;  // B·S·H < 2³¹ (the wrapper checks)
        x[u] = load8<T>(v, z, bs / S, bs % S, row % H, static_cast<int>(c & 7));
      } else {
        x[u] = load8<T>(v, z, 0, 0, 0, 0);  // a valid chunk; |x| <= the max anyway
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float f[8];
      x[u].values(f);
#pragma unroll
      for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(f[i]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[8];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < 8; ++i) m = fmaxf(m, part[i]);
    // non-negative floats order as their bits do
    atomicMax(reinterpret_cast<int*>(amax) + z, __float_as_int(m));
  }
}

__device__ __forceinline__ float tensor_scale(float amax) { return __fmul_rn(fmaxf(amax, 1e-8f), INV127); }

// the code of x against scale as the low byte of the returned word (the
// magic-number rint and the clip of qdense.cu's `code`)
__device__ __forceinline__ uint32_t code(float x, float scale) {
  const int t = __float_as_int(__fadd_rn(__fdiv_rn(x, scale), 12582912.f));
  return static_cast<uint32_t>(min(max(t, 0x4B400000 - 127), 0x4B400000 + 127));
}

// the low bytes of a, b, c, d in one word, a lowest
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// the key at position p of V̂ᵀ (the permutation within each 32 keys)
__device__ __forceinline__ int v_key(int p) {
  const int m = p & 31, half = m >> 4, t = (m >> 2) & 3, e = m & 3;
  return (p & ~31) + 16 * half + (e < 2 ? 2 * t + e : 8 + 2 * t + e - 2);
}

// grid (row blocks of 128, B·H, 3): q, k rows → (B·H, S, 64) codes; 128
// positions of V̂ᵀ → (B·H, 64, skv_p) through shared memory
template <typename T>
__global__ void __launch_bounds__(256)
    flash_int8_codes_kernel(Views v, int H, int skv_p, const float* __restrict__ amax, float scale,
                            int8_t* __restrict__ q8, int8_t* __restrict__ k8, int8_t* __restrict__ vt,
                            float* __restrict__ consts) {
  __shared__ __align__(16) unsigned char tile[64][BK + 16];
  const int z = blockIdx.z, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int r0 = blockIdx.x * 128;
  const float sc = tensor_scale(amax[z]);
  if (z == 0 && blockIdx.x == 0 && bh == 0 && threadIdx.x == 0) {
    consts[0] = __fmul_rn(__fmul_rn(tensor_scale(amax[0]), tensor_scale(amax[1])), scale);
    consts[1] = __fmul_rn(tensor_scale(amax[2]), INV127);
  }
  if (z < 2) {
    const int S = v.S[z];
    if (r0 >= S) return;
    int8_t* dst = (z == 0 ? q8 : k8) + static_cast<long long>(bh) * S * 64;
    const int d8 = threadIdx.x & 7;
    X8<T> x[4];  // a thread's four chunks, loaded before any is quantized
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + ((threadIdx.x + 256 * u) >> 3);
      if (r < S) x[u] = load8<T>(v, z, b, r, h, d8);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + ((threadIdx.x + 256 * u) >> 3);
      if (r >= S) break;
      float f[8];
      x[u].values(f);
      uint2 w;
      w.x = pack4(code(f[0], sc), code(f[1], sc), code(f[2], sc), code(f[3], sc));
      w.y = pack4(code(f[4], sc), code(f[5], sc), code(f[6], sc), code(f[7], sc));
      *reinterpret_cast<uint2*>(dst + static_cast<long long>(r) * 64 + 8 * d8) = w;
    }
    return;
  }
  if (r0 >= skv_p) return;
  const int S = v.S[2];
  // a thread: four positions of one 8-wide chunk of d; warp w writes rows
  // 8w .. 8w + 7 of the tile, a 4-byte word a lane (no bank conflicts)
  {
    const int pq = threadIdx.x & 31, d8 = threadIdx.x >> 5;
    uint32_t words[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = v_key(r0 + 4 * pq + j);
      if (key < S) {
        float f[8];
        load8<T>(v, 2, b, key, h, d8).values(f);
#pragma unroll
        for (int i = 0; i < 8; ++i) words[i] |= (code(f[i], sc) & 0xffu) << (8 * j);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) *reinterpret_cast<uint32_t*>(&tile[8 * d8 + i][4 * pq]) = words[i];
  }
  __syncthreads();
  int8_t* dst = vt + static_cast<long long>(bh) * 64 * skv_p + r0;
  for (int c = threadIdx.x; c < 64 * (BK / 16); c += 256) {
    const int d = c / (BK / 16), q16 = c % (BK / 16);
    *reinterpret_cast<uint4*>(dst + static_cast<long long>(d) * skv_p + 16 * q16) =
        *reinterpret_cast<const uint4*>(&tile[d][16 * q16]);
  }
}

// ---------------------------------------------------------------------------
// the attention
// ---------------------------------------------------------------------------

// the integer row maxima of a score tile (rows g, g + 8) over its live keys
template <bool MASK>
__device__ __forceinline__ void tile_max(const uint32_t (&s)[64], int& mx0, int& mx1, int key0, int kv_end) {
#pragma unroll
  for (int i = 0; i < BK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (!MASK || key0 + 8 * i + e < kv_end) {
        mx0 = max(mx0, static_cast<int>(s[4 * i + e]));
        mx1 = max(mx1, static_cast<int>(s[4 * i + 2 + e]));
      }
}

// p = exp(s·c_qk − m) of a score tile, its sums into l0, l1, and in place
// of each score the bits of __fadd_rz(p·127 + 0.5, 2²³), whose low byte is
// its code p8 = trunc(p·127 + 0.5)
template <bool MASK>
__device__ __forceinline__ void tile_p(uint32_t (&s)[64], float c_qk, float m0, float m1, float& l0, float& l1,
                                       int key0, int kv_end) {
#pragma unroll
  for (int i = 0; i < BK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float sf = static_cast<float>(static_cast<int>(s[4 * i + e]));  // exact: |s| <= 127²·64 < 2²⁴
      float p = expf(__fsub_rn(__fmul_rn(sf, c_qk), e < 2 ? m0 : m1));
      if (MASK && key0 + 8 * i + (e & 1) >= kv_end) p = 0.f;
      if (e < 2)
        l0 = __fadd_rn(l0, p);
      else
        l1 = __fadd_rn(l1, p);
      s[4 * i + e] = __float_as_uint(__fadd_rz(__fadd_rn(__fmul_rn(p, 127.f), 0.5f), 8388608.f));
    }
}

// the codes of a tile (tile_p's output) as the s8 A fragments of its four
// 32-key slices
__device__ __forceinline__ void pack_p8(const uint32_t (&y)[64], uint32_t (&pa)[16]) {
#pragma unroll
  for (int kc = 0; kc < BK / 32; ++kc) {
    const uint32_t* c = y + 16 * kc;  // chunks 4kc .. 4kc + 3, four values each
    pa[4 * kc + 0] = pack4(c[0], c[1], c[4], c[5]);
    pa[4 * kc + 1] = pack4(c[2], c[3], c[6], c[7]);
    pa[4 * kc + 2] = pack4(c[8], c[9], c[12], c[13]);
    pa[4 * kc + 3] = pack4(c[10], c[11], c[14], c[15]);
  }
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }

template <typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
    flash_int8_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, OutT* __restrict__ o,
                      const float* __restrict__ consts, int H, int Sq, int kv_end) {
  extern __shared__ __align__(1024) unsigned char smem_i8[];
  const uint32_t base = (smem_u32(smem_i8) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK0 = base + Q_BYTES;  // stage st: K at sK0 + st·STAGE, V̂ᵀ K_BYTES after it
  const uint32_t full_q = base + BAR_OFF, full0 = full_q + 8, empty0 = full0 + 8 * RING;

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int n_tiles = (kv_end + BK - 1) / BK, n_blocks = (kv_end + KBLOCK - 1) / KBLOCK;
  constexpr int TPB = KBLOCK / BK;  // tiles a block
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int i = 0; i < RING; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: per block, sweep 1's K tiles, then sweep 2's K and V̂ᵀ tiles
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(full_q, Q_BYTES);
      tma_load_3d(sQ, &tm_q, full_q, 0, q0, bh);
      int it = 0;
      for (int kb = 0; kb < n_blocks; ++kb) {
        const int j0 = kb * TPB, j1 = min(j0 + TPB, n_tiles);
        for (int sweep = 0; sweep < 2; ++sweep)
          for (int j = j0; j < j1; ++j, ++it) {
            const int st = it % RING;
            const uint32_t sK = sK0 + st * STAGE;
            mbar_wait(empty0 + 8 * st, ((it / RING) & 1) ^ 1);
            mbar_arrive_expect_tx(full0 + 8 * st, sweep ? STAGE : K_BYTES);
            tma_load_3d(sK, &tm_k, full0 + 8 * st, 0, j * BK, bh);
            if (sweep) tma_load_3d(sK + K_BYTES, &tm_v, full0 + 8 * st, j * BK, 0, bh);
          }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  const uint32_t sQw = sQ + wg * 64 * 64;  // this warpgroup's 64 query rows
  const float c_qk = consts[0], c_v = consts[1];
  uint32_t s_acc[64], o_acc[32], pa[16];
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;

  auto release = [&](int it) { mbar_arrive_if(empty0 + 8 * (it % RING), lane == 0); };
  // S = Q·K_jᵀ of the tile in ring slot `it`, once it has landed
  auto issue_s = [&](int it) {
    const int st = it % RING;
    mbar_wait(full0 + 8 * st, (it / RING) & 1);
    const uint32_t sK = sK0 + st * STAGE;
    fence_regs(s_acc);
    wgmma_fence();
    wgmma_s8_ss_m64n128(s_acc, desc_k64(sQw), desc_k64(sK), 0);
    wgmma_s8_ss_m64n128(s_acc, desc_k64(sQw + 32), desc_k64(sK + 32), 1);
    wgmma_commit();
  };

  // O += P·V of the tile in ring slot `it` with p8 in pa (`first`: O = P·V)
  auto issue_pv = [&](int it, bool first) {
    const uint32_t sV = sK0 + (it % RING) * STAGE + K_BYTES;
    fence_regs(pa);
    fence_regs(o_acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 32; ++kc)
      wgmma_s8_rs_m64n64(o_acc, pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2], pa[4 * kc + 3], desc_k(sV + 32 * kc),
                         !first || kc > 0);
    wgmma_commit();
  };
  // p of S_j (in s_acc, in place) and its Σp
  auto p_of = [&](int j, float mn0, float mn1, float& ls0, float& ls1) {
    if (j * BK + BK > kv_end)
      tile_p<true>(s_acc, c_qk, mn0, mn1, ls0, ls1, j * BK + 2 * t4, kv_end);
    else
      tile_p<false>(s_acc, c_qk, mn0, mn1, ls0, ls1, j * BK + 2 * t4, kv_end);
  };
  mbar_wait(full_q, 0);
  int it = 0;
  for (int kb = 0; kb < n_blocks; ++kb) {
    const int j0 = kb * TPB, j1 = min(j0 + TPB, n_tiles);
    // sweep 1: the integer row max over the block's live keys
    int mx0 = INT32_MIN, mx1 = INT32_MIN;
    for (int j = j0; j < j1; ++j, ++it) {
      issue_s(it);
      wgmma_wait<0>();
      fence_regs(s_acc);
      release(it);
      const int key0 = j * BK + 2 * t4;
      if (j * BK + BK > kv_end)
        tile_max<true>(s_acc, mx0, mx1, key0, kv_end);
      else
        tile_max<false>(s_acc, mx0, mx1, key0, kv_end);
    }
    mx0 = max(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = max(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = max(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = max(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, __fmul_rn(static_cast<float>(mx0), c_qk));
    const float mn1 = fmaxf(m1, __fmul_rn(static_cast<float>(mx1), c_qk));
    const float al0 = expf(__fsub_rn(m0, mn0)), al1 = expf(__fsub_rn(m1, mn1));

    // sweep 2: p, p8, Σp and P·V against the block's max; iteration j
    // packs the codes of S_{j-1}, issues S_j and P_{j-1}·V_{j-1}, then
    // computes p of S_j while P_{j-1}·V_{j-1} runs (the pattern of K1: the
    // A fragment is written only while no product reads it). The first
    // tile is peeled off, so that every wait in the loop has the same
    // groups in flight.
    float ls0 = 0.f, ls1 = 0.f;
    issue_s(it);
    wgmma_wait<0>();
    fence_regs(s_acc);
    p_of(j0, mn0, mn1, ls0, ls1);
    ++it;
    for (int j = j0 + 1; j < j1; ++j, ++it) {
      pack_p8(s_acc, pa);
      issue_s(it);
      issue_pv(it - 1, j - 1 == j0);
      wgmma_wait<1>();
      fence_regs(s_acc);
      p_of(j, mn0, mn1, ls0, ls1);
      wgmma_wait<0>();
      fence_regs(o_acc);
      fence_regs(pa);
      release(it - 1);
    }
    pack_p8(s_acc, pa);
    issue_pv(it - 1, j1 - 1 == j0);
    wgmma_wait<0>();
    fence_regs(o_acc);
    fence_regs(pa);
    release(it - 1);

    // merge the block in fp32, in the plain version's order
    ls0 = __fadd_rn(ls0, __shfl_xor_sync(0xffffffffu, ls0, 1));
    ls0 = __fadd_rn(ls0, __shfl_xor_sync(0xffffffffu, ls0, 2));
    ls1 = __fadd_rn(ls1, __shfl_xor_sync(0xffffffffu, ls1, 1));
    ls1 = __fadd_rn(ls1, __shfl_xor_sync(0xffffffffu, ls1, 2));
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float al = (i & 2) ? al1 : al0;
      acc[i] = __fadd_rn(__fmul_rn(acc[i], al), __fmul_rn(static_cast<float>(static_cast<int>(o_acc[i])), c_v));
    }
    l0 = __fadd_rn(__fmul_rn(l0, al0), ls0);
    l1 = __fadd_rn(__fmul_rn(l1, al1), ls1);
    m0 = mn0;
    m1 = mn1;
  }

  const int b = bh / H, h = bh % H;
  const int row0 = q0 + wg * 64 + w * 16 + g, row1 = row0 + 8;
  const long long row_stride = static_cast<long long>(H) * 64;  // o: (B, Sq, H, 64)
  OutT* ob = o + (static_cast<long long>(b) * Sq * H + h) * 64;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * i + 2 * t4;
    if (row0 < Sq) store2(ob + row0 * row_stride + col, __fdiv_rn(acc[4 * i], l0), __fdiv_rn(acc[4 * i + 1], l0));
    if (row1 < Sq) store2(ob + row1 * row_stride + col, __fdiv_rn(acc[4 * i + 2], l1), __fdiv_rn(acc[4 * i + 3], l1));
  }
}

template <typename T>
Views views(const void* q, const void* k, const void* v, const long long* strides, int Sq, int Skv) {
  Views w;
  const void* p[3] = {q, k, v};
  for (int z = 0; z < 3; ++z) {
    w.p[z] = p[z];
    w.sb[z] = strides[3 * z];
    w.ss[z] = strides[3 * z + 1];
    w.sh[z] = strides[3 * z + 2];
    w.S[z] = z == 0 ? Sq : Skv;
  }
  return w;
}

template <typename OutT>
int launch_attention(const void* q8, const void* k8, const void* vt8, void* o, const void* consts, int B, int H,
                     int Sq, int Skv, int kv_end, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_int8_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const long long skv_p = (Skv + BK - 1) / BK * BK, bh = static_cast<long long>(B) * H;
  // q8, k8: (64, S, B·H) with 64 × 128-row boxes, 64-byte swizzled (rows
  // past S read as zeros); V̂ᵀ: (skv_p, 64, B·H) with 128 × 64 boxes, 128-byte swizzled
  CUtensorMap tq, tk, tv;
  const int box_qk[3] = {64, 128, 1}, box_v[3] = {BK, 64, 1};
  const long long dq[3] = {64, Sq, bh}, sq_[2] = {64, 64LL * Sq};
  const long long dk[3] = {64, Skv, bh}, sk_[2] = {64, 64LL * Skv};
  const long long dv[3] = {skv_p, 64, bh}, sv_[2] = {skv_p, 64 * skv_p};
  int err = make_map(&tq, q8, 3, dq, sq_, box_qk, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err == 0) err = make_map(&tk, k8, 3, dk, sk_, box_qk, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err == 0) err = make_map(&tv, vt8, 3, dv, sv_, box_v, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err != 0) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, static_cast<unsigned>(bh));
  flash_int8_kernel<OutT><<<grid, THREADS, SMEM, stream>>>(tq, tk, tv, static_cast<OutT*>(o),
                                                          static_cast<const float*>(consts), H, Sq, kv_end);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v: (B, S, H, 64) bf16 (f32 = 0) or fp32 (f32 = 1), head dim
// contiguous, rows 16-byte aligned; strides: 9 element strides (b, s, h) of
// q, k, v in turn. ws: fp32 workspace of 4: amax of q, k, v (zeroed here,
// then reduced into).
int flash_int8_amax(const void* q, const void* k, const void* v, const long long* strides, void* ws, int B, int H,
                    int Sq, int Skv, int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(ws, 0, 3 * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(264, 3);
  if (f32)
    flash_int8_amax_kernel<float>
        <<<grid, 256, 0, st>>>(views<float>(q, k, v, strides, Sq, Skv), B, H, static_cast<float*>(ws));
  else
    flash_int8_amax_kernel<bf16>
        <<<grid, 256, 0, st>>>(views<bf16>(q, k, v, strides, Sq, Skv), B, H, static_cast<float*>(ws));
  return static_cast<int>(cudaGetLastError());
}

// The codes of q, k, v (as flash_int8_amax takes them) against the amax in
// ws[0..2]: q8 (B·H, Sq, 64), k8 (B·H, Skv, 64), vt8 (B·H, 64, Skv rounded
// up to 128), int8, contiguous; consts: fp32 {c_qk, c_v}.
int flash_int8_codes(const void* q, const void* k, const void* v, const long long* strides, const void* ws,
                     void* q8, void* k8, void* vt8, void* consts, int B, int H, int Sq, int Skv, float scale, int f32,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int skv_p = (Skv + BK - 1) / BK * BK;
  const dim3 grid((max(Sq, skv_p) + 127) / 128, B * H, 3);
  const float* amax = static_cast<const float*>(ws);
  if (f32)
    flash_int8_codes_kernel<float><<<grid, 256, 0, st>>>(views<float>(q, k, v, strides, Sq, Skv), H, skv_p, amax, scale,
                                              static_cast<int8_t*>(q8), static_cast<int8_t*>(k8),
                                              static_cast<int8_t*>(vt8), static_cast<float*>(consts));
  else
    flash_int8_codes_kernel<bf16><<<grid, 256, 0, st>>>(views<bf16>(q, k, v, strides, Sq, Skv), H, skv_p, amax, scale,
                                             static_cast<int8_t*>(q8), static_cast<int8_t*>(k8),
                                             static_cast<int8_t*>(vt8), static_cast<float*>(consts));
  return static_cast<int>(cudaGetLastError());
}

// q8, k8, vt8 and consts as flash_int8_codes writes them; o: (B, Sq, H, 64)
// bf16 contiguous. Keys [kv_end, Skv) are excluded; any Skv.
int flash_int8(const void* q8, const void* k8, const void* vt8, void* o, const void* consts, int B, int H, int Sq,
               int Skv, int kv_end, void* stream) {
  return launch_attention<bf16>(q8, k8, vt8, o, consts, B, H, Sq, Skv, kv_end, static_cast<cudaStream_t>(stream));
}

// The same contract with o (B, Sq, H, 64) fp32.
int flash_int8_f32(const void* q8, const void* k8, const void* vt8, void* o, const void* consts, int B, int H,
                   int Sq, int Skv, int kv_end, void* stream) {
  return launch_attention<float>(q8, k8, vt8, o, consts, B, H, Sq, Skv, kv_end, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
