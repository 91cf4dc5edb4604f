// K4: conv3x3(SiLU(GroupNorm(x))) + bias for Hopper (sm_90a), an implicit
// GEMM with the GroupNorm affine and SiLU as its operand prologue.
//
//   a = round(SiLU(x · scale + shift)),  y = round(conv3x3(pad0(a), w) + b)
//
// x (N, H, W, Cin); w in the memory order (Cout, 3, 3, Cin), which is the
// torch (Cout, Cin, 3, 3) weight stored channels_last; b (Cout,) fp32 or
// bf16, added in fp32; y (N, H, W, Cout). `gn_silu_conv3x3` takes bf16 x, w
// and y and rounds a and y to bf16; `gn_silu_conv3x3_f32` takes fp32 ones and
// rounds nothing (JAX's kernel keeps its slab in x's dtype). The padding
// comes after the activation: a tap outside the image reads 0, not
// SiLU(shift). scale and shift come from stages 1-2 of gn_common.cuh.
//
// Replaces faceposegenerator_tpu/ops/fused_gn_conv.py `_kernel` (:92), whose
// per-(image, channel) statistics JAX computes in XLA (`group_scale_shift`).
//
// What bounds it on the card. The GEMM has M = N·H·W output pixels, N = Cout
// and K = 9·Cin: 2·M·Cout·9·Cin operations against one read of x, one write
// of y and the weights. At the UNet's shapes (Cin, Cout >= 320) that is over
// 1000 operations per byte, so the tensor cores bound it; what each CTA
// re-reads from L2 (the weight tile, once per 128 pixels) comes next.
//
// The bf16 design (wgmma, TMA, warp specialisation; sm90_common.cuh). A CTA
// computes 128 output pixels (a power-of-two tile width TW in [2, 64] of
// 128 / TW image rows: 2 rows of 64, 4 of 32) by 160 output channels (a
// legal wgmma N: 320 = 2 · 160, 640 = 4 · 160), over chunks of 64 input
// channels. Three roles, 512 threads:
//   * a producer thread issues TMA loads: the raw x halo of a chunk,
//     (TR + 2) × (TW + 2) pixels × 64 channels (one 128-byte row a pixel;
//     the tensor map's out-of-bounds fill gives 0 outside the image and past
//     Cin), into a ring of 2 stages; and per tap the 160 × 64 weight tile,
//     K-major with the 128-byte swizzle, into a ring of 4 stages, all on
//     mbarriers. x of chunk c + 1 goes out before the weights of chunk c.
//   * 7 normaliser warps turn each raw halo chunk into the activation once
//     per CTA: affine, SiLU and one rounding to bf16, written 0 outside the
//     image (the fill gave raw 0, but SiLU(shift) != 0), into a
//     double-buffered A halo whose 16-byte channel groups are XOR-swizzled by
//     the pixel's low 3 bits. So chunk c + 1 is normalised while chunk c's
//     9 taps run, and each input element is normalised (TR + 2) / TR ×
//     Cout / 160 times in all (4 at 64²·320→320, where the earlier mma.sync
//     kernel with 64-channel tiles did it 10 times).
//   * 2 consumer warpgroups of 64 pixels each: per tap, the A operand in
//     registers (wgmma's RS form), 4 ldmatrix.x4 from per-lane addresses
//     (each lane's own pixel shifted by the tap; the swizzle keeps the 8
//     rows of a phase on distinct banks), then 4 wgmma m64n160k16 with B
//     from the weight stage. A warpgroup waits for its tap's products
//     before it loads the next tap's fragments (else ptxas serialises every
//     wgmma, C7513); the two warpgroups' taps interleave on the tensor
//     cores, so one's loads run under the other's products. The A operand
//     could not come from shared memory by descriptor (the SS form): the 64
//     rows of an m64 operand must be evenly spaced there, and at W = 32 the
//     2 pad pixels of the halo split them into two image rows.
// Epilogue: the fp32 bias added, rounded once to bf16, masked at the
// image's edge and at Cout. The statistics (two launches before the conv)
// fold in a fixed order: the kernel is deterministic.
//
// Plain C interface, loaded with ctypes: launches on the given stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int BM = 128, BN = 160, KC = 64;  // pixels, output channels, input channels a chunk
constexpr int W_STAGES = 4, X_STAGES = 2;
constexpr int PIX_BYTES = KC * 2;                  // one pixel's chunk: 128 bytes
constexpr int HALO_MAX = 264;                      // max over TW in [2, 64] of (128 / TW + 2) · (TW + 2)
constexpr int HALO_BYTES = HALO_MAX * PIX_BYTES;   // 33,792: a multiple of 1024
constexpr int W_BYTES = BN * PIX_BYTES;            // 20,480: one tap of the weight tile
constexpr int X_OFF = W_STAGES * W_BYTES, A_OFF = X_OFF + X_STAGES * HALO_BYTES;
constexpr int BAR_OFF = A_OFF + 2 * HALO_BYTES;
constexpr int NBAR = 2 * W_STAGES + 4 * X_STAGES;  // weights full/empty; x full/empty; A full/empty
constexpr int SMEM = BAR_OFF + 8 * NBAR + 1024;    // and room to align the base to 1024 bytes
// with 3 normaliser warps the normalisation was the kernel's longest path
// (perf/torch_conv_ablate.py; PERF.md), so they are 7
constexpr int THREADS = 512, NORM_THREADS = 224;
// the launch gives every thread 65536 / 512 = 128 registers; the producer and
// normaliser warpgroups give back what the consumers take
constexpr int AUX_REGS = 72, CONSUMER_REGS = 184;
static_assert(128 * (2 * AUX_REGS + 2 * CONSUMER_REGS) <= 128 * THREADS, "register file");
static_assert(SMEM <= 232448, "shared memory");

__global__ void __launch_bounds__(GN_THREADS) gn_k4_partial(const bf16* __restrict__ x, float* __restrict__ part,
                                                             int S, int C, int rows, int chunks) {
  gn_partial_body<bf16>(x, part, S, C, rows, chunks);
}

__global__ void __launch_bounds__(GN_THREADS) gn_k4_fold(const float* __restrict__ part, const void* gamma,
                                                          const void* beta, int param_bf16, float* __restrict__ affine,
                                                          int chunks, int S, int C, int G, float eps) {
  gn_fold_body(part, gamma, beta, param_bf16, affine, chunks, S, C, G, eps);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes of shared memory at a 32-bit shared address
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n" : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ uint32_t act2(uint32_t raw, float sc0, float sh0, float sc1, float sh1) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float a = fmaf(__low2float(h), sc0, sh0), b = fmaf(__high2float(h), sc1, sh1);
  __nv_bfloat162 o = __floats2bfloat162_rn(__fdividef(a, 1.f + __expf(-a)), __fdividef(b, 1.f + __expf(-b)));
  return *reinterpret_cast<uint32_t*>(&o);
}

// grid (ceil(Cout / 160), N · tiles_h · tiles_w); blockIdx.x picks the output
// channels, so the CTAs that share a halo run side by side.
__global__ void __launch_bounds__(THREADS, 1)
    gn_k4_conv(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
               const float* __restrict__ affine, const void* bias, int bias_bf16, bf16* __restrict__ y, int N, int H,
               int W, int Cin, int Cout, int tw_log2, int tiles_h, int tiles_w) {
  extern __shared__ __align__(1024) unsigned char smem_k4[];
  const uint32_t raw_base = smem_u32(smem_k4), base = (raw_base + 1023u) & ~1023u;
  unsigned char* gbase = smem_k4 + (base - raw_base);  // the same bytes, as a generic pointer
  const uint32_t sW = base, sX = base + X_OFF, sA = base + A_OFF, bars = base + BAR_OFF;
  // mbarriers: weights full [0, 4), weights empty [4, 8), x full, x empty, A full, A empty (2 each)
  auto w_full = [&](int s) { return bars + 8 * s; };
  auto w_empty = [&](int s) { return bars + 8 * (W_STAGES + s); };
  auto x_full = [&](int s) { return bars + 8 * (2 * W_STAGES + s); };
  auto x_empty = [&](int s) { return bars + 8 * (2 * W_STAGES + 2 + s); };
  auto a_full = [&](int s) { return bars + 8 * (2 * W_STAGES + 4 + s); };
  auto a_empty = [&](int s) { return bars + 8 * (2 * W_STAGES + 6 + s); };

  const int TW = 1 << tw_log2, TR = BM >> tw_log2, HW2 = TW + 2, HP = (TR + 2) * HW2;
  const int n0 = blockIdx.x * BN;
  int tile = blockIdx.y;
  const int tile_x = tile % tiles_w;
  tile /= tiles_w;
  const int tile_y = tile % tiles_h, img = tile / tiles_h;
  const int y0 = tile_y * TR, x0 = tile_x * TW;
  const int n_chunks = (Cin + KC - 1) / KC;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < X_STAGES; ++s) {
      mbar_init(x_full(s), 1);
      mbar_init(x_empty(s), NORM_THREADS);
      mbar_init(a_full(s), NORM_THREADS);
      mbar_init(a_empty(s), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg >= 2) {
    setmaxnreg_dec<AUX_REGS>();
    const int t = threadIdx.x - 256;
    if (t == 0) {  // producer
      const uint32_t x_bytes = HP * PIX_BYTES;
      auto load_x = [&](int c) {
        const int s = c & 1;
        mbar_wait(x_empty(s), ((c >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(x_full(s), x_bytes);
        tma_load_4d(sX + s * HALO_BYTES, &tm_x, x_full(s), c * KC, x0 - 1, y0 - 1, img);
      };
      load_x(0);
      for (int c = 0; c < n_chunks; ++c) {
        if (c + 1 < n_chunks) load_x(c + 1);
        for (int tap = 0; tap < 9; ++tap) {
          const int u = c * 9 + tap, s = u % W_STAGES;
          mbar_wait(w_empty(s), ((u / W_STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(w_full(s), W_BYTES);
          tma_load_3d(sW + s * W_BYTES, &tm_w, w_full(s), c * KC, tap, n0);
        }
      }
    } else if (t >= 32) {  // normaliser: thread t - 32 takes channel group g of every 28th pixel
      const int nt = t - 32, g = nt & 7, p0 = nt >> 3, hr0 = p0 / HW2;
      const float* scale = affine + static_cast<long long>(img) * Cin;
      const float* shift = affine + static_cast<long long>(N + img) * Cin;
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c & 1;
        const uint32_t ph = (c >> 1) & 1;
        const int ci = c * KC + g * 8;
        float sc[8], sh[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // 0 past Cin: SiLU(0) = 0
          sc[j] = ci + j < Cin ? scale[ci + j] : 0.f;
          sh[j] = ci + j < Cin ? shift[ci + j] : 0.f;
        }
        const unsigned char* xs = gbase + X_OFF + s * HALO_BYTES;
        unsigned char* as = gbase + A_OFF + s * HALO_BYTES;
        mbar_wait(x_full(s), ph);
        mbar_wait(a_empty(s), ph ^ 1);
        int hr = hr0, hc = p0 - hr0 * HW2;
        for (int p = p0; p < HP; p += NORM_THREADS / 8) {
          const int gy = y0 - 1 + hr, gx = x0 - 1 + hc;
          uint4 out = make_uint4(0u, 0u, 0u, 0u);
          if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
            const uint4 r = *reinterpret_cast<const uint4*>(xs + p * PIX_BYTES + g * 16);
            out.x = act2(r.x, sc[0], sh[0], sc[1], sh[1]);
            out.y = act2(r.y, sc[2], sh[2], sc[3], sh[3]);
            out.z = act2(r.z, sc[4], sh[4], sc[5], sh[5]);
            out.w = act2(r.w, sc[6], sh[6], sc[7], sh[7]);
          }
          *reinterpret_cast<uint4*>(as + p * PIX_BYTES + ((g ^ (p & 7)) << 4)) = out;
          for (hc += NORM_THREADS / 8; hc >= HW2; hc -= HW2) ++hr;
        }
        mbar_arrive(x_empty(s));
        mbar_arrive(a_full(s));
      }
    }
  } else {  // consumers: warpgroup wg computes pixels 64·wg .. 64·wg + 63
    setmaxnreg_inc<CONSUMER_REGS>();
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    // ldmatrix: lane l gives the address of A row l % 16 (its pixel), channel half l / 16
    const int m = 64 * wg + 16 * w + (lane & 15), half = lane >> 4;
    const int hbase = (m >> tw_log2) * HW2 + (m & (TW - 1));
    float acc[80];
#pragma unroll
    for (int i = 0; i < 80; ++i) acc[i] = 0.f;
    fence_regs(acc);  // zeroed here, not later next to a wgmma in flight
    uint32_t af[16];
    for (int c = 0; c < n_chunks; ++c) {
      mbar_wait(a_full(c & 1), (c >> 1) & 1);
      const uint32_t abuf = sA + (c & 1) * HALO_BYTES;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int hp = hbase + (tap / 3) * HW2 + tap % 3;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) ldsm_x4(af + 4 * ks, abuf + hp * PIX_BYTES + (((2 * ks + half) ^ (hp & 7)) << 4));
        const int u = c * 9 + tap, s = u % W_STAGES;
        mbar_wait(w_full(s), (u / W_STAGES) & 1);
        fence_regs(af);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_rs_m64n160_k(acc, af[4 * ks], af[4 * ks + 1], af[4 * ks + 2], af[4 * ks + 3],
                             desc_k(sW + s * W_BYTES + 32 * ks));
        wgmma_commit();
        // ptxas serialises every wgmma of the kernel if a register they read
        // is written while a product is in flight (C7513), so the next tap's
        // fragments load after this tap's products are done; the other
        // consumer warpgroup's products fill the tensor cores meanwhile
        wgmma_wait<0>();
        fence_regs(af);
        mbar_arrive_if(w_empty(s), lane == 0);
      }
      mbar_arrive_if(a_empty(c & 1), lane == 0);
    }
    fence_regs(acc);

    // epilogue: + fp32 bias, rounded once to bf16; Cout % 8 == 0, so a
    // column pair is whole or out
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mm = 64 * wg + 16 * w + g + 8 * h;
      const int gy = y0 + (mm >> tw_log2), gx = x0 + (mm & (TW - 1));
      if (gy >= H || gx >= W) continue;
      bf16* yp = y + ((static_cast<long long>(img) * H + gy) * W + gx) * Cout;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int co = n0 + 8 * i + 2 * t4;
        if (co < Cout)
          *reinterpret_cast<__nv_bfloat162*>(yp + co) =
              __floats2bfloat162_rn(acc[4 * i + 2 * h] + load_param(bias, co, bias_bf16),
                                    acc[4 * i + 2 * h + 1] + load_param(bias, co + 1, bias_bf16));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 (gn_silu_conv3x3_f32): x, w and y fp32, for the fp32 compute policy.
// JAX's K4 keeps its slab in x's dtype, so the activation is not rounded.
//
// What bounds it: the same GEMM, in fp32. FFMA on the CUDA cores peaks at
// 67 TFLOP/s; tf32 wgmma at 495, but one tf32 product rounds each operand to
// 11 significant bits, which misses the fp32 gate (tests/test_torch_tf32_conv.py
// shows it). So the kernel runs 3xTF32, as flash_f32.cu does: each operand
// split as hi = rna_tf32(v), lo = rna_tf32(v − hi), each product
// a_lo·w_hi + a_hi·w_lo + a_hi·w_hi (the bound: 3 × operations / 495 TFLOP/s).
//
// The design is the bf16 kernel's above, carried over to tf32:
//   * a CTA computes the same 128 pixels × 160 output channels; a chunk is
//     32 fp32 input channels, 128 bytes a pixel, the swizzle atom of the bf16
//     kernel's 64 channels, so the halo, its XOR swizzle and the consumers'
//     per-lane ldmatrix addresses are the bf16 kernel's: a b16 8×8 matrix is
//     8 pixels × 4 fp32 channels, and ldmatrix.x4 of one k8 slice delivers
//     the tf32 A fragment (rows g, g + 8; k = t, t + 4) as it is (the test
//     emulates the addresses);
//   * the A operand is split in registers: the normalisers write one fp32
//     plane SiLU(x·scale + shift) (0 outside the image); each consumer splits
//     the 16 values it loads for a tap (~50 ALU operations a thread against
//     12 wgmma of ~80 clocks each), so shared memory holds one A plane, not two;
//   * the B operand is split before the kernel: wgmma reads B only from
//     shared memory, and tf32 only K-major, which the (Cout, 3, 3, Cin)
//     weight already is. `gn_conv_f32_split` (one launch a call, no cache
//     across calls) writes its tf32 hi and lo planes; a tap's TMA box holds
//     both, 160 × 32 × 4 B each = 40,960 B;
//   * per tap and k8 slice, three wgmma m64n160k8 tf32 RS, small terms first;
//   * accuracy: the tensor cores add each product into the fp32 accumulator
//     with truncation, and one chain of 9·Cin/8 × 3 adds (2160 at Cin = 640)
//     drifts to the fp32 gate's mean limit (the CPU emulation). So each
//     32-channel chunk (108 products) goes into a fresh accumulator that an
//     FADD adds to the running one: 80 more registers a consumer thread;
//   * roles, 384 threads: warpgroups 0-1 consume (setmaxnreg 232: the two
//     80-value accumulators and 32 hi/lo fragment registers fit), warpgroup
//     2 holds the TMA producer thread and 3 normaliser warps (setmaxnreg 40:
//     they address shared memory by 32-bit address, through ld/st.shared).
//     Three normaliser warps suffice where the bf16 kernel needed 7: an fp32
//     chunk has half the channels of a bf16 one and six times its
//     tensor-core time (9 taps × 12 tf32 wgmma against 9 × 4 bf16);
//   * shared memory (232,448 B): a weight ring of 3 taps (3 × 40,960 B), one
//     raw-x halo (33,792) and two A halos: 224,256 B. One raw stage is
//     enough, since the normalisers wait for a free A halo anyway: chunk
//     c + 1's raw halo loads while the consumers run chunk c − 1, and is
//     normalised while they run chunk c. Of the layouts that fit (a raw ring
//     of 2 leaves a weight ring of 2), this one keeps three taps of weights
//     in flight, so a tap's 40 KB from L2 has two taps' products to arrive in.
// ---------------------------------------------------------------------------

constexpr int F_KC = 32;                             // fp32 input channels a chunk: 128 bytes a pixel
constexpr int F_W_STAGES = 3;
constexpr int F_W_PLANE = BN * PIX_BYTES;            // 20,480: one tap's hi (or lo) weight tile
constexpr int F_W_BYTES = 2 * F_W_PLANE;             // hi and lo
constexpr int F_X_OFF = F_W_STAGES * F_W_BYTES, F_A_OFF = F_X_OFF + HALO_BYTES;
constexpr int F_BAR_OFF = F_A_OFF + 2 * HALO_BYTES;
constexpr int F_NBAR = 2 * F_W_STAGES + 2 + 4;       // weights full/empty; x full, empty; A full/empty
constexpr int F_SMEM = F_BAR_OFF + 8 * F_NBAR + 1024;
constexpr int F_THREADS = 384, F_NORM_THREADS = 96;
constexpr int F_AUX_REGS = 40, F_CONSUMER_REGS = 232;
// the launch allocates 168 registers a thread (65536 / 384, rounded down to
// 8); setmaxnreg.inc waits until the other warpgroups' decs have freed what
// it takes, so the counts must fit in that allocation, not in 65536
static_assert(128 * (F_AUX_REGS + 2 * F_CONSUMER_REGS) <= F_THREADS * 168, "register file");
static_assert(F_SMEM <= 232448, "shared memory");

__global__ void __launch_bounds__(GN_THREADS) gn_k4_partial_f32(const float* __restrict__ x, float* __restrict__ part,
                                                                 int S, int C, int rows, int chunks) {
  gn_partial_body<float>(x, part, S, C, rows, chunks);
}

// The weight pre-pass: n4 float4 of w to their tf32 hi (out[0, n4)) and lo
// (out[n4, 2·n4)) parts.
__global__ void __launch_bounds__(256) gn_conv_f32_split_kernel(const float4* __restrict__ w, float4* __restrict__ out,
                                                                 int n4) {
  for (int i = blockIdx.x * 256 + threadIdx.x; i < n4; i += gridDim.x * 256) {
    const float4 v = w[i];
    uint32_t h[4], l[4];
    tf32_split(v.x, h[0], l[0]);
    tf32_split(v.y, h[1], l[1]);
    tf32_split(v.z, h[2], l[2]);
    tf32_split(v.w, h[3], l[3]);
    out[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
    out[n4 + i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// grid (ceil(Cout / 160), N · tiles_h · tiles_w), as gn_k4_conv.
__global__ void __launch_bounds__(F_THREADS, 1)
    gn_k4_conv_f32(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                   const float* __restrict__ affine, const void* bias, int bias_bf16, float* __restrict__ y, int N,
                   int H, int W, int Cin, int Cout, int tw_log2, int tiles_h, int tiles_w) {
  extern __shared__ __align__(1024) unsigned char smem_k4f[];
  const uint32_t base = (smem_u32(smem_k4f) + 1023u) & ~1023u;
  const uint32_t sW = base, sX = base + F_X_OFF, sA = base + F_A_OFF, bars = base + F_BAR_OFF;
  // mbarriers: weights full [0, 3), weights empty [3, 6), x full, x empty, A full (2), A empty (2)
  auto w_full = [&](int s) { return bars + 8 * s; };
  auto w_empty = [&](int s) { return bars + 8 * (F_W_STAGES + s); };
  const uint32_t x_full = bars + 8 * (2 * F_W_STAGES), x_empty = x_full + 8;
  auto a_full = [&](int s) { return x_full + 16 + 8 * s; };
  auto a_empty = [&](int s) { return x_full + 32 + 8 * s; };

  const int TW = 1 << tw_log2, TR = BM >> tw_log2, HW2 = TW + 2, HP = (TR + 2) * HW2;
  const int n0 = blockIdx.x * BN;
  int tile = blockIdx.y;
  const int tile_x = tile % tiles_w;
  tile /= tiles_w;
  const int tile_y = tile % tiles_h, img = tile / tiles_h;
  const int y0 = tile_y * TR, x0 = tile_x * TW;
  const int n_chunks = (Cin + F_KC - 1) / F_KC;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F_W_STAGES; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init(x_full, 1);
    mbar_init(x_empty, F_NORM_THREADS);
    for (int s = 0; s < 2; ++s) {
      mbar_init(a_full(s), F_NORM_THREADS);
      mbar_init(a_empty(s), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<F_AUX_REGS>();
    const int t = threadIdx.x - 256;
    if (t == 0) {  // producer
      const uint32_t x_bytes = HP * PIX_BYTES;
      auto load_x = [&](int c) {
        mbar_wait(x_empty, (c & 1) ^ 1);
        mbar_arrive_expect_tx(x_full, x_bytes);
        tma_load_4d(sX, &tm_x, x_full, c * F_KC, x0 - 1, y0 - 1, img);
      };
      load_x(0);
      for (int c = 0; c < n_chunks; ++c) {
        if (c + 1 < n_chunks) load_x(c + 1);
        for (int tap = 0; tap < 9; ++tap) {
          const int u = c * 9 + tap, s = u % F_W_STAGES;
          mbar_wait(w_empty(s), ((u / F_W_STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(w_full(s), F_W_BYTES);
          tma_load_4d(sW + s * F_W_BYTES, &tm_w, w_full(s), c * F_KC, tap, n0, 0);
        }
      }
    } else if (t >= 32) {  // normaliser: thread t - 32 takes channel group g (4 channels) of every 12th pixel
      const int nt = t - 32, g = nt & 7, p0 = nt >> 3;
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c & 1, ci = c * F_KC + g * 4;
        // Cin % 4 == 0: a group is whole or past Cin, where 0 gives SiLU(0) = 0
        float4 sc = make_float4(0.f, 0.f, 0.f, 0.f), sh = sc;
        if (ci < Cin) {
          sc = *reinterpret_cast<const float4*>(affine + static_cast<long long>(img) * Cin + ci);
          sh = *reinterpret_cast<const float4*>(affine + static_cast<long long>(N + img) * Cin + ci);
        }
        const uint32_t xs = sX + g * 16, as = sA + s * HALO_BYTES;
        mbar_wait(x_full, c & 1);
        mbar_wait(a_empty(s), ((c >> 1) & 1) ^ 1);
        int hr = p0 / HW2, hc = p0 - hr * HW2;
        for (int p = p0; p < HP; p += F_NORM_THREADS / 8) {
          const int gy = y0 - 1 + hr, gx = x0 - 1 + hc;
          float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
          if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
            const float4 r = lds128(xs + p * PIX_BYTES);
            out = make_float4(silu(fmaf(r.x, sc.x, sh.x)), silu(fmaf(r.y, sc.y, sh.y)), silu(fmaf(r.z, sc.z, sh.z)),
                              silu(fmaf(r.w, sc.w, sh.w)));
          }
          sts128(as + p * PIX_BYTES + ((g ^ (p & 7)) << 4), out);
          for (hc += F_NORM_THREADS / 8; hc >= HW2; hc -= HW2) ++hr;
        }
        mbar_arrive(x_empty);
        mbar_arrive(a_full(s));
      }
    }
  } else {  // consumers: warpgroup wg computes pixels 64·wg .. 64·wg + 63
    setmaxnreg_inc<F_CONSUMER_REGS>();
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    // ldmatrix: lane l gives the address of A row l % 16 (its pixel), 16-byte group 2·kk + l / 16
    const int m = 64 * wg + 16 * w + (lane & 15), half = lane >> 4;
    const int hbase = (m >> tw_log2) * HW2 + (m & (TW - 1));
    float acc[80], part[80];  // the running sum; this chunk's products
#pragma unroll
    for (int i = 0; i < 80; ++i) acc[i] = 0.f;
    fence_regs(acc);  // zeroed here, not later next to a wgmma in flight
    uint32_t ah[16], al[16];
    for (int c = 0; c < n_chunks; ++c) {
      mbar_wait(a_full(c & 1), (c >> 1) & 1);
      const uint32_t abuf = sA + (c & 1) * HALO_BYTES;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int hp = static_cast<int>(opaque(hbase)) + (tap / 3) * HW2 + tap % 3;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) ldsm_x4(ah + 4 * kk, abuf + hp * PIX_BYTES + (((2 * kk + half) ^ (hp & 7)) << 4));
#pragma unroll
        for (int i = 0; i < 16; ++i) {  // the 3xTF32 split of the activation, in registers
          const float a = __uint_as_float(ah[i]);
          ah[i] = tf32_rna(a);
          al[i] = tf32_rna(a - __uint_as_float(ah[i]));
        }
        const int u = c * 9 + tap, s = u % F_W_STAGES;
        mbar_wait(w_full(s), (u / F_W_STAGES) & 1);
        const uint32_t wb = sW + s * F_W_BYTES;
        fence_regs(ah);
        fence_regs(al);
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // small terms first; the chunk's first product starts `part`
          const int f = 4 * kk;
          wgmma_tf32_rs_m64n160(part, al[f], al[f + 1], al[f + 2], al[f + 3], desc_k(opaque(wb) + 32 * kk),
                                tap > 0 || kk > 0);
          wgmma_tf32_rs_m64n160(part, ah[f], ah[f + 1], ah[f + 2], ah[f + 3],
                                desc_k(opaque(wb) + F_W_PLANE + 32 * kk), 1);
          wgmma_tf32_rs_m64n160(part, ah[f], ah[f + 1], ah[f + 2], ah[f + 3], desc_k(opaque(wb) + 32 * kk), 1);
        }
        wgmma_commit();
        // as in the bf16 kernel: the next tap's fragments load after this
        // tap's products are done (C7513); the other warpgroup's products
        // fill the tensor cores meanwhile
        wgmma_wait<0>();
        fence_regs(ah);
        fence_regs(al);
        fence_regs(part);
        mbar_arrive_if(w_empty(s), lane == 0);
      }
      mbar_arrive_if(a_empty(c & 1), lane == 0);
#pragma unroll
      for (int i = 0; i < 80; ++i) acc[i] += part[i];
      fence_regs(acc);
    }

    // epilogue: + fp32 bias; Cout % 8 == 0, so a column pair is whole or out
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mm = 64 * wg + 16 * w + g + 8 * h;
      const int gy = y0 + (mm >> tw_log2), gx = x0 + (mm & (TW - 1));
      if (gy >= H || gx >= W) continue;
      float* yp = y + ((static_cast<long long>(img) * H + gy) * W + gx) * Cout;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int co = n0 + 8 * i + 2 * t4;
        if (co < Cout)
          *reinterpret_cast<float2*>(yp + co) = make_float2(acc[4 * i + 2 * h] + load_param(bias, co, bias_bf16),
                                                            acc[4 * i + 2 * h + 1] + load_param(bias, co + 1, bias_bf16));
      }
    }
  }
}

}  // namespace

extern "C" {

// x: (N, H, W, Cin) bf16, w: (Cout, 3, 3, Cin) bf16, y: (N, H, W, Cout) bf16,
// all contiguous and 16-byte aligned; gamma, beta: (Cin,) bf16 (param_bf16 =
// 1) or fp32; bias: (Cout,) bf16 (bias_bf16 = 1) or fp32. Cin % 8 == 0, Cin ≤
// 2048, Cin % G == 0, Cout % 8 == 0; the tile width is 2^tw_log2 in [2, 64].
// part and affine: the statistics' scratch buffers (2 · N · chunks · Cin and
// 2 · N · Cin fp32), `rows` and `chunks` as in fused_group_norm.
int gn_silu_conv3x3(const void* x, const void* gamma, const void* beta, const void* w, const void* bias, void* y,
                    void* part, void* affine, int N, int H, int W, int Cin, int Cout, int G, float eps, int rows,
                    int chunks, int param_bf16, int bias_bf16, int tw_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xx = static_cast<const bf16*>(x);
  float* p = static_cast<float*>(part);
  float* a = static_cast<float*>(affine);
  gn_k4_partial<<<dim3(chunks, N), GN_THREADS, 0, st>>>(xx, p, H * W, Cin, rows, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_k4_fold<<<N, GN_THREADS, 0, st>>>(p, gamma, beta, param_bf16, a, chunks, H * W, Cin, G, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool smem_set = false;
  if (!smem_set) {
    err = cudaFuncSetAttribute(gn_k4_conv, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int TW = 1 << tw_log2, TR = BM / TW;
  // x as (Cin, W, H, N), a box the (TR + 2) × (TW + 2) halo of 64 channels;
  // w as (Cin, 9, Cout), a box one tap of 64 channels × 160 output channels
  CUtensorMap tm_x, tm_w;
  const long long x_dims[4] = {Cin, W, H, N}, x_strides[3] = {2LL * Cin, 2LL * W * Cin, 2LL * H * W * Cin};
  const int x_box[4] = {KC, TW + 2, TR + 2, 1};
  const long long w_dims[3] = {Cin, 9, Cout}, w_strides[2] = {2LL * Cin, 18LL * Cin};
  const int w_box[3] = {KC, 1, BN};
  int e = make_map(&tm_x, x, 4, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == 0) e = make_map(&tm_w, w, 3, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != 0) return e;
  const int tiles_h = (H + TR - 1) / TR, tiles_w = (W + TW - 1) / TW;
  const dim3 grid((Cout + BN - 1) / BN, N * tiles_h * tiles_w);
  gn_k4_conv<<<grid, THREADS, SMEM, st>>>(tm_x, tm_w, a, bias, bias_bf16, static_cast<bf16*>(y), N, H, W, Cin, Cout,
                                          tw_log2, tiles_h, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

// The same contract with x, w and y fp32, where w is the weight's tf32
// split, (2, Cout, 3, 3, Cin) fp32 contiguous (gn_conv_f32_split), and Cin % 4
// == 0.
int gn_silu_conv3x3_f32(const void* x, const void* gamma, const void* beta, const void* w, const void* bias, void* y,
                        void* part, void* affine, int N, int H, int W, int Cin, int Cout, int G, float eps, int rows,
                        int chunks, int param_bf16, int bias_bf16, int tw_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xx = static_cast<const float*>(x);
  float* p = static_cast<float*>(part);
  float* a = static_cast<float*>(affine);
  gn_k4_partial_f32<<<dim3(chunks, N), GN_THREADS, 0, st>>>(xx, p, H * W, Cin, rows, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_k4_fold<<<N, GN_THREADS, 0, st>>>(p, gamma, beta, param_bf16, a, chunks, H * W, Cin, G, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool smem_set = false;
  if (!smem_set) {
    err = cudaFuncSetAttribute(gn_k4_conv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int TW = 1 << tw_log2, TR = BM / TW;
  // x as (Cin, W, H, N), a box the (TR + 2) × (TW + 2) halo of 32 channels;
  // the split weight as (Cin, 9, Cout, 2), a box one tap of 32 channels ×
  // 160 output channels × both planes
  CUtensorMap tm_x, tm_w;
  const long long x_dims[4] = {Cin, W, H, N}, x_strides[3] = {4LL * Cin, 4LL * W * Cin, 4LL * H * W * Cin};
  const int x_box[4] = {F_KC, TW + 2, TR + 2, 1};
  const long long w_dims[4] = {Cin, 9, Cout, 2}, w_strides[3] = {4LL * Cin, 36LL * Cin, 36LL * Cin * Cout};
  const int w_box[4] = {F_KC, 1, BN, 2};
  int e = make_map(&tm_x, x, 4, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (e == 0)
    e = make_map(&tm_w, w, 4, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (e != 0) return e;
  const int tiles_h = (H + TR - 1) / TR, tiles_w = (W + TW - 1) / TW;
  const dim3 grid((Cout + BN - 1) / BN, N * tiles_h * tiles_w);
  gn_k4_conv_f32<<<grid, F_THREADS, F_SMEM, st>>>(tm_x, tm_w, a, bias, bias_bf16, static_cast<float*>(y), N, H, W,
                                                  Cin, Cout, tw_log2, tiles_h, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

// w: n fp32 (n % 4 == 0, 16-byte aligned); out: 2·n fp32, the tf32 hi parts
// of w in [0, n) and the lo parts in [n, 2·n), in w's order.
int gn_conv_f32_split(const void* w, void* out, int n, void* stream) {
  if (n % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int n4 = n / 4, blocks = (n4 + 255) / 256 < 1056 ? (n4 + 255) / 256 : 1056;
  gn_conv_f32_split_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(w), static_cast<float4*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
