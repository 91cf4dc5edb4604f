// K4: conv3x3(SiLU(GroupNorm(x))) + bias for Hopper (sm_90a), an implicit
// GEMM with the GroupNorm affine and SiLU as its operand prologue.
//
//   a = bf16(SiLU(x · scale + shift)),  y = bf16(conv3x3(pad0(a), w) + b)
//
// x (N, H, W, Cin) bf16 contiguous; w bf16 in the memory order (Cout, 3, 3,
// Cin), which is the torch (Cout, Cin, 3, 3) weight stored channels_last; b
// (Cout,) fp32 or bf16, added in fp32; y (N, H, W, Cout) bf16. The padding
// comes after the activation: a tap outside the image reads 0, not
// SiLU(shift). scale and shift come from stages 1-2 of gn_common.cuh.
//
// Replaces faceposegenerator_tpu/ops/fused_gn_conv.py `_kernel` (:92), whose
// per-(image, channel) statistics JAX computes in XLA (`group_scale_shift`).
//
// What bounds it on the card. The GEMM has M = N·H·W output pixels, N = Cout
// and K = 9·Cin: 2·M·Cout·9·Cin operations against one read of x, one write
// of y and the weights. At the UNet's shapes (Cin, Cout ≥ 320) that is
// over 1000 operations per byte, so the tensor cores bound it.
//
// What the design does about it (wgmma, TMA and a pipelined ring of tiles
// are later work):
//   * A CTA computes 128 output pixels (TR = 128 / TW image rows of a
//     power-of-two width TW ≤ 128: 2 rows of 64, 4 of 32) by 64 output
//     channels, with 8 warps of 32 × 32. For each 32-channel chunk of Cin it
//     loads the (TR + 2) × (TW + 2) halo of x, applies the affine and SiLU
//     once per element, rounds to bf16 and stores it in shared memory (zeros
//     outside the image), and copies the chunk's 64 × 9 × 32 weights with
//     cp.async. The 9 taps are shifted views of the halo tile: each lane
//     hands ldmatrix the address of its own output pixel's neighbour, so no
//     im2col tile is built, and each element is normalised (TR + 2) / TR
//     times per output-channel tile instead of 9 times.
//   * mma.sync m16n8k16 (bf16 in, fp32 accumulate); operands by ldmatrix
//     from rows padded to 80 and 592 bytes, which no two lanes of a phase
//     share a bank in.
//   * Epilogue: the fp32 bias added, rounded once to bf16, masked at the
//     image's edge and at Cout.
//
// Plain C interface, loaded with ctypes: launches on the given stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "gn_common.cuh"

namespace {

constexpr int BM = 128, BN = 64, KC = 32, NTHREADS = 256;
constexpr int HST = KC + 8;       // shared stride of a halo pixel, bf16 (80 bytes)
constexpr int WST = 9 * KC + 8;   // shared stride of an output channel's 9 taps, bf16 (592 bytes)
constexpr int MAX_HALO = 390;     // max over TW of (BM / TW + 2) · (TW + 2), at TW = 1 and 128
constexpr int SMEM = (MAX_HALO * HST + BN * WST) * 2;

__global__ void __launch_bounds__(GN_THREADS) gn_k4_partial(const bf16* __restrict__ x, float* __restrict__ part,
                                                             int S, int C, int rows, int chunks) {
  gn_partial_body<bf16>(x, part, S, C, rows, chunks);
}

__global__ void __launch_bounds__(GN_THREADS) gn_k4_fold(const float* __restrict__ part, const void* gamma,
                                                          const void* beta, int param_bf16, float* __restrict__ affine,
                                                          int chunks, int S, int C, int G, float eps) {
  gn_fold_body(part, gamma, beta, param_bf16, affine, chunks, S, C, G, eps);
}

// grid (ceil(Cout / BN), N · tiles_h · tiles_w); blockIdx.x picks the output
// channels, so the CTAs that share a halo run side by side.
__global__ void __launch_bounds__(NTHREADS, 2)
    gn_k4_conv(const bf16* __restrict__ x, const float* __restrict__ affine, const bf16* __restrict__ w,
               const void* bias, int bias_bf16, bf16* __restrict__ y, int N, int H, int W, int Cin, int Cout,
               int tw_log2, int tiles_h, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  bf16* sW = sA + MAX_HALO * HST;

  const int TW = 1 << tw_log2, TR = BM >> tw_log2, HW2 = TW + 2, HP = (TR + 2) * HW2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;  // this warp's 32 × 32 sub-tile
  const int n0 = blockIdx.x * BN;
  int tile = blockIdx.y;
  const int tx = tile % tiles_w;
  tile /= tiles_w;
  const int ty = tile % tiles_h, img = tile / tiles_h;
  const int y0 = ty * TR, x0 = tx * TW;
  const bf16* xi = x + static_cast<long long>(img) * H * W * Cin;
  const float* scale = affine + static_cast<long long>(img) * Cin;
  const float* shift = affine + static_cast<long long>(N + img) * Cin;

  // ldmatrix rows: A row (lane & 15) of each 16-pixel m-tile at halo pixel
  // hbase + the tap's offset, k half (lane >> 4); B rows: output channel
  // wn + 16p + (lane & 7) + 8 (lane >> 4), k half (lane >> 3) & 1
  int hbase[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int m = wm + mt * 16 + (lane & 15);
    hbase[mt] = (m >> tw_log2) * HW2 + (m & (TW - 1));
  }
  const int koff = (lane >> 4) * 8;
  const int nrow = wn + (lane & 7) + ((lane >> 4) << 3), boff = ((lane >> 3) & 1) * 8;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int vv = tid & 3;  // this thread's 8-channel vector of every halo pixel it loads
  for (int kc = 0; kc < Cin; kc += KC) {
    __syncthreads();  // the previous chunk's operands are read
    // weights: BN output channels × 9 taps × 4 vectors of 8 channels
    for (int i = tid; i < BN * 36; i += NTHREADS) {
      const int nl = i / 36, rem = i - nl * 36, tap = rem >> 2, ci = kc + (rem & 3) * 8, co = n0 + nl;
      const bool live = co < Cout && ci < Cin;
      cp_async_16(sW + nl * WST + tap * KC + (rem & 3) * 8,
                  live ? w + (static_cast<long long>(co) * 9 + tap) * Cin + ci : w, live ? 16 : 0);
    }
    cp_async_commit();
    // halo: normalise, SiLU, round to bf16; zero outside the image and past Cin
    const int ci = kc + vv * 8;
    const bool cl = ci < Cin;
    float sc[8], sh[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j] = cl ? scale[ci + j] : 0.f;
      sh[j] = cl ? shift[ci + j] : 0.f;
    }
    for (int i = tid; i < HP * 4; i += NTHREADS) {
      const int p = i >> 2, hr = p / HW2, hc = p - hr * HW2, gy = y0 - 1 + hr, gx = x0 - 1 + hc;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (cl && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        float e[8];
        load16<bf16>(xi + (static_cast<long long>(gy) * W + gx) * Cin + ci, e);
        out.x = pack_bf16(silu(fmaf(e[0], sc[0], sh[0])), silu(fmaf(e[1], sc[1], sh[1])));
        out.y = pack_bf16(silu(fmaf(e[2], sc[2], sh[2])), silu(fmaf(e[3], sc[3], sh[3])));
        out.z = pack_bf16(silu(fmaf(e[4], sc[4], sh[4])), silu(fmaf(e[5], sc[5], sh[5])));
        out.w = pack_bf16(silu(fmaf(e[6], sc[6], sh[6])), silu(fmaf(e[7], sc[7], sh[7])));
      }
      *reinterpret_cast<uint4*>(sA + p * HST + vv * 8) = out;
    }
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * HW2 + tap % 3;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t af[2][4], bfr[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) ldsm_x4(af[mt], sA + (hbase[mt] + toff) * HST + ks * 16 + koff);
#pragma unroll
        for (int p = 0; p < 2; ++p) ldsm_x4(bfr[p], sW + (nrow + p * 16) * WST + tap * KC + ks * 16 + boff);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_16816(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2], bfr[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
  }

  // epilogue: + fp32 bias, rounded once to bf16; Cout % 8 == 0, so a column
  // pair is whole or out
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn + nt * 8 + 2 * t4;
    if (col >= Cout) continue;
    const float b0 = load_param(bias, col, bias_bf16), b1 = load_param(bias, col + 1, bias_bf16);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + mt * 16 + g + 8 * h;
        const int gy = y0 + (m >> tw_log2), gx = x0 + (m & (TW - 1));
        if (gy < H && gx < W) {
          bf16* yp = y + ((static_cast<long long>(img) * H + gy) * W + gx) * Cout + col;
          *reinterpret_cast<__nv_bfloat162*>(yp) =
              __floats2bfloat162_rn(acc[mt][nt][2 * h] + b0, acc[mt][nt][2 * h + 1] + b1);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x: (N, H, W, Cin) bf16, w: (Cout, 3, 3, Cin) bf16, y: (N, H, W, Cout) bf16,
// all contiguous and 16-byte aligned; gamma, beta: (Cin,) bf16 (param_bf16 =
// 1) or fp32; bias: (Cout,) bf16 (bias_bf16 = 1) or fp32. Cin % 8 == 0, Cin ≤
// 2048, Cin % G == 0, Cout % 8 == 0; the tile width is 2^tw_log2 ≤ 128.
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
  const int tiles_h = (H + TR - 1) / TR, tiles_w = (W + TW - 1) / TW;
  const dim3 grid((Cout + BN - 1) / BN, N * tiles_h * tiles_w);
  gn_k4_conv<<<grid, NTHREADS, SMEM, st>>>(xx, a, static_cast<const bf16*>(w), bias, bias_bf16,
                                           static_cast<bf16*>(y), N, H, W, Cin, Cout, tw_log2, tiles_h, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
