// K3: GroupNorm(+SiLU) over channels-last tensors for Hopper (sm_90a).
//
//   y = act(x · scale + shift)   (per-(image, channel) fp32 scale and shift, gn_common.cuh)
//
// x and y (N, S, C) bf16 or fp32, contiguous; gamma and beta (C,) fp32 or
// bf16; act is SiLU or none; y is rounded once to x's dtype.
//
// Replaces faceposegenerator_tpu/ops/fused_gn.py `_gn_slab_kernel` (:76).
//
// What bounds it on the card: bytes. The work is a few operations per
// element against one read of x and one write of y, far below the ridge,
// so the least time is 2 · N·S·C · sizeof(T) / 3.35 TB/s.
//
// What the design does about it: the TPU kernel reads each image once,
// keeping it in VMEM between its statistics and its normalisation. An image
// does not fit an SM here, so x is read twice: by the statistics pass (stages
// 1-2 of gn_common.cuh) and by the apply pass below, which may find part of
// it still in the 50 MB L2. The apply pass uses the statistics pass's grid
// and thread layout, so each thread loads its VEC channels' scale and shift
// once and streams 16-byte loads and stores along C.
//
// Plain C interface, loaded with ctypes: launches on the given stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(GN_THREADS) gn_k3_partial(const T* __restrict__ x, float* __restrict__ part,
                                                             int S, int C, int rows, int chunks) {
  gn_partial_body<T>(x, part, S, C, rows, chunks);
}

__global__ void __launch_bounds__(GN_THREADS) gn_k3_fold(const float* __restrict__ part, const void* gamma,
                                                          const void* beta, int param_bf16, float* __restrict__ affine,
                                                          int chunks, int S, int C, int G, float eps) {
  gn_fold_body(part, gamma, beta, param_bf16, affine, chunks, S, C, G, eps);
}

// Stage 3: y = act(x · scale + shift) over the rows of chunk blockIdx.x of
// image blockIdx.y, with the thread layout of stage 1.
template <typename T>
__global__ void __launch_bounds__(GN_THREADS) gn_k3_apply(const T* __restrict__ x, const float* __restrict__ affine,
                                                           T* __restrict__ y, int S, int C, int rows, int act_silu) {
  constexpr int VEC = Vec16<T>::N;
  const int vpr = C / VEC, lanes = GN_THREADS / vpr;
  const int t = threadIdx.x, v = t % vpr, lane = t / vpr;
  if (lane >= lanes) return;
  const int n = blockIdx.y, N = gridDim.y;
  const int r0 = blockIdx.x * rows, r1 = min(S, r0 + rows);
  float sc[VEC], sh[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sc[i] = affine[static_cast<long long>(n) * C + v * VEC + i];
    sh[i] = affine[static_cast<long long>(N + n) * C + v * VEC + i];
  }
  const long long base = static_cast<long long>(n) * S * C + v * VEC;
  for (int r = r0 + lane; r < r1; r += lanes) {
    float e[VEC];
    load16<T>(x + base + static_cast<long long>(r) * C, e);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float f = fmaf(e[i], sc[i], sh[i]);
      e[i] = act_silu ? silu(f) : f;
    }
    store16<T>(y + base + static_cast<long long>(r) * C, e);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y, float* part, float* affine, int N,
                   int S, int C, int G, float eps, int act_silu, int rows, int chunks, int param_bf16,
                   cudaStream_t st) {
  const dim3 grid(chunks, N);
  gn_k3_partial<T><<<grid, GN_THREADS, 0, st>>>(static_cast<const T*>(x), part, S, C, rows, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_k3_fold<<<N, GN_THREADS, 0, st>>>(part, gamma, beta, param_bf16, affine, chunks, S, C, G, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_k3_apply<T><<<grid, GN_THREADS, 0, st>>>(static_cast<const T*>(x), affine, static_cast<T*>(y), S, C, rows,
                                               act_silu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (N, S, C) bf16 (x_bf16 = 1) or fp32, contiguous, 16-byte aligned;
// gamma, beta: (C,) bf16 (param_bf16 = 1) or fp32. C % (16 / sizeof x) == 0,
// C ≤ 256 · 16 / sizeof x, C % G == 0. part: a 2 · N · chunks · C fp32
// scratch buffer and affine a 2 · N · C one; each of the `chunks` CTAs of an
// image sums `rows` rows (the last one the rest).
int fused_group_norm(const void* x, const void* gamma, const void* beta, void* y, void* part, void* affine, int N,
                     int S, int C, int G, float eps, int act_silu, int rows, int chunks, int x_bf16, int param_bf16,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* a = static_cast<float*>(affine);
  const cudaError_t err =
      x_bf16 ? launch<bf16>(x, gamma, beta, y, p, a, N, S, C, G, eps, act_silu, rows, chunks, param_bf16, st)
             : launch<float>(x, gamma, beta, y, p, a, N, S, C, G, eps, act_silu, rows, chunks, param_bf16, st);
  return static_cast<int>(err);
}

}  // extern "C"
