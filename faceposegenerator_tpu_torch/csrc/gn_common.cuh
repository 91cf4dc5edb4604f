// GroupNorm statistics shared by K3 (fused_gn.cu) and K4 (gn_conv.cu).
//
// For x (N, S, C) channels-last, the per-(image, channel) fp32 affine that
// normalises each group and applies gamma and beta:
//
//   scale[n, c] = gamma[c] · rsqrt(var[n, g] + eps),  shift[n, c] = beta[c] − mean[n, g] · scale[n, c]
//
// with mean and var = E[x²] − mean² over the S·C/G values of group g = c / (C/G).
// The TPU kernel holds a whole image in VMEM and reduces it in one block; a
// 64²×320 bf16 image is 2.6 MB, far more than an SM's shared memory, so here
// the reduction is split, deterministic and free of atomics:
//
//   1. partials (grid: row chunks × images): each CTA reads its rows across
//      all C with 16-byte loads, coalesced along C (a row of C channels is
//      C/VEC threads wide, so 256 threads cover `lanes` rows at once), sums
//      and sums of squares in fp32 per thread, reduces its lanes in shared
//      memory and writes one (C,) sum and one (C,) sum of squares;
//   2. fold (grid: images): one CTA adds its image's chunks per channel in
//      order, folds each group's channels, multiplies by 1/(C/G·S) and writes
//      the scale and shift.
//
// The partial buffer holds the sums (N, chunks, C) followed by the sums of
// squares (N, chunks, C); the affine buffer the scales (N, C) followed by the
// shifts (N, C). K4 runs stages 1 and 2 as launches of their own.
//
// K3 runs one thread-block cluster per image instead (fused_gn.cu): its CTAs
// make stage 1's per-CTA partials in their own shared memory, and
// `gn_cluster_affine` below is stage 2 over distributed shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int GN_THREADS = 256;
constexpr int GN_MAX_C = 2048;  // 256 threads × 8 bf16 channels

// 16 bytes of T as VEC floats
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&v)[Vec16<T>::N]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      v[2 * i] = __low2float(h);
      v[2 * i + 1] = __high2float(h);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(w[i]);
  }
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float (&v)[Vec16<T>::N]) {
  uint32_t w[4];
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(v[i]);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float load_param(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// Stage 1 over rows [chunk · rows, min(S, (chunk + 1) · rows)) of image
// blockIdx.y; blockIdx.x is the chunk. Thread t < lanes · C/VEC owns the
// channels (t mod C/VEC) · VEC .. +VEC of rows lane, lane + lanes, ...
template <typename T>
__device__ __forceinline__ void gn_partial_body(const T* __restrict__ x, float* __restrict__ part, int S, int C,
                                                int rows, int chunks) {
  constexpr int VEC = Vec16<T>::N;
  __shared__ float red[2][GN_THREADS * VEC];
  const int vpr = C / VEC, lanes = GN_THREADS / vpr;
  const int t = threadIdx.x, v = t % vpr, lane = t / vpr;
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int r0 = chunk * rows, r1 = min(S, r0 + rows);
  if (lane < lanes) {
    float s[VEC], q[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
    const T* base = x + static_cast<long long>(n) * S * C + v * VEC;
    for (int r = r0 + lane; r < r1; r += lanes) {
      float e[VEC];
      load16<T>(base + static_cast<long long>(r) * C, e);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[i] += e[i];
        q[i] = fmaf(e[i], e[i], q[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      red[0][lane * C + v * VEC + i] = s[i];
      red[1][lane * C + v * VEC + i] = q[i];
    }
  }
  __syncthreads();
  float* ps = part + (static_cast<long long>(n) * chunks + chunk) * C;
  float* pq = ps + static_cast<long long>(gridDim.y) * chunks * C;
  for (int c = t; c < C; c += GN_THREADS) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < lanes; ++k) {
      a += red[0][k * C + c];
      b += red[1][k * C + c];
    }
    ps[c] = a;
    pq[c] = b;
  }
}

// Stage 2 for image blockIdx.x of N = gridDim.x.
__device__ __forceinline__ void gn_fold_body(const float* __restrict__ part, const void* gamma, const void* beta,
                                             int param_bf16, float* __restrict__ affine, int chunks, int S, int C,
                                             int G, float eps) {
  __shared__ float cs[GN_MAX_C], cq[GN_MAX_C], gmean[GN_MAX_C], ginv[GN_MAX_C];
  const int n = blockIdx.x, N = gridDim.x;
  const float* ps = part + static_cast<long long>(n) * chunks * C;
  const float* pq = ps + static_cast<long long>(N) * chunks * C;
  for (int c = threadIdx.x; c < C; c += GN_THREADS) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < chunks; ++k) {
      a += ps[k * C + c];
      b += pq[k * C + c];
    }
    cs[c] = a;
    cq[c] = b;
  }
  __syncthreads();
  const int cg = C / G;
  const float inv_count = 1.f / static_cast<float>(cg * S);
  for (int g = threadIdx.x; g < G; g += GN_THREADS) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < cg; ++j) {
      a += cs[g * cg + j];
      b += cq[g * cg + j];
    }
    const float mean = a * inv_count;
    const float var = b * inv_count - mean * mean;
    gmean[g] = mean;
    ginv[g] = rsqrtf(var + eps);
  }
  __syncthreads();
  float* scale = affine + static_cast<long long>(n) * C;
  float* shift = affine + static_cast<long long>(N + n) * C;
  for (int c = threadIdx.x; c < C; c += GN_THREADS) {
    const int g = c / cg;
    const float sc = ginv[g] * load_param(gamma, c, param_bf16);
    scale[c] = sc;
    shift[c] = load_param(beta, c, param_bf16) - gmean[g] * sc;
  }
}

// Stage 2 on a thread-block cluster (K3), by threads 0 .. threads-1 of the
// CTA (the others may not take part: its barriers are named barrier 1 over
// `threads`). Every CTA of the cluster holds its rows' (C,) sums, then (C,)
// sums of squares, at `part` in its own shared memory, and has arrived at
// and waited on the cluster barrier since writing them. Each CTA adds the
// `ranks` partials per channel in rank order (the same order, so the same
// bits, in every CTA; no atomics), folds each group's channels in order as
// gn_fold_body does, and writes the scales (C) and then the shifts (C) to
// `aff` in its own shared memory. `gst` is room for 2·C floats. Arrives at
// the cluster barrier once it has read the other CTAs' partials: the caller
// waits on it before the CTA exits.
__device__ __forceinline__ void gn_cluster_affine(const float* part, int ranks, const void* gamma, const void* beta,
                                                  int param_bf16, float* aff, float* gst, int S, int C, int G,
                                                  float eps, int threads) {
  const uint32_t p = smem_u32(part);
  // one thread a (sums or squares, 4 channels): 8 ranks' loads in flight at once
  for (int i = threadIdx.x; i < C / 2; i += threads) {
    const uint32_t at = p + 16u * i;  // sums: i < C/4; squares: the next C/4
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < ranks; k0 += 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + u < ranks) v[u] = ld_cluster_v4(cluster_map(at, k0 + u));
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + u < ranks) a.x += v[u].x, a.y += v[u].y, a.z += v[u].z, a.w += v[u].w;
    }
    reinterpret_cast<float4*>(aff)[i] = a;
  }
  cluster_arrive();
  named_bar_sync(1, threads);
  const int cg = C / G;
  const float inv_count = 1.f / static_cast<float>(cg * S);
  for (int g = threadIdx.x; g < G; g += threads) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < cg; ++j) {
      a += aff[g * cg + j];
      b += aff[C + g * cg + j];
    }
    const float mean = a * inv_count;
    const float var = b * inv_count - mean * mean;
    gst[g] = mean;
    gst[C + g] = rsqrtf(var + eps);
  }
  named_bar_sync(1, threads);
  for (int c = threadIdx.x; c < C; c += threads) {
    const int g = c / cg;
    const float sc = gst[C + g] * load_param(gamma, c, param_bf16);
    aff[c] = sc;
    aff[C + c] = load_param(beta, c, param_bf16) - gst[g] * sc;
  }
  named_bar_sync(1, threads);
}

}  // namespace
