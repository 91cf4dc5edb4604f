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
// What the design does about it: it is the Hopper counterpart of the TPU
// kernel's VMEM slab. One launch, one thread-block cluster per image; each
// CTA takes a contiguous run of the image's rows, in chunks of ~16 KB that
// move only by 1-D bulk copies (cp.async.bulk, each on its own mbarrier),
// so a CTA keeps tens of KB in flight with one thread. The chunks go
// through a ring of `stages` slots, chunk k in slot k % stages:
//   1. the producer warp streams the CTA's chunks in, each as its slot frees
//      up; the 256 consumer threads sum per channel in fp32 (sums and sums
//      of squares) as each chunk lands;
//   2. the consumers add their sums in shared memory, and the cluster adds
//      the CTAs' (C,) partials through distributed shared memory
//      (gn_cluster_affine: every CTA reads every partial in rank order, so
//      all get the same bits; no atomics, no scratch buffer in global
//      memory) and folds the groups into each channel's scale and shift;
//   3. the consumers normalise the chunks last to first from shared memory
//      and write y with 16-byte stores: first the last `stages` chunks,
//      still in the slots where step 1 left them, then the others, which
//      the producer reads again into each slot as it frees up (the most
//      recently read first, so the second read finds as much of them in L2
//      as it can).
// A CTA whose chunks all fit its slots (stages >= its chunks) reads x from
// device memory once. The cluster's size, the rows of each CTA and the
// ring's depth come from `cluster_plan` (ops/fused_gn.py): every image's
// cluster runs in one wave (a cluster left to a second wave costs the
// launch its time again), and the ring is as deep as the CTA's share of the
// SM allows, up to all its chunks. On an H100 only a 16²·640 image fits its
// cluster; of the bigger ones, the chunks beyond the ring are read twice,
// the second time partly from L2 (perf/torch_k3_plan_sweep.py times the
// alternatives; PERF.md §6 has what they showed).
// Summation order, which the CPU test emulates (tests/test_torch_gn_cluster.py):
// thread (v, lane) of a CTA sums rows lane, lane + lanes, ... of the CTA's
// run in order (fp32 adds, squares by FMA); the CTA adds its lanes in order;
// the cluster adds its ranks in order; the group adds its channels in order.
//
// Plain C interface, loaded with ctypes: launches on the given stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_common.cuh"

namespace {

constexpr int K3_CONSUMERS = GN_THREADS;         // 8 warps: 16 bytes of a row a thread, as gn_common.cuh's stage 1
constexpr int K3_THREADS = K3_CONSUMERS + 32;    // and one producer warp
constexpr int K3_CHUNK_BYTES = 16384;            // at most, a bulk copy (whole rows)
constexpr int K3_MAX_CLUSTER = 16;               // the non-portable cluster size limit
constexpr int K3_SMEM_MAX = 232448;              // shared memory a CTA may use (227 KB)

// rows of one chunk: as many whole rows as K3_CHUNK_BYTES holds
__host__ __device__ inline int k3_chunk_rows(int C, int item) {
  const int rows = K3_CHUNK_BYTES / (C * item);
  return rows > 0 ? rows : 1;
}

// The K3 CTA's shared memory for a ring of `stages` slots: the slots
// (chunk_rows · C · item bytes each), then in fp32 its partials (2·C: read
// by the cluster), its threads' sums (2 · lanes · C), the cluster's sums and
// then the scales and shifts (2·C), the group statistics (2·C floats of
// room: G <= C), and four mbarriers a slot (full and empty in step 1, full
// and empty in step 3). `cluster_smem` (ops/fused_gn.py) computes the same.
int k3_smem(int C, int item, int stages) {
  const int lanes = K3_CONSUMERS / (C * item / 16);
  return stages * k3_chunk_rows(C, item) * C * item + 4 * (6 * C + 2 * lanes * C) + 32 * stages;
}

// SiLU on the special-function path (__expf, __fdividef): within a few fp32
// ulps of v / (1 + expf(−v)), far inside K3's gate (1e-3 relative), and
// about a third of the instructions
template <typename T>
__device__ __forceinline__ void k3_apply(float (&e)[Vec16<T>::N], const float (&sc)[Vec16<T>::N],
                                         const float (&sh)[Vec16<T>::N], int act_silu) {
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) {
    const float f = fmaf(e[i], sc[i], sh[i]);
    e[i] = act_silu ? __fdividef(f, 1.f + __expf(-f)) : f;
  }
}

template <typename T>
__device__ __forceinline__ void k3_sum(const float (&e)[Vec16<T>::N], float (&s)[Vec16<T>::N],
                                       float (&q)[Vec16<T>::N]) {
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) {
    s[i] += e[i];
    q[i] = fmaf(e[i], e[i], q[i]);
  }
}

// A thread's rows r, r + lanes, ... < end of a chunk in shared memory (src:
// the thread's 16 bytes of the chunk's row 0, rows C apart), four loads in
// flight, each through op in row order and, where dst (the same in global
// memory) is not null, out.
template <typename T, typename Op>
__device__ __forceinline__ void k3_rows(const T* src, T* dst, int C, int r, int end, int lanes, Op op) {
  constexpr int VEC = Vec16<T>::N;
  auto out = [&](int row, const float(&e)[VEC]) {
    if (dst != nullptr) store16<T>(dst + static_cast<size_t>(row) * C, e);
  };
  for (; r + 3 * lanes < end; r += 4 * lanes) {
    float e[4][VEC];
#pragma unroll
    for (int u = 0; u < 4; ++u) load16<T>(src + static_cast<size_t>(r + u * lanes) * C, e[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      op(e[u]);
      out(r + u * lanes, e[u]);
    }
  }
  for (; r < end; r += lanes) {
    float e[VEC];
    load16<T>(src + static_cast<size_t>(r) * C, e);
    op(e);
    out(r, e);
  }
}

// One CTA of image blockIdx.y's cluster (gridDim.x CTAs): rows
// [rank · rows, min(S, (rank + 1) · rows)), in chunks of `ch` rows, chunk
// k in ring slot k % stages. Consumer thread t owns the channels
// (t mod C/VEC) · VEC .. +VEC of rows lane, lane + lanes, ... (lane =
// t / (C/VEC)), as stage 1; warp 8 is the producer.
// The slots' barriers: in step 1, chunk k is slot k % stages's (k / stages)-th
// fill (full1) and the consumers free the slot for chunk k + stages (empty1);
// in step 3, the i-th chunk applied is k = nchunks − 1 − i, in the same slot,
// there since step 1 for i < stages and else its (i / stages − 1)-th refill
// (full2), and the consumers free the slot for the (i + stages)-th (empty2).
template <typename T>
__global__ void __launch_bounds__(K3_THREADS, 2)
    gn_k3_cluster(const T* __restrict__ x, const void* gamma, const void* beta, int param_bf16, T* __restrict__ y,
                  int S, int C, int G, float eps, int act_silu, int rows, int stages) {
  constexpr int VEC = Vec16<T>::N;
  extern __shared__ __align__(128) unsigned char smem_k3[];
  const int rank = static_cast<int>(cluster_rank()), n = blockIdx.y;
  const int r0 = min(S, rank * rows), nrows = min(S, r0 + rows) - r0;
  const int ch = k3_chunk_rows(C, static_cast<int>(sizeof(T)));
  const int nchunks = (nrows + ch - 1) / ch;
  const uint32_t row_bytes = static_cast<uint32_t>(C) * sizeof(T), slot_bytes = ch * row_bytes;
  const int vpr = C / VEC, lanes = K3_CONSUMERS / vpr;
  const int t = threadIdx.x, v = t % vpr, lane = t / vpr;
  float* part = reinterpret_cast<float*>(smem_k3 + static_cast<size_t>(stages) * slot_bytes);
  float* red = part + 2 * C;
  float* aff = red + 2 * lanes * C;
  float* gst = aff + 2 * C;
  const uint32_t slots = smem_u32(smem_k3), full1 = smem_u32(gst + 2 * C);
  const uint32_t empty1 = full1 + 8 * stages, full2 = empty1 + 8 * stages, empty2 = full2 + 8 * stages;
  const long long base = (static_cast<long long>(n) * S + r0) * C;
  auto load = [&](int k, uint32_t bar) {
    const uint32_t bytes = static_cast<uint32_t>(min(ch, nrows - k * ch)) * row_bytes;
    mbar_arrive_expect_tx(bar, bytes);
    bulk_load(slots + (k % stages) * slot_bytes, x + base + static_cast<long long>(k) * ch * C, bytes, bar);
  };

  if (t == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full1 + 8 * i, 1);
      mbar_init(empty1 + 8 * i, K3_CONSUMERS / 32);  // one arrival per consumer warp
      mbar_init(full2 + 8 * i, 1);
      mbar_init(empty2 + 8 * i, K3_CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (t >= K3_CONSUMERS) {  // the producer warp; lane 0 moves the chunks
    if (t == K3_CONSUMERS) {
      for (int k = 0; k < nchunks; ++k) {  // 1. every chunk in, each as its slot frees up
        const int sl = k % stages;
        if (k >= stages) mbar_wait(empty1 + 8 * sl, ((k / stages) & 1) ^ 1);
        load(k, full1 + 8 * sl);
      }
    }
    cluster_arrive();  // the consumers' partials are written past this barrier
    cluster_wait();
    cluster_arrive();  // reads no other CTA's partials
    if (t == K3_CONSUMERS) {
      // 3. the chunks the ring no longer holds in again, last to first, each
      // as the consumers free its slot
      for (int i = stages; i < nchunks; ++i) {
        const int k = nchunks - 1 - i, sl = k % stages;
        mbar_wait(empty2 + 8 * sl, ((i / stages) & 1) ^ 1);
        load(k, full2 + 8 * sl);
      }
    }
    cluster_wait();  // no CTA leaves while another may still read its partials
    return;
  }

  // consumers. 1. per-thread sums in row order, each chunk as it lands
  const bool active = lane < lanes;
  T* const mine = reinterpret_cast<T*>(smem_k3) + v * VEC;
  auto first = [&](int rb) { return rb + (lane - rb % lanes + lanes) % lanes; };  // my first row >= rb
  float s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
  auto sum = [&](float(&e)[VEC]) { k3_sum<T>(e, s, q); };
  for (int k = 0; k < nchunks; ++k) {
    const int sl = k % stages, rb = k * ch;
    mbar_wait(full1 + 8 * sl, (k / stages) & 1);
    if (active)
      k3_rows<T>(mine + static_cast<size_t>(sl) * ch * C, nullptr, C, first(rb) - rb, min(nrows - rb, ch), lanes, sum);
    if (k + stages < nchunks) {
      __syncwarp();  // the warp's reads of the slot are done
      mbar_arrive_if(empty1 + 8 * sl, (t & 31) == 0);
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      red[lane * C + v * VEC + i] = s[i];
      red[(lanes + lane) * C + v * VEC + i] = q[i];
    }
  }
  named_bar_sync(1, K3_CONSUMERS);
  // 2. the CTA's partials, then the cluster's scale and shift
  for (int c = t; c < C; c += K3_CONSUMERS) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < lanes; ++k) {
      a += red[k * C + c];
      b += red[(lanes + k) * C + c];
    }
    part[c] = a;
    part[C + c] = b;
  }
  cluster_arrive();
  cluster_wait();
  gn_cluster_affine(part, static_cast<int>(gridDim.x), gamma, beta, param_bf16, aff, gst, S, C, G, eps,
                    K3_CONSUMERS);

  // 3. y, chunk by chunk (last to first), from shared memory to global memory
  float sc[VEC], sh[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sc[i] = aff[v * VEC + i];
    sh[i] = aff[C + v * VEC + i];
  }
  auto apply = [&](float(&e)[VEC]) { k3_apply<T>(e, sc, sh, act_silu); };
  for (int i = 0; i < nchunks; ++i) {
    const int k = nchunks - 1 - i, sl = k % stages, rb = k * ch;
    if (i >= stages) mbar_wait(full2 + 8 * sl, ((i / stages) - 1) & 1);
    if (active)
      k3_rows<T>(mine + static_cast<size_t>(sl) * ch * C, y + base + static_cast<long long>(rb) * C + v * VEC, C,
                 first(rb) - rb, min(nrows - rb, ch), lanes, apply);
    if (i + stages < nchunks) {
      __syncwarp();
      mbar_arrive_if(empty2 + 8 * sl, (t & 31) == 0);
    }
  }
  cluster_wait();  // no CTA leaves while another may still read its partials
}

template <typename T>
cudaLaunchConfig_t k3_config(int N, int C, int cluster, int stages, cudaStream_t st, cudaLaunchAttribute* attr,
                             cudaError_t* err) {
  static bool set = false;
  if (!set) {
    *err = cudaFuncSetAttribute(gn_k3_cluster<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (*err == cudaSuccess)
      *err = cudaFuncSetAttribute(gn_k3_cluster<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, K3_SMEM_MAX);
    if (*err == cudaSuccess)  // all of the SM's 228 KB as shared memory, whatever one CTA asks
      *err = cudaFuncSetAttribute(gn_k3_cluster<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared);
    set = *err == cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, N);
  cfg.blockDim = dim3(K3_THREADS);
  cfg.dynamicSmemBytes = k3_smem(C, sizeof(T), stages);
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool k3_valid(int S, int C, int G, int cluster, int rows, int stages, int item) {
  const int vec = 16 / item;
  return C > 0 && C % vec == 0 && C / vec <= K3_CONSUMERS && G > 0 && C % G == 0 && cluster >= 1 &&
         cluster <= K3_MAX_CLUSTER && rows >= 1 && static_cast<long long>(cluster) * rows >= S && stages >= 1 &&
         k3_smem(C, item, stages) <= K3_SMEM_MAX;
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y, int N, int S, int C, int G, float eps,
                   int act_silu, int cluster, int rows, int stages, int param_bf16, cudaStream_t st) {
  if (!k3_valid(S, C, G, cluster, rows, stages, sizeof(T))) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaError_t err = cudaSuccess;
  const cudaLaunchConfig_t cfg = k3_config<T>(N, C, cluster, stages, st, &attr, &err);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, gn_k3_cluster<T>, static_cast<const T*>(x), gamma, beta, param_bf16,
                           static_cast<T*>(y), S, C, G, eps, act_silu, rows, stages);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (N, S, C) bf16 (x_bf16 = 1) or fp32, contiguous, 16-byte aligned;
// gamma, beta: (C,) bf16 (param_bf16 = 1) or fp32. C % (16 / sizeof x) == 0,
// C ≤ 256 · 16 / sizeof x, C % G == 0. One cluster of `cluster` CTAs per
// image (cluster · rows >= S); each CTA takes `rows` rows (the last ones the
// rest) in chunks of 16 KB of whole rows at most, through a ring of
// `stages` slots in shared memory.
int fused_group_norm(const void* x, const void* gamma, const void* beta, void* y, int N, int S, int C, int G,
                     float eps, int act_silu, int cluster, int rows, int stages, int x_bf16, int param_bf16,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_bf16 ? launch<bf16>(x, gamma, beta, y, N, S, C, G, eps, act_silu, cluster, rows, stages, param_bf16, st)
             : launch<float>(x, gamma, beta, y, N, S, C, G, eps, act_silu, cluster, rows, stages, param_bf16, st);
  return static_cast<int>(err);
}

// How many clusters of the K3 launch with these parameters the card can hold
// at once (cudaOccupancyMaxActiveClusters) into *active; returns the error.
int fused_group_norm_clusters(int N, int C, int cluster, int stages, int x_bf16, int* active) {
  cudaLaunchAttribute attr;
  cudaError_t err = cudaSuccess;
  if (x_bf16) {
    const cudaLaunchConfig_t cfg = k3_config<bf16>(N, C, cluster, stages, nullptr, &attr, &err);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(active, gn_k3_cluster<bf16>, &cfg);
  } else {
    const cudaLaunchConfig_t cfg = k3_config<float>(N, C, cluster, stages, nullptr, &attr, &err);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(active, gn_k3_cluster<float>, &cfg);
  }
  return static_cast<int>(err);
}

}  // extern "C"
