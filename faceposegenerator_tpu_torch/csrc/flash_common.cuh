// Device helpers shared by the flash-attention kernels of flash_fwd.cu and
// flash_bwd.cu: the wide backward kernel K6, built on mma.sync, and the
// wgmma kernels K1, K2 and K5 (with sm90_common.cuh): bf16 tensor-core
// MMA (mma.sync m16n8k16, fp32 accumulate), ldmatrix operand loads from
// shared memory, bf16 packing and the special-function exp2.
//
// Fragment layout of mma m16n8k16 (g = lane / 4, t4 = lane % 4):
//   A (16×16, row-major): a0 (g, 2t4..), a1 (g+8, 2t4..), a2 (g, 8+2t4..), a3 (g+8, 8+2t4..)
//   B (16×8,  k × n):     b0 (k 2t4.., n g), b1 (k 8+2t4.., n g)
//   C (16×8):             c0,c1 (g, 2t4..), c2,c3 (g+8, 2t4..)
// so the C fragments of two adjacent n-tiles, packed to bf16, are the A
// fragment of a product over those 16 columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// 2^x on the special-function unit (ex2(-inf) = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An fp32 accumulator tile (mma.sync C fragments, or a wgmma accumulator:
// 4 values per 8-column chunk) packed to bf16 as the A fragments of the KS
// k16 slices of the next product (see the layout note above).
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4 * KS], const float (&c)[8 * KS]) {
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) {
    a[4 * kc + 0] = pack_bf16(c[8 * kc + 0], c[8 * kc + 1]);
    a[4 * kc + 1] = pack_bf16(c[8 * kc + 2], c[8 * kc + 3]);
    a[4 * kc + 2] = pack_bf16(c[8 * kc + 4], c[8 * kc + 5]);
    a[4 * kc + 3] = pack_bf16(c[8 * kc + 6], c[8 * kc + 7]);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8×8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and every lane gets (row lane/4, columns 2(lane%4), +1) of each matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, transposed: every lane gets (rows 2(lane%4), +1, column lane/4).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Copy rows [row0, row0 + ROWS) of a (rows, D) slice with row stride
// `row_stride` (elements, D contiguous) into shared memory with row stride
// SST; rows >= nrows are zero-filled. 16-byte vector accesses.
template <int ROWS, int D, int SST, int NTHREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int row0, int nrows) {
  constexpr int CHUNKS = D / 8;
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += NTHREADS) {
    const int r = c / CHUNKS;
    const int cc = c % CHUNKS;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < nrows) {
      val = *reinterpret_cast<const uint4*>(src + row * row_stride + cc * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * SST + cc * 8) = val;
  }
}

}  // namespace
