// Device helpers shared by the flash-attention kernels of flash_fwd.cu and
// flash_bwd.cu (K1, K2, K5, K6, all on wgmma with sm90_common.cuh): bf16
// packing of an fp32 accumulator into the A operand of the next product,
// and the special-function exp2.
//
// Accumulator layout (g = lane / 4, t4 = lane % 4; the mma.sync m16n8 C
// fragment, which a wgmma accumulator repeats per 8-column chunk):
//   C (16×8):  c0,c1 (g, 2t4..), c2,c3 (g+8, 2t4..)
// and the bf16 A fragment of a k16 slice:
//   A (16×16): a0 (g, 2t4..), a1 (g+8, 2t4..), a2 (g, 8+2t4..), a3 (g+8, 8+2t4..)
// so two adjacent 8-column chunks, packed to bf16, are the A fragment of a
// product over those 16 columns.

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An fp32 accumulator tile (a wgmma accumulator: 4 values per 8-column
// chunk) packed to bf16 as the A fragments of the KS k16 slices of the next
// product (see the layout note above).
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

}  // namespace
