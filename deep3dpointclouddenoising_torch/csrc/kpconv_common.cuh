// Device helpers shared by the KPConv kernels (kpconv_fwd.cu, kpconv_bwd.cu):
// asynchronous copies, the 3xTF32 operand split, the TF32 mma and the
// kernel-point influence.  Everything here is inlined into each kernel.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace kpconv {

constexpr int kChunk = 8;   // neighbours (edges) per stage: the mma's k
constexpr int kPPad = 16;   // kernel points, padded to the mma's m

enum Influence { kConstant = 0, kLinear = 1, kGaussian = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (4 or 16) from global to shared memory, asynchronously; with
// src_bytes == 0 it reads nothing and fills zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(BYTES), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// x = hi + lo + e with hi, lo TF32 values: hi is x with the 13 low
// mantissa bits cleared, lo the same of x - hi (exact in float32), so
// |e| < 2^-20 |x|.  Two bit masks and a subtraction (cvt.rna.tf32 twice
// cost more on this card, for 2^-22 instead of 2^-20).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += A (16 x 8, row) * B (8 x 8, col), TF32 in, float32 accumulators.
// Lane (g, t) = (lane / 4, lane % 4) holds a = A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4]; b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B in 3xTF32: lo_a hi_b + hi_a lo_b + hi_a hi_b, each rounded into
// float32 accumulators (what is lost is < 2^-19 of a product).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0,
                                           float b1) {
  uint32_t b0h, b0l, b1h, b1l;
  split_tf32(b0, b0h, b0l);
  split_tf32(b1, b1h, b1l);
  mma_tf32(d, alo, b0h, b1h);
  mma_tf32(d, ahi, b0l, b1l);
  mma_tf32(d, ahi, b0h, b1h);
}

// inv_extent = 1 / extent and inv_denom = 1 / gauss_denom, rounded once on
// the host: a multiply where the plain version divides (<= 1 ulp apart)
template <int INFL>
__device__ __forceinline__ float influence(const float3& r, const float3& q,
                                           float inv_extent,
                                           float inv_denom) {
  if (INFL == kConstant) return 1.f;
  const float dx = r.x - q.x;
  const float dy = r.y - q.y;
  const float dz = r.z - q.z;
  const float sq = dx * dx + dy * dy + dz * dz;
  if (INFL == kLinear) {
    const float d = sq > 0.f ? sqrtf(sq) : 0.f;
    return fmaxf(1.f - d * inv_extent, 0.f);
  }
  return expf(-sq * inv_denom);
}

}  // namespace kpconv
