// What the port's Hopper kernels share: cp.async copies from global to
// shared memory, and fp32 products on the tensor cores at fp32 parity
// (3xTF32: tf32 mma.sync on hi + lo halves of each operand).
//
// Included by flash_attention.cu (B8/B9's fp32 lane), paged_attention_chunk.cu
// (B5/B6), quant_matmul.cu (B7) and fused_rnn.cu (B10-B15), each a
// translation unit of its own: the helpers sit in an anonymous namespace.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` (16, 8 or 4) global -> shared without the registers; zeros (src
// unread) when !ok
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes, bool ok) {
  const int n = ok ? bytes : 0;
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  }
}
// 16 bytes global -> shared; zeros (src unread) when !ok
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool ok) {
  cp_async(dst, src, 16, ok);
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo: hi is x rounded to its top 11 significant bits (tf32) by an
// integer add and mask (cvt.rna.tf32 runs at a quarter of their rate), lo
// = x - hi exactly, of which the tensor core reads the top 11 bits: x to
// ~2^-21. The subtraction is an explicit round-to-nearest intrinsic, so
// the compiler never contracts it with the product that made x.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a * b, m16n8k8, tf32 in, fp32 accumulate. Fragments (lane 4g + t):
// a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4];
// b0 = B[t][g], b1 = B[t + 4][g]; d0, d1 = D[g][2t, 2t + 1], d2, d3 =
// D[g + 8][2t, 2t + 1]. Not volatile: a product has no side effect, so the
// compiler may interleave independent ones.
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
