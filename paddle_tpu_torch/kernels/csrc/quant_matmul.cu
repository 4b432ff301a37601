// Quantized matmul for Hopper (sm_90a): int8 and fp8-e4m3 weights with
// per-output-channel scales, dynamic per-row activation quantization, and
// the dequantization fused into the epilogue.
//
// Replaces paddle_tpu/kernels/quant_matmul.py:_qmm_kernel_int8 and
// _qmm_kernel_fp8 (launched by _qmm_call, the Pallas TPU kernel). For x
// [M, K] fp32, wq [K, N] (int8 or e4m3) and w_scale [N] fp32 it computes
//   sx[m]  = max(absmax(x[m, :]), 1e-8) / qmax          (qmax 127 or 448)
//   xq     = clip(rint(x / sx), +-127) as int8, or e4m3(x / sx) (RNE)
//   acc    = xq . wq  (exact int32 for int8; fp32 for e4m3)
//   out    = (float)acc * sx[m] * w_scale[n]             (in that order)
// Build without --use_fast_math so x / sx is the IEEE quotient the TPU
// kernel and the plain version compute; rintf rounds half to even, as
// jnp.round and torch.round do.
//
// What bounds it: weight bytes. The serving decoder calls it with M = 80
// rows (16 decode rows + a 64-token prefill budget), so the work is
// 2*M*K*N operations on K*N weight bytes: for w1 (K 768, N 3072) that is
// 2.36 MB, 0.70 us at 3.35 TB/s, against 0.19 us of int8 tensor-core work.
// The design reads every weight byte from device memory once:
//   - One block per tile of kRows rows x kCols output channels. Its
//     threads first reduce their rows' absmax over all of K (x is small
//     and stays in L2, so the re-read by each column tile is cheap), then
//     walk K in chunks of kChunk: each chunk of x is quantized into shared
//     memory, and the chunk of wq is read from device memory once with
//     coalesced 32-bit loads.
//   - Each thread loads a 4 (k) x 4 (n) byte square of wq and transposes
//     it in registers (__byte_perm), so that every 32-bit word in shared
//     memory holds four consecutive k of one column: the operand layout of
//     __dp4a. A thread then owns one row and four columns, and does four
//     __dp4a per 32-bit word of x (int8), or sixteen fp32 FMAs on
//     converted e4m3 values (fp8; a product of two e4m3 values is exact in
//     fp32, so only the order of the sum differs from the plain version).
//   - The int8 sum is exact and order-free; nothing is reduced across
//     threads, so there are no atomics and the result does not depend on
//     the launch.
// Left for later work: the tensor cores (mma.sync / wgmma on int8 and
// e4m3), TMA or cp.async double buffering of the weight chunks, and a
// split over K for the narrow-N projections (wo, w2 give only 60 blocks).
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the C entry returns cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;                   // rows of x per block
constexpr int kColGroups = 16;              // groups of 4 output channels
constexpr int kCols = 4 * kColGroups;       // 64 output channels per block
constexpr int kThreads = kRows * kColGroups;  // 256: one row x 4 columns
constexpr int kChunk = 256;                 // k per shared-memory chunk
constexpr int kWords = kChunk / 4;          // 32-bit words of k per chunk
constexpr float kTiny = 1e-8f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

// one quantized byte of x / sx
template <bool kInt8>
__device__ __forceinline__ uint32_t quantize(float x, float sx) {
  const float v = x / sx;
  if (kInt8) {
    const float r = fminf(fmaxf(rintf(v), -127.f), 127.f);
    return static_cast<uint32_t>(static_cast<uint8_t>(
        static_cast<int8_t>(__float2int_rn(r))));
  }
  return static_cast<uint32_t>(
      __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3));
}

// four e4m3 bytes of a word -> four floats (exact)
__device__ __forceinline__ void e4m3x4_to_float(uint32_t w, float f[4]) {
  const __half2_raw lo = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3);
  const __half2_raw hi = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3);
  const float2 a = __half22float2(__half2(lo));
  const float2 b = __half22float2(__half2(hi));
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const float* __restrict__ x,
                    const uint32_t* __restrict__ wq,   // [K, N/4] words
                    const float* __restrict__ w_scale,
                    float* __restrict__ out, int M, int K, int N) {
  // x chunk: kRows rows of kWords words (+1 to spread the rows' banks)
  __shared__ uint32_t s_x[kRows][kWords + 1];
  // wq chunk: word [kw][g][c] = k 4kw..4kw+3 of column 4g+c
  __shared__ uint4 s_w[kWords][kColGroups];
  __shared__ float s_sx[kRows];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols;
  const int N4 = N >> 2;
  const float qmax = kInt8 ? 127.f : 448.f;

  // 1. each row's dynamic scale, from its absmax over all of K
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int m = row0 + r;
    float amax = 0.f;
    if (m < M) {
      const float4* xr = reinterpret_cast<const float4*>(
          x + static_cast<size_t>(m) * K);
      for (int i = lane; i < (K >> 2); i += 32) {
        const float4 v = xr[i];
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                                 fmaxf(fabsf(v.z), fabsf(v.w))));
      }
    }
    amax = warp_max(amax);
    if (lane == 0) s_sx[r] = fmaxf(amax, kTiny) / qmax;
  }
  __syncthreads();

  const int my_row = tid / kColGroups;
  const int my_group = tid % kColGroups;
  int32_t iacc[4] = {0, 0, 0, 0};
  float facc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    // 2a. quantize the x chunk into shared memory, four k per word
    for (int i = tid; i < kRows * kWords; i += kThreads) {
      const int r = i / kWords;
      const int kw = i % kWords;
      const int m = row0 + r;
      const int k = k0 + 4 * kw;
      uint32_t word = 0;
      if (m < M && k < K) {
        const float4 v = *reinterpret_cast<const float4*>(
            x + static_cast<size_t>(m) * K + k);
        const float sx = s_sx[r];
        word = quantize<kInt8>(v.x, sx) | (quantize<kInt8>(v.y, sx) << 8) |
               (quantize<kInt8>(v.z, sx) << 16) |
               (quantize<kInt8>(v.w, sx) << 24);
      }
      s_x[r][kw] = word;
    }
    // 2b. the wq chunk: a 4 x 4 byte square per thread, transposed
    for (int i = tid; i < kWords * kColGroups; i += kThreads) {
      const int kw = i / kColGroups;
      const int g = i % kColGroups;
      const int k = k0 + 4 * kw;
      const int n4 = (col0 >> 2) + g;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (n4 < N4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (k + j < K) w[j] = wq[static_cast<size_t>(k + j) * N4 + n4];
        }
      }
      // w[j] holds columns 4g..4g+3 at k+j; c[c] holds k..k+3 of column c
      const uint32_t t01_lo = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t t01_hi = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t t23_lo = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t t23_hi = __byte_perm(w[2], w[3], 0x7362);
      s_w[kw][g] = make_uint4(__byte_perm(t01_lo, t23_lo, 0x5410),
                              __byte_perm(t01_lo, t23_lo, 0x7632),
                              __byte_perm(t01_hi, t23_hi, 0x5410),
                              __byte_perm(t01_hi, t23_hi, 0x7632));
    }
    __syncthreads();

    // 3. accumulate: one row x four columns per thread
    const int n_words = min(kWords, (K - k0 + 3) >> 2);
    for (int kw = 0; kw < n_words; ++kw) {
      const uint32_t xw = s_x[my_row][kw];
      const uint4 w4 = s_w[kw][my_group];
      if (kInt8) {
        iacc[0] = __dp4a(static_cast<int>(xw), static_cast<int>(w4.x),
                         iacc[0]);
        iacc[1] = __dp4a(static_cast<int>(xw), static_cast<int>(w4.y),
                         iacc[1]);
        iacc[2] = __dp4a(static_cast<int>(xw), static_cast<int>(w4.z),
                         iacc[2]);
        iacc[3] = __dp4a(static_cast<int>(xw), static_cast<int>(w4.w),
                         iacc[3]);
      } else {
        float xf[4];
        e4m3x4_to_float(xw, xf);
        const uint32_t ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float wf[4];
          e4m3x4_to_float(ws[c], wf);
#pragma unroll
          for (int j = 0; j < 4; ++j) facc[c] = fmaf(xf[j], wf[j], facc[c]);
        }
      }
    }
    __syncthreads();
  }

  // 4. epilogue: (float)acc * sx * w_scale, in that order
  const int m = row0 + my_row;
  if (m < M) {
    const float sx = s_sx[my_row];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = col0 + 4 * my_group + c;
      if (n < N) {
        const float acc = kInt8 ? __int2float_rn(iacc[c]) : facc[c];
        out[static_cast<size_t>(m) * N + n] = acc * sx * w_scale[n];
      }
    }
  }
}

}  // namespace

// lane 0: int8 weights; lane 1: fp8-e4m3 weights. K and N must be
// multiples of 4, x and wq 16-byte aligned (the wrapper checks).
extern "C" int quant_matmul(int lane, const float* x, const void* wq,
                            const float* w_scale, float* out, int M, int K,
                            int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;  // nothing to do
  if (K < 4 || (K & 3) || (N & 3) || (lane != 0 && lane != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((N + kCols - 1) / kCols),
                  static_cast<unsigned>((M + kRows - 1) / kRows));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto* w = static_cast<const uint32_t*>(wq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lane == 0) {
    quant_matmul_kernel<true><<<grid, kThreads, 0, s>>>(x, w, w_scale, out,
                                                        M, K, N);
  } else {
    quant_matmul_kernel<false><<<grid, kThreads, 0, s>>>(x, w, w_scale,
                                                         out, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}
