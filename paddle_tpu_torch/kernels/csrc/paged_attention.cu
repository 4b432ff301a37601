// Paged attention for the mixed chunked-prefill + decode step, for Hopper
// (sm_90a), over float32, bfloat16, int8 and fp8-e4m3 K/V pools.
//
// Replaces paddle_tpu/kernels/paged_attention.py:_mixed_kernel and its
// launcher _paged_mixed_call (float lanes: float32, and bfloat16 payloads,
// which the TPU kernel loads as k_ref[0].astype(f32)), and
// _mixed_kernel_quant with _dequant_kv, launched by _paged_mixed_call_quant
// (int8 and e4m3 payloads with per-block fp32 scales [N, H]). Each of the
// T rows of the mixed step is one query token with its own slot and its own
// context length; the row reads its slot's block table (two-level indirection:
// row -> slot -> physical block), folds every key at a position below its
// context length into an fp32 online softmax, and writes its [H, d] output.
// A row with ctx_len == 0 (an unused or masked row) writes an exact zero.
// A quantized lane dequantizes each key and value as payload * scale, with
// the scale the block's writer stored (scales[table[j / B], h], read
// through the same row -> slot -> block indirection), before the unchanged
// fp32 fold, as _dequant_kv does.
//
// What bounds it: memory bandwidth. A valid row of context ctx reads
// ctx*H*d*e*2 bytes of K and V (e = 4, 2 or 1 bytes per element) and does
// about 4*ctx*H*d FLOPs: 0.5 to 2 FLOP per byte, far under the roughly 295
// FLOP per byte where an H100 stops being memory bound. So the design is
// about bytes, not arithmetic:
//   - It reads only the pages a row needs. The TPU kernel grids over all P
//     pages and skips the tail with pl.when; here the key loop stops at the
//     row's own ctx, so no K/V or scale past it and no table entry past its
//     last page is ever read (those entries often name stale blocks).
//   - One CUDA block per (row, head). The keys of one head of one block are
//     contiguous ([B, d] inside the [N, H, B, d] pool), and the 32 lanes of a
//     warp read one key row together, neighbouring lanes on neighbouring
//     elements, so every load is coalesced.
//   - The warps split the row's keys (key j goes to warp j % kWarps), each
//     keeping its own running max, normaliser and accumulator in registers;
//     one merge through shared memory at the end combines them. No scratch
//     in device memory, no atomics, and the reduction order depends only on
//     ctx, so a row's output is the same whatever the other rows hold.
// Left for later work: rows of one prefill chunk share a slot and re-read the
// same K/V (a chunk-aware tiling would read each block once), wider loads
// (a lane reads one 1- or 2-byte element at a time on the narrow lanes),
// split-K over long contexts, and cp.async/TMA prefetch of the next page.
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the C entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 128;
constexpr int kPerLane = kMaxHeadDim / 32;
constexpr float kNegInf = -1e30f;  // finite stand-in for -inf, as on the TPU

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// one payload element as float (exact for every lane)
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// T: the payload type; kScaled: a quantized lane with per-block scales
template <typename T, bool kScaled>
__global__ void __launch_bounds__(kThreads)
paged_attention_mixed_kernel(const float* __restrict__ q,
                             const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ tables,
                             const int* __restrict__ row_slots,
                             const int* __restrict__ ctx_lens,
                             float* __restrict__ out,
                             int H, int d, int B, int P, float sm_scale) {
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][kMaxHeadDim];

  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row_off = (static_cast<size_t>(t) * H + h) * d;
  float* o = out + row_off;

  // keys past the table's P pages are never seen, as in the TPU grid
  const int ctx = min(ctx_lens[t], P * B);
  if (ctx <= 0) {
    for (int i = threadIdx.x; i < d; i += kThreads) o[i] = 0.f;
    return;
  }

  float qr[kPerLane];
  float acc[kPerLane];
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int i = lane + 32 * r;
    qr[r] = i < d ? q[row_off + i] : 0.f;
    acc[r] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const int* table = tables + static_cast<size_t>(row_slots[t]) * P;
  const size_t head_stride = static_cast<size_t>(B) * d;
  const size_t block_stride = static_cast<size_t>(H) * head_stride;
  for (int j = warp; j < ctx; j += kWarps) {
    const int blk = table[j / B];
    const size_t base = static_cast<size_t>(blk) * block_stride +
                        h * head_stride + static_cast<size_t>(j % B) * d;
    const T* kr = k_pool + base;
    const T* vr = v_pool + base;
    float ks = 1.f;
    float vs = 1.f;
    if (kScaled) {
      ks = k_scale[static_cast<size_t>(blk) * H + h];
      vs = v_scale[static_cast<size_t>(blk) * H + h];
    }
    float partial = 0.f;
    float vv[kPerLane];
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      const int i = lane + 32 * r;
      if (i < d) {
        // dequantize first, then the fp32 fold (_dequant_kv)
        const float kf = kScaled ? to_float(kr[i]) * ks : to_float(kr[i]);
        partial += qr[r] * kf;
        vv[r] = kScaled ? to_float(vr[i]) * vs : to_float(vr[i]);
      } else {
        vv[r] = 0.f;
      }
    }
    const float s = warp_sum(partial) * sm_scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) acc[r] = acc[r] * alpha + p * vv[r];
    m = m_new;
  }

  // merge the warps' partial softmax states
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int i = lane + 32 * r;
    if (i < d) s_acc[warp][i] = acc[r];
  }
  __syncthreads();
  float m_all = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, s_m[w]);
  float scale[kWarps];
  float l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    scale[w] = expf(s_m[w] - m_all);  // 0 for a warp that saw no key
    l_all += s_l[w] * scale[w];
  }
  const float safe_l = l_all == 0.f ? 1.f : l_all;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += s_acc[w][i] * scale[w];
    o[i] = a / safe_l;
  }
}

template <typename T, bool kScaled>
cudaError_t launch(const dim3& grid, cudaStream_t stream, const float* q,
                   const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* row_slots,
                   const int* ctx_lens, float* out, int H, int d, int B,
                   int P, float sm_scale) {
  paged_attention_mixed_kernel<T, kScaled><<<grid, kThreads, 0, stream>>>(
      q, static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      k_scale, v_scale, tables, row_slots, ctx_lens, out, H, d, B, P,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace

// lane 0: float32 pools; 1: bfloat16; 2: int8 with scales; 3: fp8-e4m3
// with scales. k_scale/v_scale are [N, H] fp32 for lanes 2 and 3 and
// ignored otherwise.
extern "C" int paged_attention_mixed(
    int lane, const float* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* row_slots, const int* ctx_lens, float* out, int T, int H,
    int d, int B, int P, float sm_scale, void* stream) {
  if (T <= 0 || H <= 0) return 0;  // nothing to do
  if (d < 1 || d > kMaxHeadDim || B < 1 || P < 1 || H > 65535 ||
      lane < 0 || lane > 3 ||
      (lane >= 2 && (k_scale == nullptr || v_scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(T), static_cast<unsigned>(H));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lane) {
    case 0:
      return static_cast<int>(launch<float, false>(
          grid, s, q, k_pool, v_pool, nullptr, nullptr, tables, row_slots,
          ctx_lens, out, H, d, B, P, sm_scale));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16, false>(
          grid, s, q, k_pool, v_pool, nullptr, nullptr, tables, row_slots,
          ctx_lens, out, H, d, B, P, sm_scale));
    case 2:
      return static_cast<int>(launch<int8_t, true>(
          grid, s, q, k_pool, v_pool, k_scale, v_scale, tables, row_slots,
          ctx_lens, out, H, d, B, P, sm_scale));
    default:
      return static_cast<int>(launch<__nv_fp8_e4m3, true>(
          grid, s, q, k_pool, v_pool, k_scale, v_scale, tables, row_slots,
          ctx_lens, out, H, d, B, P, sm_scale));
  }
}
