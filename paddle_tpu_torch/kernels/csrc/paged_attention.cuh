// Device pieces shared by the paged-attention kernels of the port
// (paged_attention.cu: the mixed-step B1/B2 and decode-step B3/B4 kernels;
// paged_attention_chunk.cu: the chunk/prefill B5/B6 kernel): the payload
// conversions, warp reductions, and the single-query fold.
//
// Every kernel dequantizes a key or value as payload * scale (the scale the
// block's writer stored, read through the block table) BEFORE its fp32
// online-softmax fold, as paddle_tpu/kernels/paged_attention.py:_dequant_kv
// does, and uses the finite stand-in -1e30 for -inf, so that a fully masked
// row stays NaN-free.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
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

// One query row of one head, folded over the first `ctx` keys of the block
// table `table` by the whole block (kThreads threads). Warp w takes keys
// w*kKeysPerStep .. +kKeysPerStep-1, then the same span kWarps spans on: the
// 32 lanes of the warp read each key row together (coalesced), all the
// step's table entries, K and V loads are issued before any of its math,
// and one max/rescale folds the step's keys into the warp's running max,
// normaliser and accumulator in registers. One merge through shared memory
// combines the warps. Reads no K/V, scale or table entry past ctx. ctx <= 0
// writes an exact zero row. The reduction order depends only on ctx, so a
// row's output does not depend on what other rows hold.
// T: the payload type; kScaled: a quantized lane with per-block scales;
// kKeysPerStep: keys per warp step. A launch with few blocks (the decode
// step: slots x heads) lasts as long as its longest context's chain of
// dependent steps, so it takes 4 (a 512-key context is 16 steps per warp,
// not 64); a launch whose blocks fill the card (the mixed step: rows x
// heads) is throughput-bound and keeps 1, whose smaller register footprint
// (40 registers, not 64-69) measured faster.
template <typename T, bool kScaled, int kKeysPerStep>
__device__ __forceinline__ void fold_query(
    const float* __restrict__ q_row, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    int ctx, float* __restrict__ o, int H, int h, int d, int B,
    float sm_scale) {
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][kMaxHeadDim];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (ctx <= 0) {
    for (int i = threadIdx.x; i < d; i += kThreads) o[i] = 0.f;
    return;
  }

  float qr[kPerLane];
  float acc[kPerLane];
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int i = lane + 32 * r;
    qr[r] = i < d ? q_row[i] : 0.f;
    acc[r] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const size_t head_stride = static_cast<size_t>(B) * d;
  const size_t block_stride = static_cast<size_t>(H) * head_stride;
  for (int j0 = warp * kKeysPerStep; j0 < ctx;
       j0 += kWarps * kKeysPerStep) {
    float sc[kKeysPerStep];
    float vv[kKeysPerStep][kPerLane];
#pragma unroll
    for (int u = 0; u < kKeysPerStep; ++u) {
      const int j = j0 + u;  // warp-uniform
      float partial = 0.f;
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) vv[u][r] = 0.f;
      if (j < ctx) {
        const int blk = table[j / B];
        const size_t base = static_cast<size_t>(blk) * block_stride +
                            h * head_stride +
                            static_cast<size_t>(j % B) * d;
        float ks = 1.f;
        float vs = 1.f;
        if (kScaled) {
          ks = k_scale[static_cast<size_t>(blk) * H + h];
          vs = v_scale[static_cast<size_t>(blk) * H + h];
        }
#pragma unroll
        for (int r = 0; r < kPerLane; ++r) {
          const int i = lane + 32 * r;
          if (i < d) {
            // dequantize first, then the fp32 fold (_dequant_kv)
            const float kf = kScaled ? to_float(k_pool[base + i]) * ks
                                     : to_float(k_pool[base + i]);
            partial += qr[r] * kf;
            vv[u][r] = kScaled ? to_float(v_pool[base + i]) * vs
                               : to_float(v_pool[base + i]);
          }
        }
      }
      sc[u] = partial;
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kKeysPerStep; ++u) {
      sc[u] = j0 + u < ctx ? warp_sum(sc[u]) * sm_scale : kNegInf;
      m_new = fmaxf(m_new, sc[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) acc[r] *= alpha;
#pragma unroll
    for (int u = 0; u < kKeysPerStep; ++u) {
      const float p = j0 + u < ctx ? expf(sc[u] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) acc[r] += p * vv[u][r];
    }
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

}  // namespace paged
