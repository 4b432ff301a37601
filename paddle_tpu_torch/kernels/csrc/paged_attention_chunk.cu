// Paged attention for a chunk of G query rows per slot (B5/B6), for Hopper
// (sm_90a), over float32, bfloat16, int8 and fp8-e4m3 K/V pools: the
// whole-prompt prefill (S = 1, G = the prompt rung) and, later, the
// speculative verify lane (G = gamma + 1).
//
// Replaces paddle_tpu/kernels/paged_attention.py:_chunk_kernel, launched by
// _paged_chunk_call (B5), and _chunk_kernel_quant with _dequant_kv, launched
// by _paged_chunk_call_quant (B6). q is [S, G, H, d]; row g of slot s sees
// the first ctx_lens[s, g] keys of tables[s] (a chunk written at positions
// start..start+G-1 has ctx = start+g+1, so the causal intra-chunk mask is
// carried by the lengths); ctx 0 (a rung padding row, a row past the write
// limit, an inactive slot) writes an exact zero row and reads nothing. A
// quantized lane dequantizes each key and value as payload * scale, with the
// scale the block's writer stored, before the unchanged fp32 fold.
//
// What bounds it. The TPU kernel walks a (slot, page) grid in order and
// keeps G*H*d fp32 accumulators in VMEM (1.2 MB at G=384, H=12, d=64), far
// past the 227 KB of shared memory a Hopper block may use; and one block per
// (slot, head) would fill 12 of 132 SMs. One block per row, as the mixed
// kernel has, would re-read the slot's K/V once per row: sum(ctx)*H*d*8
// bytes, about 454 MB of L2 traffic for one rung-384 fp32 prefill layer.
// The least time for that layer is set by arithmetic, not bytes: 4*sum(ctx)
// *H*d = 227 MFLOP on the fp32 CUDA cores (3.4 us at 67 TFLOP/s) against
// about 1.4 us for the bytes that must move. So the design stages each key
// once per tile of rows and spends its instructions on the dot products:
//   - One CUDA block per (slot, tile of kTileRows rows, head): 24 x 12 = 288
//     blocks at G = 384. Each of the kWarps warps owns kRowsPerWarp rows of
//     the tile, with each row's running max, normaliser and accumulator in
//     registers (lanes over head_dim).
//   - The tile walks its keys in chunks of 32 positions, up to the largest
//     context among its rows (never past it: no table entry, K/V or scale
//     beyond is read). The block stages a chunk's K and V in shared memory
//     once, dequantized to fp32 (coalesced loads along head_dim, the block
//     id read through the table once per key), and every row of the tile
//     folds it from there: the tile reads its slot's K/V once, not once per
//     row, so L2 traffic falls by the tile height.
//   - A row scores a chunk with lanes over keys (lane j does the whole
//     q . k_j dot product from shared memory, float4 loads, K rows padded so
//     the eight lanes of a quarter-warp hit distinct banks), takes one warp
//     max and one warp sum for the chunk's online-softmax update, then
//     accumulates P.V with lanes over head_dim. No shuffle per key, no
//     scratch in device memory, no atomics; a row's result depends only on
//     its own context and the pool, never on the other rows of the chunk.
// Left for later work: double-buffered cp.async/TMA staging of the next
// chunk, mma.sync/wgmma for the scores and P.V, and a split over keys for
// tiles whose rows see long contexts.
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the C entry returns cudaGetLastError().

#include "paged_attention.cuh"

namespace {

using paged::kMaxHeadDim;
using paged::kNegInf;
using paged::kPerLane;
using paged::kThreads;
using paged::kWarps;
using paged::to_float;
using paged::warp_max;
using paged::warp_sum;

constexpr int kChunkKeys = 32;                    // one key per lane
constexpr int kTileRows = 16;                     // rows per block
constexpr int kRowsPerWarp = kTileRows / kWarps;  // 2
constexpr int kKStride = kMaxHeadDim + 4;         // padded K rows (floats)

template <typename T, bool kScaled>
__global__ void __launch_bounds__(kThreads)
paged_attention_chunk_kernel(const float* __restrict__ q,
                             const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ tables,
                             const int* __restrict__ ctx_lens,
                             float* __restrict__ out, int G, int H, int d,
                             int B, int P, int n_tiles, float sm_scale) {
  __shared__ __align__(16) float s_k[kChunkKeys][kKStride];
  __shared__ __align__(16) float s_v[kChunkKeys][kMaxHeadDim];
  __shared__ __align__(16) float s_q[kTileRows][kMaxHeadDim];
  __shared__ float s_p[kWarps][kChunkKeys];
  __shared__ int s_ctx[kTileRows];

  const int s = blockIdx.x / n_tiles;
  const int g0 = (blockIdx.x % n_tiles) * kTileRows;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x < kTileRows) {
    const int g = g0 + threadIdx.x;
    const int c = g < G ? ctx_lens[static_cast<size_t>(s) * G + g] : 0;
    s_ctx[threadIdx.x] = max(0, min(c, P * B));  // never past P pages
  }
  for (int i = threadIdx.x; i < kTileRows * d; i += kThreads) {
    const int r = i / d;
    const int e = i - r * d;
    const int g = g0 + r;
    s_q[r][e] = g < G
        ? q[((static_cast<size_t>(s) * G + g) * H + h) * d + e] : 0.f;
  }
  __syncthreads();
  int n_keys = 0;  // the tile's largest context
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) n_keys = max(n_keys, s_ctx[r]);

  // this warp's rows: r = warp * kRowsPerWarp + rr
  int ctx[kRowsPerWarp];
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  float acc[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    ctx[rr] = s_ctx[warp * kRowsPerWarp + rr];
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int x = 0; x < kPerLane; ++x) acc[rr][x] = 0.f;
  }

  const int* table = tables + static_cast<size_t>(s) * P;
  const size_t head_stride = static_cast<size_t>(B) * d;
  const size_t block_stride = static_cast<size_t>(H) * head_stride;
  for (int c0 = 0; c0 < n_keys; c0 += kChunkKeys) {
    // stage keys c0 .. c0+31, dequantized; zeros past the tile's context
    for (int i = threadIdx.x; i < kChunkKeys * d; i += kThreads) {
      const int j = i / d;
      const int e = i - j * d;
      const int pos = c0 + j;
      float kf = 0.f;
      float vf = 0.f;
      if (pos < n_keys) {
        const int blk = table[pos / B];
        const size_t off = static_cast<size_t>(blk) * block_stride +
                           h * head_stride +
                           static_cast<size_t>(pos % B) * d + e;
        kf = to_float(k_pool[off]);
        vf = to_float(v_pool[off]);
        if (kScaled) {
          kf *= k_scale[static_cast<size_t>(blk) * H + h];
          vf *= v_scale[static_cast<size_t>(blk) * H + h];
        }
      }
      s_k[j][e] = kf;
      s_v[j][e] = vf;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int nj = min(kChunkKeys, ctx[rr] - c0);  // warp-uniform
      if (nj <= 0) continue;
      float sc = kNegInf;
      if (lane < nj) {
        const float* kr = s_k[lane];
        const float* qr = s_q[r];
        float dot = 0.f;
        for (int e = 0; e < d; e += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + e);
          const float4 qq = *reinterpret_cast<const float4*>(qr + e);
          dot += qq.x * kk.x;
          dot += qq.y * kk.y;
          dot += qq.z * kk.z;
          dot += qq.w * kk.w;
        }
        sc = dot * sm_scale;
      }
      const float m_new = fmaxf(m[rr], warp_max(sc));
      const float p = lane < nj ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = m_new;
      s_p[warp][lane] = p;
      __syncwarp();
#pragma unroll
      for (int x = 0; x < kPerLane; ++x) acc[rr][x] *= alpha;
      for (int j = 0; j < nj; ++j) {
        const float pj = s_p[warp][j];
#pragma unroll
        for (int x = 0; x < kPerLane; ++x) {
          const int e = lane + 32 * x;
          if (e < d) acc[rr][x] += pj * s_v[j][e];
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int g = g0 + warp * kRowsPerWarp + rr;
    if (g >= G) continue;
    float* o = out + ((static_cast<size_t>(s) * G + g) * H + h) * d;
    const float safe_l = l[rr] == 0.f ? 1.f : l[rr];  // ctx-0 row -> zeros
#pragma unroll
    for (int x = 0; x < kPerLane; ++x) {
      const int e = lane + 32 * x;
      if (e < d) o[e] = ctx[rr] > 0 ? acc[rr][x] / safe_l : 0.f;
    }
  }
}

}  // namespace

// q [S, G, H, d] fp32, tables [S, P] int32, ctx_lens [S, G] int32, out
// [S, G, H, d] fp32. lane 0: float32 pools; 1: bfloat16; 2: int8 with
// scales; 3: fp8-e4m3 with scales (k_scale/v_scale [N, H] fp32, ignored on
// lanes 0 and 1). head_dim must be a multiple of 4 (float4 staging reads).
extern "C" int paged_attention_chunk(
    int lane, const float* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* ctx_lens, float* out, int S, int G, int H, int d, int B,
    int P, float sm_scale, void* stream) {
  if (S <= 0 || G <= 0 || H <= 0) return 0;  // nothing to do
  const int n_tiles = (G + kTileRows - 1) / kTileRows;
  if (d < 4 || d > kMaxHeadDim || d % 4 != 0 || B < 1 || P < 1 ||
      H > 65535 || lane < 0 || lane > 3 ||
      static_cast<long long>(S) * n_tiles > 2147483647LL ||
      (lane >= 2 && (k_scale == nullptr || v_scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(S * n_tiles),
                  static_cast<unsigned>(H));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_CHUNK(TYPE, SCALED)                                             \
  paged_attention_chunk_kernel<TYPE, SCALED><<<grid, kThreads, 0, st>>>(   \
      q, static_cast<const TYPE*>(k_pool), static_cast<const TYPE*>(v_pool), \
      k_scale, v_scale, tables, ctx_lens, out, G, H, d, B, P, n_tiles,     \
      sm_scale)
  switch (lane) {
    case 0: PA_CHUNK(float, false); break;
    case 1: PA_CHUNK(__nv_bfloat16, false); break;
    case 2: PA_CHUNK(int8_t, true); break;
    default: PA_CHUNK(__nv_fp8_e4m3, true); break;
  }
#undef PA_CHUNK
  return static_cast<int>(cudaGetLastError());
}
