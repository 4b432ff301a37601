// Paged attention for the mixed chunked-prefill + decode step (B1/B2) and
// for the whole-mode decode step (B3/B4), for Hopper (sm_90a), over
// float32, bfloat16, int8 and fp8-e4m3 K/V pools.
//
// paged_attention_mixed replaces paddle_tpu/kernels/paged_attention.py:
// _mixed_kernel and its launcher _paged_mixed_call (float lanes: float32,
// and bfloat16 payloads, which the TPU kernel loads as k_ref[0].astype(f32)),
// and _mixed_kernel_quant with _dequant_kv, launched by
// _paged_mixed_call_quant (int8 and e4m3 payloads with per-block fp32 scales
// [N, H]). Each of the T rows of the mixed step is one query token with its
// own slot and its own context length; the row reads its slot's block table
// (two-level indirection: row -> slot -> physical block).
//
// paged_attention_decode replaces _decode_kernel, launched by _paged_call
// (B3), and _decode_kernel_quant, launched by _paged_call_quant (B4): the
// whole-mode decode step's ONE query per slot over tables[s], with
// seq_lens[s] keys (the slot's own token included). It is slot-major, so
// there is no row -> slot indirection.
//
// Both fold each key at a position below the row's context into an fp32
// online softmax and write the row's [H, d] output; a row with context 0
// (an inactive slot, an unused or masked row) writes an exact zero. A
// quantized lane dequantizes each key and value as payload * scale, with
// the scale the block's writer stored, before the unchanged fp32 fold.
// The fold itself is paged::fold_query (paged_attention.cuh), shared by
// both kernels; they differ only in how many keys a warp folds per step
// (below), which changes the order of the fp32 sums, not what is summed.
//
// What bounds them: memory bandwidth. A valid row of context ctx reads
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
//   - The warps split the row's keys in spans of kKeysPerStep: a warp
//     issues every table, K and V load of its span before any of the span's
//     math, and folds the span with one max/rescale into its own running
//     max, normaliser and accumulator in registers; one merge through
//     shared memory at the end combines the warps. No scratch in device
//     memory, no atomics, and the reduction order depends only on ctx, so
//     a row's output is the same whatever the other rows hold.
//   - The decode step launches S*H blocks (192 at 16 slots), too few to
//     hide latency by occupancy: the block with the longest context sets
//     the launch time, so it folds 4 keys per warp step (64 dependent
//     steps become 16 at ctx 512; measured 0.085 -> 0.057 ms in one call).
//     The mixed step's T*H blocks (960 at 80 rows) fill the card and keep
//     1 key per step (measured 0.076 against 0.084-0.093 ms with 4).
// The decode step has one row per slot, so no slot's K/V is read twice in
// one launch. The mixed step's rows of one prefill chunk share a slot and
// re-read the same K/V; the chunk kernel (paged_attention_chunk.cu) stages
// each key once per tile of rows instead. Left for later work: wider loads
// (a lane reads one 1- or 2-byte element at a time on the narrow lanes),
// split-K over long contexts, and cp.async/TMA prefetch of the next page.
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; each C entry returns cudaGetLastError().

#include "paged_attention.cuh"

namespace {

using paged::fold_query;
using paged::kMaxHeadDim;
using paged::kThreads;

// B1/B2: one block per (row t, head h); row t reads tables[row_slots[t]]
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
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const size_t row_off = (static_cast<size_t>(t) * H + h) * d;
  // keys past the table's P pages are never seen, as in the TPU grid
  const int ctx = min(ctx_lens[t], P * B);
  const int* table = ctx > 0
      ? tables + static_cast<size_t>(row_slots[t]) * P : nullptr;
  fold_query<T, kScaled, 1>(q + row_off, k_pool, v_pool, k_scale, v_scale,
                            table, ctx, out + row_off, H, h, d, B,
                            sm_scale);
}

// B3/B4: one block per (slot s, head h); slot s reads tables[s]
template <typename T, bool kScaled>
__global__ void __launch_bounds__(kThreads)
paged_attention_decode_kernel(const float* __restrict__ q,
                              const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ tables,
                              const int* __restrict__ seq_lens,
                              float* __restrict__ out,
                              int H, int d, int B, int P, float sm_scale) {
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const size_t row_off = (static_cast<size_t>(s) * H + h) * d;
  const int ctx = min(seq_lens[s], P * B);
  fold_query<T, kScaled, 4>(q + row_off, k_pool, v_pool, k_scale, v_scale,
                            tables + static_cast<size_t>(s) * P, ctx,
                            out + row_off, H, h, d, B, sm_scale);
}

// the lanes both entries take: 0 float32, 1 bfloat16, 2 int8 + scales,
// 3 fp8-e4m3 + scales
bool bad_args(int lane, const float* k_scale, const float* v_scale, int H,
              int d, int B, int P) {
  return d < 1 || d > kMaxHeadDim || B < 1 || P < 1 || H > 65535 ||
         lane < 0 || lane > 3 ||
         (lane >= 2 && (k_scale == nullptr || v_scale == nullptr));
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
  if (bad_args(lane, k_scale, v_scale, H, d, B, P)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(T), static_cast<unsigned>(H));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_MIXED(TYPE, SCALED)                                             \
  paged_attention_mixed_kernel<TYPE, SCALED><<<grid, kThreads, 0, st>>>(   \
      q, static_cast<const TYPE*>(k_pool), static_cast<const TYPE*>(v_pool), \
      k_scale, v_scale, tables, row_slots, ctx_lens, out, H, d, B, P,      \
      sm_scale)
  switch (lane) {
    case 0: PA_MIXED(float, false); break;
    case 1: PA_MIXED(__nv_bfloat16, false); break;
    case 2: PA_MIXED(int8_t, true); break;
    default: PA_MIXED(__nv_fp8_e4m3, true); break;
  }
#undef PA_MIXED
  return static_cast<int>(cudaGetLastError());
}

// The decode step: q [S, H, d] fp32, tables [S, P] int32, seq_lens [S]
// int32 (0 = inactive slot: zero row), out [S, H, d] fp32. Lanes as above.
extern "C" int paged_attention_decode(
    int lane, const float* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* seq_lens, float* out, int S, int H, int d, int B, int P,
    float sm_scale, void* stream) {
  if (S <= 0 || H <= 0) return 0;  // nothing to do
  if (bad_args(lane, k_scale, v_scale, H, d, B, P)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(S), static_cast<unsigned>(H));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_DECODE(TYPE, SCALED)                                            \
  paged_attention_decode_kernel<TYPE, SCALED><<<grid, kThreads, 0, st>>>(  \
      q, static_cast<const TYPE*>(k_pool), static_cast<const TYPE*>(v_pool), \
      k_scale, v_scale, tables, seq_lens, out, H, d, B, P, sm_scale)
  switch (lane) {
    case 0: PA_DECODE(float, false); break;
    case 1: PA_DECODE(__nv_bfloat16, false); break;
    case 2: PA_DECODE(int8_t, true); break;
    default: PA_DECODE(__nv_fp8_e4m3, true); break;
  }
#undef PA_DECODE
  return static_cast<int>(cudaGetLastError());
}
