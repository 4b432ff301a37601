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
// What bounds it: weight bytes, and at the decoder's shapes latency. The
// serving decoder calls it with M = 80 rows (16 decode rows + a 64-token
// prefill budget), so the work is 2*M*K*N operations on K*N weight bytes:
// for w1 (K 768, N 3072) that is 2.36 MB, 0.70 us at 3.35 TB/s, against
// 0.19 us of int8 tensor-core work. The call is a chain of two launches and
// a few memory round trips, and the design keeps that chain short:
//   - Pass 1 quantizes x once per call (one block a row, the row held in
//     registers): xq [M, K rounded up to 32] bytes and sx [M], the same
//     quotient and rounding as the plain version.
//   - Pass 2 is launched behind it as a programmatic dependent (measured
//     1.3 us less than a plain second launch; as a cluster launch its
//     blocks start as pass 1 ends, not during it). A block loads its
//     weight chunk by cp.async, then, after pass 1, its xq tile, and
//     transposes the weights to K-major in shared memory while xq lands
//     (8-bit operands are K-major, and ldmatrix's transpose takes 16-bit
//     elements only). One block covers all M <= 128 rows (a loop of
//     128-row tiles above that), so each weight byte is read from device
//     memory once.
//   - The products run on the tensor cores. int8: wgmma m64n64k32, both
//     operands K-major in shared memory (128-byte swizzle), an exact int32
//     sum. e4m3: the weights converted to f16 once a block, in the
//     transpose, and f16 mma.m16n8k16 with fp32 sums, each warp converting
//     its own xq fragments. sm_90a has no 8-bit float mma.sync of its own
//     (ptxas lowers it to a conversion at every product), and its 8-bit
//     float wgmma keeps too few accumulator bits for the plain version's
//     tolerance (measured 2e-4 of max|out| at K = 3072 with a fresh
//     accumulator every 32 deep; f16 products of e4m3 values are exact).
//   - K is split (quant_matmul.py: qmm_plan) so that about one block runs
//     on each SM: up to 8 splits with M <= 128 form one thread block
//     cluster and sum their partials through distributed shared memory;
//     otherwise the partials go to device memory and each column tile's
//     last block sums them. Either way the sum runs in split order, so two
//     launches give the same bits.
// Left for later work: the chain itself. At M = 80 on an H100 a call is
// about 9.5 us of device time: the weights from device memory ~2 us, xq
// from L2 ~1 us, the two cluster barriers with the sums ~3 us, and two
// launches (an empty pair measures 6.5 us of event time under
// chip_smoke.py's timing, one empty kernel 5.2 us). One launch (x
// quantized inside the product's cluster, without re-reading x per column
// tile) and e4m3 on f16 wgmma (tried with the A operand in registers:
// slower, each round waited on) are open.
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the C entry returns cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma_cp_async.cuh"

namespace {

constexpr int kBN = 64;          // output channels a block
constexpr int kBM = 128;         // rows a pass: 2 warpgroups x 64
constexpr int kThreads = 256;
constexpr int kChunkMax = 384;   // k a split covers, at most: 3 slabs
constexpr int kSlab = 128;       // k bytes a slab of a K-major tile
constexpr int kMaxCluster = 8;   // splits summed in a cluster's smem
constexpr int kPartPitch = kBN * 4 + 16;  // bytes a row of a smem partial
constexpr int kRawPitch = kBN;   // bytes a row of the raw weight chunk
// Shared memory: the raw wq chunk [k][n]; wq K-major [n][k] (int8 as is,
// e4m3 as f16); xq [row][k] for the rows of a pass (at most 128), later the
// cluster's partials; + 1024, as the K-major tiles are 1024-byte aligned
// for the 128-byte swizzle.
__host__ __device__ constexpr int smem_bytes(bool int8, int x_rows) {
  return kChunkMax * kRawPitch + kBN * kChunkMax * (int8 ? 1 : 2) +
         x_rows * kChunkMax + 1024;
}
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

// 4 bytes global -> shared (cp16 and the rest: tf32_mma_cp_async.cuh)
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
// four 8 x 16-byte matrices; lanes 8i..8i+7 give matrix i's row addresses
// and lane 4g + t receives bytes 4t..4t+3 of row g of each
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
// programmatic dependent launch: wait for the grid this one depends on
// (a no-op in a grid launched without the attribute); let the grid that
// depends on this one start its prologue
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// the thread block cluster: a barrier in two halves (arrive, then wait);
// release / acquire order shared-memory writes before the arrive with
// reads after the wait, cluster-wide
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// 16 bytes of block `rank`'s shared memory at the offset of addr
__device__ __forceinline__ uint4 ld_cluster16(uint32_t addr, int rank) {
  uint4 v;
  asm volatile(
      "{\n.reg .b32 a;\nmapa.shared::cluster.u32 a, %4, %5;\n"
      "ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [a];\n}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "r"(addr), "r"(rank));
  return v;
}

// wgmma's shared-memory matrix descriptor: 128-byte swizzle, K-major (sbo
// the bytes between 8-row groups)
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 | static_cast<uint64_t>(1024 >> 4)
                                              << 32 |
         static_cast<uint64_t>(1) << 62;
}
// the 32 accumulators of a 64 x 64 warpgroup tile: d[nt][e] of lane 4g + t
// in warp w is row 16w + g (+ 8 for e >= 2), column 8nt + 2t (+ 1 for odd
// e): mma.sync's layout, tile by tile
#define QMM_D8(i)                                                     \
  "+r"(d[i][0]), "+r"(d[i][1]), "+r"(d[i][2]), "+r"(d[i][3]),         \
      "+r"(d[i + 1][0]), "+r"(d[i + 1][1]), "+r"(d[i + 1][2]),        \
      "+r"(d[i + 1][3])
#define QMM_REGS                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"
// d (+)= A (64 x 32) * B (32 x 64), int8, both K-major in shared memory,
// an exact int32 sum; acc 0 zeroes d first. (e4m3 has a wgmma shape too,
// but its accumulator keeps fewer bits than fp32: at K = 3072 it misses
// the plain version by 2e-4 of max|out| even with a fresh accumulator
// every 32 deep, against a 1e-5 gate.)
__device__ __forceinline__ void wgmma_s8(int d[8][4], uint64_t a, uint64_t b,
                                       int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " QMM_REGS
      ", %32, %33, p;\n}\n"
      : QMM_D8(0), QMM_D8(2), QMM_D8(4), QMM_D8(6)
      : "l"(a), "l"(b), "r"(acc));
}
#undef QMM_D8
#undef QMM_REGS
// e4m3: sm_90a's 8-bit float mma.sync is no instruction of its own (ptxas
// lowers it to conversions and f16 products, converting every fragment at
// every product), and its 8-bit float wgmma keeps too few bits (above).
// So e4m3 runs as f16 mma with fp32 sums (e4m3 values and their products
// are exact in f16 and fp32): the weights are converted to f16 once a
// block, in the transpose, and each warp converts its own A fragments.
// Any k order is a sum: within each group of 16 k, the bytes 4t..4t+3
// stand at k 2t, 2t+1 and 8+2t, 9+2t, in A and B alike, so a 32-bit word
// of xq converts into two halves of an f16 A fragment.
__device__ __forceinline__ uint32_t e4m3x2_f16x2(uint32_t w, bool hi) {
  uint32_t r;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n"
      : "=r"(r)
      : "h"(static_cast<unsigned short>(hi ? w >> 16 : w & 0xffffu)));
  return r;
}
// a: the e4m3 A fragment (ldmatrix of xq, 32 k) as two f16 A fragments
__device__ __forceinline__ void a_f16(const uint32_t a[4], uint32_t f[8]) {
  f[0] = e4m3x2_f16x2(a[0], false);
  f[1] = e4m3x2_f16x2(a[1], false);
  f[2] = e4m3x2_f16x2(a[0], true);
  f[3] = e4m3x2_f16x2(a[1], true);
  f[4] = e4m3x2_f16x2(a[2], false);
  f[5] = e4m3x2_f16x2(a[3], false);
  f[6] = e4m3x2_f16x2(a[2], true);
  f[7] = e4m3x2_f16x2(a[3], true);
}
// d += a (16 x 16, f16, row) * b (16 x 8, f16, col), fp32 sums
__device__ __forceinline__ void mma16(float d[4], const uint32_t* a,
                                      uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes by the threads (generic proxy) before wgmma reads
// them (async proxy)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The K-major tiles, as wgmma reads them: slabs of 128 k bytes, each
// [rows][128 B] with 16-byte piece p of row r at ((p ^ (r % 8)) << 4)
// (the 128-byte swizzle); piece p of the k axis lies in slab p / 8.
__device__ __forceinline__ uint32_t k_at(uint32_t base, int rows, int r,
                                         int p) {
  return base + (p >> 3) * rows * kSlab + r * kSlab +
         (((p & 7) ^ (r & 7)) << 4);
}
// the raw chunk: piece p of row k (4 a row) at ((p ^ ((k >> 2) & 3)) << 4),
// so the transposing warp's loads spread over the banks
__device__ __forceinline__ uint32_t raw_at(uint32_t base, int k, int p) {
  return base + k * kRawPitch + ((p ^ ((k >> 2) & 3)) << 4);
}

// Pass 1: one block a row. sx = max(absmax, 1e-8) / qmax; the row's bytes
// to xq [M, Kp] (zeros past K); block 0 also zeroes the split counters.
template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const float* __restrict__ x, uint32_t* __restrict__ xq,
                     float* __restrict__ sx, int* __restrict__ counters,
                     int n_counters, int K, int Kp) {
  constexpr int kHeld = 4;  // float4 a thread keeps: K <= 4096 read once
  pdl_launch_dependents();
  __shared__ float s_max[kThreads / 32];
  const int m = blockIdx.x;
  const float4* xr = reinterpret_cast<const float4*>(
      x + static_cast<size_t>(m) * K);
  const int K4 = K >> 2;
  float4 held[kHeld];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int i = threadIdx.x + j * kThreads;
    held[j] = i < K4 ? xr[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = threadIdx.x + kHeld * kThreads; i < K4; i += kThreads) {
    const float4 v = xr[i];
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                             fmaxf(fabsf(v.z), fabsf(v.w))));
  }
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const float4 v = held[j];
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                             fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = amax;
  if (m == 0) {
    for (int i = threadIdx.x; i < n_counters; i += kThreads) counters[i] = 0;
  }
  __syncthreads();
  amax = s_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, s_max[w]);
  const float s = fmaxf(amax, kTiny) / (kInt8 ? 127.f : 448.f);
  if (threadIdx.x == 0) sx[m] = s;
  uint32_t* out = xq + static_cast<size_t>(m) * (Kp >> 2);
  auto word_of = [s](float4 v) {
    return quantize<kInt8>(v.x, s) | (quantize<kInt8>(v.y, s) << 8) |
           (quantize<kInt8>(v.z, s) << 16) | (quantize<kInt8>(v.w, s) << 24);
  };
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < (Kp >> 2)) out[i] = i < K4 ? word_of(held[j]) : 0u;
  }
  for (int i = threadIdx.x + kHeld * kThreads; i < (Kp >> 2); i += kThreads) {
    out[i] = i < K4 ? word_of(xr[i]) : 0u;
  }
}

// Pass 2: block (column tile, split z) multiplies xq [M, chunk of k] by the
// wq chunk [chunk of k, 64 columns] on the tensor cores:
//   1. the raw wq chunk by cp.async, issued before the wait for pass 1
//      (a programmatic dependent launch may start while pass 1 runs), then
//      the first 128-row tile of xq;
//   2. wq transposed to K-major in shared memory while xq lands: a thread
//      takes a 4 (k) x 4 (n) byte square, four 32-bit loads and six
//      __byte_perm;
//   3. per 128-row tile, warp w takes rows 16w..16w+15 x 64 columns:
//      ldmatrix.x4 fragments and mma.m16n8k32;
//   4. one split: the epilogue. Splits in a cluster (M <= 128, at most 8
//      splits): each block leaves its partial in shared memory, and block
//      z sums rows [z M / splits, ...) over the cluster's blocks in split
//      order. Otherwise each split writes its partial to part [splits, M,
//      N], and the column tile's last block sums them in split order. So
//      two launches give the same bits. The epilogue is float(acc) * sx *
//      w_scale, in that order.
template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const uint32_t* __restrict__ xq, const float* __restrict__ sx,
           const uint8_t* __restrict__ wq, const float* __restrict__ w_scale,
           float* __restrict__ out, float* __restrict__ part,
           int* __restrict__ counters, int M, int K, int N, int Kp,
           int chunk, int splits, int cluster, int x_rows) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  extern __shared__ __align__(128) unsigned char qsmem[];
  const uint32_t sRaw = (smem_u32(qsmem) + 1023) & ~1023u;
  const uint32_t sW = sRaw + kChunkMax * kRawPitch;
  const uint32_t sX = sW + kBN * kChunkMax * (kInt8 ? 1 : 2);
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int z = blockIdx.y;
  const int k_lo = z * chunk;
  const int kw = min(Kp, k_lo + chunk) - k_lo;  // a multiple of 32
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(xq);

  // 1. the raw chunk: 4 pieces of 16 bytes a row (or 16 words of 4 when
  //    N is no multiple of 16), zeros past K and past N
  const bool vec = (N & 15) == 0;
  for (int i = tid; i < kw * 4; i += kThreads) {
    const int r = i >> 2;
    const int p = i & 3;
    const int k = k_lo + r;
    const int n = n0 + 16 * p;
    const uint8_t* src = wq + static_cast<size_t>(k) * N + n;
    if (vec) {
      cp16(raw_at(sRaw, r, p), k < K && n < N ? src : wq, k < K && n < N);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = k < K && n + 4 * j < N;
        cp4(raw_at(sRaw, r, p) + 4 * j, ok ? src + 4 * j : wq, ok);
      }
    }
  }
  cp_commit();

  pdl_wait();  // xq, sx and the counters come from pass 1
  // the xq tile [128 rows, kw] from row m0: the rows up to M rounded up to
  // a warp's 16, zeros past M
  const int pieces = kw >> 4;
  auto load_x = [&](int m0) {
    const int rows = min(kBM, (M - m0 + 15) / 16 * 16);
    for (int i = tid; i < rows * pieces; i += kThreads) {
      const int r = i / pieces;
      const int p = i % pieces;
      const bool ok = m0 + r < M;
      cp16(k_at(sX, x_rows, r, p),
           ok ? xb + static_cast<size_t>(m0 + r) * Kp + k_lo + 16 * p : xb,
           ok);
    }
    cp_commit();
  };
  load_x(0);

  // 2. transpose while xq lands: thread (kq, c) reads rows 4kq..4kq+3 at
  //    word c (the row order flipped on odd kq) and writes the four
  //    columns' words; a warp takes 8 kq x 4 c, so loads and stores hit
  //    at most two lanes a bank
  cp_wait<1>();
  __syncthreads();
  for (int gi = warp; gi < (kw >> 5) * 4; gi += kThreads / 32) {
    const int kq = 8 * (gi >> 2) + (lane >> 2);
    const int c = 4 * (gi & 3) + (lane & 3);
    const int flip = kq & 1;
    uint32_t a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * kq + (j ^ flip);
      a[j] = lds32(raw_at(sRaw, r, c >> 2) + 4 * (c & 3));
    }
    // w[j]: columns 4c..4c+3 at k = 4kq + j
    const uint32_t w0 = flip ? a[1] : a[0], w1 = flip ? a[0] : a[1];
    const uint32_t w2 = flip ? a[3] : a[2], w3 = flip ? a[2] : a[3];
    const uint32_t t01_lo = __byte_perm(w0, w1, 0x5140);
    const uint32_t t01_hi = __byte_perm(w0, w1, 0x7362);
    const uint32_t t23_lo = __byte_perm(w2, w3, 0x5140);
    const uint32_t t23_hi = __byte_perm(w2, w3, 0x7362);
    // col[cc]: k 4kq..4kq+3 of column 4c + cc
    const uint32_t col[4] = {__byte_perm(t01_lo, t23_lo, 0x5410),
                             __byte_perm(t01_lo, t23_lo, 0x7632),
                             __byte_perm(t01_hi, t23_hi, 0x5410),
                             __byte_perm(t01_hi, t23_hi, 0x7632)};
    if constexpr (kInt8) {
      const int kb = 4 * kq;  // byte offset in a K-major row
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        sts32(k_at(sW, kBN, 4 * c + cc, kb >> 4) + (kb & 15), col[cc]);
      }
    } else {
      // f16: the bytes 4t..4t+3 of group kq / 4 (t = kq % 4) to k 2t, 2t+1
      // (piece 2 * group) and 8+2t, 9+2t (piece 2 * group + 1)
      const int grp = kq >> 2;
      const int off = 4 * (kq & 3);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        sts32(k_at(sW, kBN, 4 * c + cc, 2 * grp) + off,
              e4m3x2_f16x2(col[cc], false));
        sts32(k_at(sW, kBN, 4 * c + cc, 2 * grp + 1) + off,
              e4m3x2_f16x2(col[cc], true));
      }
    }
  }
  fence_async();

  const int n_steps = kw >> 5;
  for (int m0 = 0; m0 < M; m0 += kBM) {
    if (m0 > 0) {
      __syncthreads();  // the previous tile's readers are done
      load_x(m0);
    }
    cp_wait<0>();
    fence_async();
    __syncthreads();
    // 3. the products. int8: warpgroup wg takes rows 64wg..64wg+63 by
    //    wgmma. e4m3: warp w takes rows 16w..16w+15 by mma.sync, its
    //    fragments by ldmatrix. Warp w of the block holds rows 16w..16w+15
    //    in the accumulator layout either way.
    const int rb = m0 + warp * 16;
    Acc acc[8][4] = {};
    if constexpr (kInt8) {
      const int wg = warp >> 2;
      if (m0 + 64 * wg < M) {  // a warpgroup past M skips its products
        const uint32_t xa = sX + 64 * wg * kSlab;
        wg_fence();
        for (int ks = 0; ks < n_steps; ++ks) {  // slab ks / 4, 32 B in
          const int slab = (ks >> 2) * kSlab;
          const int in = (ks & 3) * 32;
          wgmma_s8(acc, desc(xa + slab * x_rows + in),
                   desc(sW + slab * kBN + in), ks);
        }
        wg_commit();
        wg_wait();
      }
    } else if (rb < M) {
      for (int ks = 0; ks < n_steps; ++ks) {
        uint32_t a[4], fa[8];
        ldsm_x4(k_at(sX, x_rows, warp * 16 + (lane & 15),
                     2 * ks + (lane >> 4)),
                a);
        a_f16(a, fa);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the two f16 groups of the step
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            ldsm_x4(k_at(sW, kBN, np * 16 + (lane & 7) + ((lane >> 4) << 3),
                         2 * (2 * ks + h) + ((lane >> 3) & 1)),
                    b);
            mma16(acc[2 * np], fa + 4 * h, b[0], b[1]);
            mma16(acc[2 * np + 1], fa + 4 * h, b[2], b[3]);
          }
        }
      }
    }
    // 4. the epilogue, or this split's partial (in shared memory for the
    //    cluster, else in part)
    if (cluster > 1) __syncthreads();  // sX is read no more
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rb + g + 8 * h;
      if (row >= M) continue;
      const float s = sx[row];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = nt * 8 + 2 * t;
        const int col = n0 + c;  // N % 4 == 0: col + 1 < N too
        if (col >= N) continue;
        const Acc v0 = acc[nt][2 * h], v1 = acc[nt][2 * h + 1];
        float2 o;
        if (splits == 1) {
          o.x = static_cast<float>(v0) * s * w_scale[col];
          o.y = static_cast<float>(v1) * s * w_scale[col + 1];
          *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * N +
                                     col) = o;
          continue;
        }
        o.x = kInt8 ? __int_as_float(v0) : static_cast<float>(v0);
        o.y = kInt8 ? __int_as_float(v1) : static_cast<float>(v1);
        if (cluster > 1) {
          *reinterpret_cast<float2*>(qsmem + (sX - smem_u32(qsmem)) +
                                     (row - m0) * kPartPitch + 4 * c) = o;
        } else {
          *reinterpret_cast<float2*>(
              part + (static_cast<size_t>(z) * M + row) * N + col) = o;
        }
      }
    }
  }
  if (splits == 1) return;

  // the sum over the splits, in split order (tot += v), then the epilogue;
  // every load of a batch is issued before the first add waits on one
  auto add = [](uint4& tot, const uint4& v) {
    if (kInt8) {
      tot.x = static_cast<uint32_t>(static_cast<int>(tot.x) +
                                    static_cast<int>(v.x));
      tot.y = static_cast<uint32_t>(static_cast<int>(tot.y) +
                                    static_cast<int>(v.y));
      tot.z = static_cast<uint32_t>(static_cast<int>(tot.z) +
                                    static_cast<int>(v.z));
      tot.w = static_cast<uint32_t>(static_cast<int>(tot.w) +
                                    static_cast<int>(v.w));
    } else {
      tot.x = __float_as_uint(__uint_as_float(tot.x) + __uint_as_float(v.x));
      tot.y = __float_as_uint(__uint_as_float(tot.y) + __uint_as_float(v.y));
      tot.z = __float_as_uint(__uint_as_float(tot.z) + __uint_as_float(v.z));
      tot.w = __float_as_uint(__uint_as_float(tot.w) + __uint_as_float(v.w));
    }
  };
  auto as_float = [](uint32_t u) {
    return kInt8 ? static_cast<float>(static_cast<int>(u))
                 : __uint_as_float(u);
  };
  auto epilogue = [&](int row, int c4, const uint4& tot, float s,
                      const float4& ws) {
    float4 o;
    o.x = as_float(tot.x) * s * ws.x;
    o.y = as_float(tot.y) * s * ws.y;
    o.z = as_float(tot.z) * s * ws.z;
    o.w = as_float(tot.w) * s * ws.w;
    *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * N + n0 +
                               4 * c4) = o;
  };
  auto w_scale4 = [&](int c4) {
    return *reinterpret_cast<const float4*>(w_scale + n0 + 4 * c4);
  };
  if (cluster > 1) {
    // block z sums rows [z * per, ...): per <= 64 rows of 16 float4, at
    // most kItems a thread, whose scales load while the cluster meets; its
    // reads of the peers are done before its second arrive, and no block
    // leaves before every block has arrived
    constexpr int kItems = (kBM / 2) * (kBN / 4) / kThreads;
    const int per = (M + splits - 1) / splits;
    const int r0 = min(M, z * per);
    const int n_items = (min(M, r0 + per) - r0) * (kBN / 4);
    float s_of[kItems];
    float4 ws_of[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = tid + j * kThreads;
      const int c4 = i % (kBN / 4);
      if (i >= n_items || n0 + 4 * c4 >= N) continue;
      s_of[j] = sx[r0 + i / (kBN / 4)];
      ws_of[j] = w_scale4(c4);
    }
    cluster_arrive();  // every block's partial is in its shared memory
    cluster_wait();
    uint4 tot[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = tid + j * kThreads;
      const int c4 = i % (kBN / 4);
      if (i >= n_items || n0 + 4 * c4 >= N) continue;
      const uint32_t at = sX + (r0 + i / (kBN / 4)) * kPartPitch + 16 * c4;
      uint4 v[kMaxCluster];
#pragma unroll
      for (int zz = 0; zz < kMaxCluster; ++zz) {
        if (zz < splits) v[zz] = ld_cluster16(at, zz);
      }
      tot[j] = v[0];
#pragma unroll
      for (int zz = 1; zz < kMaxCluster; ++zz) {
        if (zz < splits) add(tot[j], v[zz]);
      }
    }
    cluster_arrive();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = tid + j * kThreads;
      const int c4 = i % (kBN / 4);
      if (i < n_items && n0 + 4 * c4 < N) {
        epilogue(r0 + i / (kBN / 4), c4, tot[j], s_of[j], ws_of[j]);
      }
    }
    cluster_wait();
    return;
  }
  // the column tile's last block sums the partials in part
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters + blockIdx.x, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const size_t stride = static_cast<size_t>(M) * N;
  for (int i = tid; i < M * (kBN / 4); i += kThreads) {
    const int row = i / (kBN / 4);
    const int c4 = i % (kBN / 4);
    if (n0 + 4 * c4 >= N) continue;
    const float* at = part + static_cast<size_t>(row) * N + n0 + 4 * c4;
    uint4 tot = make_uint4(0u, 0u, 0u, 0u);
    for (int z0 = 0; z0 < splits; z0 += kMaxCluster) {
      uint4 v[kMaxCluster];
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j) {
        if (z0 + j < splits) {
          v[j] = __ldcg(reinterpret_cast<const uint4*>(at + (z0 + j) *
                                                       stride));
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j) {
        if (z0 + j == 0) {
          tot = v[0];
        } else if (z0 + j < splits) {
          add(tot, v[j]);
        }
      }
    }
    epilogue(row, c4, tot, sx[row], w_scale4(c4));
  }
}

template <bool kInt8>
cudaError_t launch(const float* x, const void* wq, const float* w_scale,
                   float* out, void* xq, float* sx, int* counters,
                   float* part, int M, int K, int N, int splits, int chunk,
                   cudaStream_t st) {
  const int Kp = (K + 31) / 32 * 32;
  const int col_tiles = (N + kBN - 1) / kBN;
  // splits summed in the cluster's shared memory, or through part
  const int cluster = splits > 1 && splits <= kMaxCluster && M <= kBM
                          ? splits : 1;
  const bool global = splits > 1 && cluster == 1;
  quantize_rows_kernel<kInt8><<<M, kThreads, 0, st>>>(
      x, static_cast<uint32_t*>(xq), sx, counters, global ? col_tiles : 0,
      K, Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // above 48 KB a kernel takes dynamic shared memory only after opting
  // in, once for each device
  static bool opted[64] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64 || !opted[dev]) {
    err = cudaFuncSetAttribute(qmm_kernel<kInt8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(kInt8, kBM));
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < 64) opted[dev] = true;
  }
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = static_cast<unsigned>(cluster);
  attr[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(col_tiles),
                     static_cast<unsigned>(splits));
  cfg.blockDim = dim3(kThreads);
  // xq rows a pass holds: int8's wgmma reads a warpgroup's 64 rows from
  // shared memory; e4m3's mma.sync a warp's 16
  const int x_rows = kInt8 ? min(kBM, (M + 63) / 64 * 64)
                           : min(kBM, (M + 15) / 16 * 16);
  cfg.dynamicSmemBytes = smem_bytes(kInt8, x_rows);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, qmm_kernel<kInt8>,
                            static_cast<const uint32_t*>(xq),
                            static_cast<const float*>(sx),
                            static_cast<const uint8_t*>(wq), w_scale, out,
                            part, counters, M, K, N, Kp, chunk, splits,
                            cluster, x_rows);
}

}  // namespace

// lane 0: int8 weights; lane 1: fp8-e4m3 weights. K and N multiples of 4,
// x and wq 16-byte aligned (the wrapper checks). The wrapper's plan
// (quant_matmul.py: qmm_plan) gives splits and chunk (a multiple of 32, at
// most 384, splits * chunk covering K rounded up to 32) and the scratch:
// xq [M, Kp] bytes and sx [M] fp32; with more than 8 splits or M > 128
// also counters [N / 64 rounded up] int32 and part [splits, M, N] fp32.
extern "C" int quant_matmul(int lane, const float* x, const void* wq,
                            const float* w_scale, float* out, void* xq,
                            float* sx, int* counters, float* part, int M,
                            int K, int N, int splits, int chunk,
                            void* stream) {
  if (M <= 0 || N <= 0) return 0;  // nothing to do
  const int Kp = (K + 31) / 32 * 32;
  if (K < 4 || (K & 3) || (N & 3) || (lane != 0 && lane != 1) ||
      splits < 1 || splits > 65535 || chunk < 32 || chunk > kChunkMax ||
      (chunk & 31) || (splits - 1) * chunk >= Kp || splits * chunk < Kp ||
      M > 2147483647 / 16 ||
      (splits > 1 && (splits > kMaxCluster || M > kBM) &&
       (!counters || !part))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      lane == 0 ? launch<true>(x, wq, w_scale, out, xq, sx, counters, part,
                               M, K, N, splits, chunk, s)
                : launch<false>(x, wq, w_scale, out, xq, sx, counters, part,
                                M, K, N, splits, chunk, s);
  return static_cast<int>(err);
}
