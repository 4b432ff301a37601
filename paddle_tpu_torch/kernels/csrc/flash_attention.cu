// Flash attention for Hopper (sm_90a): the forward (B8) and the two
// backward kernels, dq and dk/dv (B9), with a float32 lane (the forward on
// the CUDA cores, the backward on the tensor cores as 3xTF32) and a
// bfloat16 lane on the tensor cores (wgmma).
//
// flash_attention_fwd replaces paddle_tpu/kernels/flash_attention.py:
// _fwd_kernel, launched by _fwd_call; flash_attention_dq and
// flash_attention_dkv replace _dq_kernel and _dkv_kernel, launched by
// _bwd_call. Layout [B, H, T, d] row-major; q may be shorter or longer
// than k/v (Tq != Tk). The causal mask is position-based and top-left
// aligned (kpos <= qpos), as on the TPU. Every score, softmax statistic and
// accumulator is fp32 whatever the payload (the Pallas bodies upcast each
// block with .astype(f32)); the outputs are written in the inputs' dtype,
// the forward's logsumexp (lse) in fp32. A row that sees no key (Tk = 0)
// gets out 0 and lse = -1e30, the finite stand-in for -inf.
//
// What bounds them: arithmetic. At the transformer's shape (B 16, H 12,
// T 512, d 64, causal) the forward does 4*B*H*T*T*d/2 = 6.4 GFLOP over
// 25 MB of q/k/v/out (bf16), about 250 FLOP per byte: operations-bound on
// the CUDA cores (67 TFLOP/s fp32), near the ridge on the bf16 tensor
// cores. What every kernel shares:
//   - A block owns one (batch*head, 64-row tile). The forward and dq walk
//     the 64-key tiles of K/V; dk/dv walks the 64-row tiles of q/dO for its
//     own key tile. Nothing carries between blocks (the TPU grid's
//     sequential innermost axis becomes the loop inside the block), so
//     there are no atomics and no scratch in device memory, the [T, T]
//     scores never leave the chip, and the sum order is fixed by the
//     shapes alone: two launches are bit-equal.
//   - Under the causal mask a block skips every tile strictly above the
//     diagonal (the Pallas kernels' pl.when), so the work is about half;
//     the blocks with the most tiles launch first.
//   - Tiles are staged in shared memory, zero-filled past Tq/Tk and past
//     d, so the ragged tail is masked in the kernel and nothing is padded
//     in device memory (the TPU wrapper's _pad_seq).
//
// The float32 lane. The forward (namespace simt) runs on the CUDA cores:
// 256 threads (16 x 16), each a 4 x 4 register tile; tiles staged as fp32
// [depth][64 + 4]; P goes through shared memory, transposed, to the next
// product. No plain TF32: it would break fp32 parity. The backward
// (namespace tf32) runs on the tensor cores as 3xTF32: every fp32 operand
// is split into tf32 hi + lo halves and each product is a_lo b_hi + a_hi
// b_lo + a_hi b_hi (mma.sync m16n8k8), fp32 to ~2^-21. 128 threads,
// warp w owning rows 16w..16w+15; tiles staged by cp.async, double-
// buffered, as they lie in device memory ([row][64 + 4], conflict-free
// fragment loads); P and dS stay in the accumulators and are the A
// fragment of the next product as they lie (its k-steps take the two
// columns a lane holds), so nothing is transposed. Measured on an H100
// (PERF.md): 1.4x faster than a register-blocked CUDA-core tile (8 x 4 a
// thread, the design first written for this lane), inside the fp32 gate.
//
// The bfloat16 lane (namespace tc): one warpgroup (128 threads) a block,
// warp w owning rows 16w..16w+15 of the 64-row tile. Tiles of 64 rows flow
// through a 2-stage cp.async ring (zeros past Tq/Tk by the src-size
// operand) in the 128-byte swizzle that wgmma reads, so an operand is read
// K-major or MN-major as it lies and nothing is transposed in staging.
// Every product is wgmma m64n64k16 with fp32 accumulators: a product over
// d takes both operands from shared memory (S = Q K^T, dP = dO V^T, and in
// dk/dv S^T = K Q^T, dP^T = V dO^T, so P^T and dS^T come out in
// accumulator layout); a product over the tile takes the fp32 P or dS from
// registers. The Pallas kernels multiply P and dS in fp32; rounding them to
// bf16 would add a 2^-9 relative error to every term, so each is split
// into bf16 hi + lo halves and multiplied twice (error ~2^-17): 1.5x the
// tensor work of a bf16-P forward, 2x that of a bf16-dS backward, by
// design. Every exponential is one ex2 of an FFMA (scale * log2 e folded
// in); the masks run only on the diagonal and tail tiles.
//   - Forward (B8): K/V tiles through the ring; S, the online softmax on S
//     in registers, O += P V (8 wgmma, P's hi and lo halves). Measured on
//     an H100 (PERF.md): one warpgroup a block with 2 stages beat two (128
//     rows) and 3-4 stages, and five blocks an SM (96 registers, no
//     spills) beat four (123).
//   - dq: Q and dO loaded once; K/V tiles through the ring; S and dP (8
//     wgmma from shared memory), p = 2^(s scale log2 e - lse log2 e), ds =
//     p (dp - delta) scale in registers, dQ += dS K (8 wgmma, K read
//     MN-major).
//   - dk/dv: K and V loaded once; Q/dO tiles and their lse and delta
//     through the ring, from the diagonal on; S^T and dP^T (8 wgmma),
//     dV += P^T dO and dK += dS^T Q (16 wgmma, dO and Q MN-major).
//
// Left for later work: overlapping a warpgroup's elementwise work with its
// next tile's products (every kernel waits on each wgmma group in turn),
// and the fp32 forward on the backward's 3xTF32 products.
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; each C entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // q rows / keys per tile
constexpr int kMaxD = 64;            // head_dim capacity (zero-padded)
constexpr float kNegInf = -1e30f;    // finite stand-in for -inf

__device__ __forceinline__ bool visible(int qp, int kp, int Tq, int Tk,
                                        int causal) {
  return qp < Tq && kp < Tk && (!causal || kp <= qp);
}

// key tiles a q tile starting at q0 reads: all of them, or up to the
// diagonal under the causal mask
__device__ __forceinline__ int key_tiles(int q0, int Tk, int causal) {
  const int n = (Tk + kTile - 1) / kTile;
  return causal ? min(n, (q0 + kTile - 1) / kTile + 1) : n;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared without the registers; zeros (src unread)
// when !ok
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------- float32: CUDA cores
namespace simt {

constexpr int kLd = kTile + 4;       // padded row of a staged tile, floats
constexpr int kBuf = kTile * kLd;    // floats per staged tile
constexpr int kThreads = 256;        // 16 x 16, a 4 x 4 micro-tile each

// max / sum over the 16 lanes that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Stage rows [r0, r0 + 64) of the row-major [n_rows, d] matrix g into s,
// zero past n_rows and past d: s[c * kLd + r] when kTrans (depth major, for
// the score products), else s[r * kLd + c].
template <bool kTrans>
__device__ __forceinline__ void stage(const float* __restrict__ g, int r0,
                                      int n_rows, int d,
                                      float* __restrict__ s) {
  for (int idx = threadIdx.x; idx < kTile * kMaxD; idx += kThreads) {
    const int r = idx / kMaxD;
    const int c = idx % kMaxD;
    float x = 0.f;
    if (r0 + r < n_rows && c < d) {
      x = g[static_cast<size_t>(r0 + r) * d + c];
    }
    if (kTrans) {
      s[c * kLd + r] = x;
    } else {
      s[r * kLd + c] = x;
    }
  }
}

// acc[i][j] += sum_t A[t][ra + i] * B[t][cb + j] over the 64 depth steps
// of two staged tiles
__device__ __forceinline__ void tile_product(const float* __restrict__ A,
                                             const float* __restrict__ B,
                                             int ra, int cb,
                                             float acc[4][4]) {
#pragma unroll 8
  for (int t = 0; t < kTile; ++t) {
    const float4 a = *reinterpret_cast<const float4*>(A + t * kLd + ra);
    const float4 b = *reinterpret_cast<const float4*>(B + t * kLd + cb);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// write a 4 x 4 register tile transposed: s[(c0 + j) * kLd + r0 + i]
__device__ __forceinline__ void put_transposed(float* __restrict__ s, int r0,
                                               int c0, const float x[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float4*>(s + (c0 + j) * kLd + r0) =
        make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
  }
}

// B8: one block per (batch*head, 64-row q tile).
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out,
           float* __restrict__ lse, int Tq, int Tk, int d, int causal,
           float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;             // [d][q row]
  float* sKt = smem + kBuf;      // [d][key]
  float* sV = smem + 2 * kBuf;   // [key][d]
  float* sPt = smem + 3 * kBuf;  // [key][q row]
  const int tx = threadIdx.x & 15;  // keys / dims tx*4 .. +3
  const int ty = threadIdx.x >> 4;  // q rows ty*4 .. +3
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const float* kb = k + bh * Tk * d;
  const float* vb = v + bh * Tk * d;
  stage<true>(q + bh * Tq * d, q0, Tq, d, sQt);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const int n_kt = key_tiles(q0, Tk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    stage<true>(kb, k0, Tk, d, sKt);
    stage<false>(vb, k0, Tk, d, sV);
    __syncthreads();
    float s[4][4] = {};
    tile_product(sQt, sKt, ty * 4, tx * 4, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(qp, k0 + tx * 4 + j, Tq, Tk, causal)
                      ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(qp, k0 + tx * 4 + j, Tq, Tk, causal)
                      ? expf(s[i][j] - m_new) : 0.f;
        ps += s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    put_transposed(sPt, ty * 4, tx * 4, s);
    __syncthreads();
    tile_product(sPt, sV, ty * 4, tx * 4, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Tq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    float* o = out + (bh * Tq + qp) * d;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx * 4 + j;
      if (c < d) o[c] = acc[i][j] / safe_l;
    }
    if (tx == 0) {
      lse[bh * Tq + qp] = l[i] == 0.f ? kNegInf : m[i] + logf(safe_l);
    }
  }
}

constexpr int kFwdSmem = 4 * kBuf * 4;  // bytes

}  // namespace simt

// --------------------------- float32 backward: 3xTF32 on the tensor cores
namespace tf32 {

constexpr int kBwdThreads = 128;        // 4 warps, 16 tile rows each
constexpr int kLd = kMaxD + 4;          // padded staged row, floats
constexpr int kTileF = kTile * kLd;     // floats of a staged tile
// bytes: two resident tiles (Q and dO, or K and V) and 2 stages of the
// other two
constexpr int kSmem = 6 * kTileF * 4;

// x = hi + lo: hi is x rounded to its top 11 significant bits (tf32) by
// an integer add and mask (cvt.rna.tf32 runs at a quarter of their rate),
// lo = x - hi exactly, of which the tensor core reads the top 11 bits: x
// to ~2^-21
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a * b, m16n8k8, tf32 in, fp32 accumulate. Fragments (lane 4g + t):
// a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4];
// b0 = B[t][g], b1 = B[t + 4][g]; d0, d1 = D[g][2t, 2t + 1], d2, d3 =
// D[g + 8][2t, 2t + 1].
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] += A * B over one k-step of 8 for the 8 column tiles nt, as the
// fp32 product 3xTF32 gives it: a_lo b_hi + a_hi b_lo + a_hi b_hi (the
// a_lo b_lo term, ~2^-22 of the product, is dropped). b[nt] holds B's hi
// fragment (b0, b1), then its lo fragment.
__device__ __forceinline__ void mma3(float acc[8][4], const uint32_t ahi[4],
                                     const uint32_t alo[4],
                                     const uint32_t b[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) mma(acc[nt], alo, b[nt][0], b[nt][1]);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) mma(acc[nt], ahi, b[nt][2], b[nt][3]);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) mma(acc[nt], ahi, b[nt][0], b[nt][1]);
}

// Stage rows [r0, r0 + 64) of the row-major [n_rows, d] matrix g into the
// padded tile s[64][kLd], zeros past n_rows and past d: by cp.async when
// vec (d % 4 == 0, g 16-byte aligned), else by scalar loads.
__device__ __forceinline__ void stage(const float* __restrict__ g, int r0,
                                      int n_rows, int d, bool vec,
                                      float* __restrict__ s) {
  if (vec) {
#pragma unroll
    for (int i = threadIdx.x; i < kTile * 16; i += kBwdThreads) {
      const int r = i >> 4;
      const int c4 = i & 15;
      const bool ok = r0 + r < n_rows && 4 * c4 < d;
      cp16(smem_u32(s + r * kLd + 4 * c4),
           ok ? g + static_cast<size_t>(r0 + r) * d + 4 * c4 : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kMaxD; i += kBwdThreads) {
      const int r = i >> 6;
      const int c = i & 63;
      s[r * kLd + c] = r0 + r < n_rows && c < d
                           ? g[static_cast<size_t>(r0 + r) * d + c] : 0.f;
    }
  }
}

// acc (16 x 64: 8 tiles of 8 columns) += A B^T over the 64 columns of two
// staged tiles: rows rb..rb+15 of A against every row of B (a product over
// d, both operands read along their rows; the padding makes each fragment
// load conflict-free)
__device__ __forceinline__ void prod_rows(const float* __restrict__ A,
                                          const float* __restrict__ B,
                                          int rb, float acc[8][4]) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const float* a = A + (rb + g) * kLd + t;
  const float* b = B + g * kLd + t;
#pragma unroll 2
  for (int ks = 0; ks < 8; ++ks) {
    uint32_t ahi[4], alo[4], bf[8][4];
    split(a[8 * ks], ahi[0], alo[0]);
    split(a[8 * kLd + 8 * ks], ahi[1], alo[1]);
    split(a[8 * ks + 4], ahi[2], alo[2]);
    split(a[8 * kLd + 8 * ks + 4], ahi[3], alo[3]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* bp = b + 8 * nt * kLd + 8 * ks;
      split(bp[0], bf[nt][0], bf[nt][2]);
      split(bp[4], bf[nt][1], bf[nt][3]);
    }
    mma3(acc, ahi, alo, bf);
  }
}

// acc (16 x 64 over d) += X B over the 64 rows of the staged tile B, for
// an fp32 X (16 x 64) in accumulator layout: k-step ks takes columns
// 8ks + 2t (k index t) and 8ks + 2t + 1 (t + 4) of X, the two this lane
// holds, and the same rows of B, so X is the A fragment as it lies. The
// tile's product is summed in a fresh accumulator and added to acc with
// fp32 adds that round to nearest: the tensor core's own adds truncate,
// and acc runs over every tile of a row.
__device__ __forceinline__ void prod_cols(const float x[8][4],
                                          const float* __restrict__ B,
                                          float acc[8][4]) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const float* b = B + 2 * t * kLd + g;
  float part[8][4] = {};
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    uint32_t ahi[4], alo[4], bf[8][4];
    split(x[ks][0], ahi[0], alo[0]);
    split(x[ks][2], ahi[1], alo[1]);
    split(x[ks][1], ahi[2], alo[2]);
    split(x[ks][3], ahi[3], alo[3]);
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      const float* bp = b + 8 * ks * kLd + 8 * nd;
      split(bp[0], bf[nd][0], bf[nd][2]);
      split(bp[kLd], bf[nd][1], bf[nd][3]);
    }
    mma3(part, ahi, alo, bf);
  }
#pragma unroll
  for (int nd = 0; nd < 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] += part[nd][e];
  }
}

// rows rb + g and rb + g + 8 (< n_rows) of a 16 x 64 accumulator to the
// row-major [n_rows, d] matrix o
__device__ __forceinline__ void store_rows(const float acc[8][4], int rb,
                                           int n_rows, int d,
                                           float* __restrict__ o) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rb + g + 8 * h;
    if (r >= n_rows) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * t + e;
        if (c < d) o[static_cast<size_t>(r) * d + c] = acc[nt][2 * h + e];
      }
    }
  }
}

// B9, dq: one block per (batch*head, 64-row q tile), the heaviest first,
// walking the key tiles up to the diagonal; warp w owns rows 16w..16w+15.
// S = Q K^T and dP = dO V^T from the staged tiles, ds = p (dp - delta)
// scale in registers, dQ += dS K with dS as it lies in the accumulators.
__global__ void __launch_bounds__(kBwdThreads, 2)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int Tq, int Tk, int d, int causal,
          float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = smem + kTileF;
  float* sKV = smem + 2 * kTileF;  // stage i: K at sKV + 2 i kTileF, then V
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float* kb = k + bh * Tk * d;
  const float* vb = v + bh * Tk * d;
  const int n_kt = key_tiles(q0, Tk, causal);
  if (n_kt > 0) {
    stage(q + bh * Tq * d, q0, Tq, d, vec, sQ);
    stage(dout + bh * Tq * d, q0, Tq, d, vec, sdO);
    stage(kb, 0, Tk, d, vec, sKV);
    stage(vb, 0, Tk, d, vec, sKV + kTileF);
  }
  cp_commit();
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_r[h] = rows[h] < Tq ? lse[bh * Tq + rows[h]] : 0.f;
    delta_r[h] = rows[h] < Tq ? delta[bh * Tq + rows[h]] : 0.f;
  }
  float acc[8][4] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_wait<0>();
    __syncthreads();  // tile kt landed; every thread is done with kt - 1
    if (kt + 1 < n_kt) {
      float* nx = sKV + ((kt + 1) & 1) * 2 * kTileF;
      stage(kb, (kt + 1) * kTile, Tk, d, vec, nx);
      stage(vb, (kt + 1) * kTile, Tk, d, vec, nx + kTileF);
    }
    cp_commit();
    const float* sK = sKV + (kt & 1) * 2 * kTileF;
    const float* sV = sK + kTileF;
    float s[8][4] = {};
    float dp[8][4] = {};
    prod_rows(sQ, sK, warp * 16, s);
    prod_rows(sdO, sV, warp * 16, dp);
    const int k0 = kt * kTile;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int kp = k0 + nt * 8 + 2 * t + (e & 1);
        const float p = visible(rows[h], kp, Tq, Tk, causal)
                            ? expf(s[nt][e] * scale - lse_r[h]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_r[h]) * scale;  // ds
      }
    }
    prod_cols(s, sK, acc);
  }
  cp_wait<0>();
  store_rows(acc, q0 + warp * 16, Tq, d, dq + bh * Tq * d);
}

// B9, dk/dv: one block per (batch*head, 64-key tile), key tile 0 first,
// walking the q tiles from the diagonal to the end; warp w owns keys
// 16w..16w+15. S^T = K Q^T and dP^T = V dO^T from the staged tiles, so P^T
// and dS^T come out in accumulator layout for dV += P^T dO and dK +=
// dS^T Q; each q tile's lse and delta ride with it in shared memory.
__global__ void __launch_bounds__(kBwdThreads, 2)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tk,
           int d, int causal, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float sStat[2][2][kTile];  // per stage: lse, delta
  float* sK = smem;
  float* sV = smem + kTileF;
  float* sQO = smem + 2 * kTileF;  // stage i: Q at sQO + 2 i kTileF, then dO
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float* qb = q + bh * Tq * d;
  const float* dob = dout + bh * Tq * d;
  const int n_qt = (Tq + kTile - 1) / kTile;
  // q tiles that end before this key tile starts see none of it
  const int qt0 = causal ? static_cast<int>(blockIdx.y) : 0;
  const int sr = threadIdx.x & (kTile - 1);
  // this thread's statistic of q tile qt: lse (threads 0-63) or delta
  auto stat = [&](int qt) {
    const int qp = qt * kTile + sr;
    if (qp >= Tq) return 0.f;
    return threadIdx.x < kTile ? lse[bh * Tq + qp] : delta[bh * Tq + qp];
  };
  if (qt0 < n_qt) {
    stage(k + bh * Tk * d, k0, Tk, d, vec, sK);
    stage(v + bh * Tk * d, k0, Tk, d, vec, sV);
    stage(qb, qt0 * kTile, Tq, d, vec, sQO);
    stage(dob, qt0 * kTile, Tq, d, vec, sQO + kTileF);
    sStat[0][threadIdx.x / kTile][sr] = stat(qt0);
  }
  cp_commit();
  float dk_acc[8][4] = {};
  float dv_acc[8][4] = {};
  for (int qt = qt0; qt < n_qt; ++qt) {
    cp_wait<0>();
    __syncthreads();  // tile qt landed; every thread is done with qt - 1
    const int slot = (qt - qt0) & 1;
    float stat_nxt = 0.f;  // stored once this tile's products are done
    if (qt + 1 < n_qt) {
      float* nx = sQO + (slot ^ 1) * 2 * kTileF;
      stage(qb, (qt + 1) * kTile, Tq, d, vec, nx);
      stage(dob, (qt + 1) * kTile, Tq, d, vec, nx + kTileF);
      stat_nxt = stat(qt + 1);
    }
    cp_commit();
    const float* sQ = sQO + slot * 2 * kTileF;
    const float* sdO = sQ + kTileF;
    const float* lse_c = sStat[slot][0];
    const float* delta_c = sStat[slot][1];
    const int q0 = qt * kTile;
    float st[8][4] = {};   // s^T: [key][q row]
    float dpt[8][4] = {};  // dp^T
    prod_rows(sK, sQ, warp * 16, st);
    prod_rows(sV, sdO, warp * 16, dpt);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);  // q row in the tile
        const float p = visible(q0 + c, keys[e >> 1], Tq, Tk, causal)
                            ? expf(st[nt][e] * scale - lse_c[c]) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - delta_c[c]) * scale;  // ds^T
      }
    }
    prod_cols(st, sdO, dv_acc);
    prod_cols(dpt, sQ, dk_acc);
    if (qt + 1 < n_qt) sStat[slot ^ 1][threadIdx.x / kTile][sr] = stat_nxt;
  }
  cp_wait<0>();
  store_rows(dk_acc, k0 + warp * 16, Tk, d, dk + bh * Tk * d);
  store_rows(dv_acc, k0 + warp * 16, Tk, d, dv + bh * Tk * d);
}

}  // namespace tf32

// ------------------------------------ bfloat16: tensor cores (wgmma)
namespace tc {

using bf16 = __nv_bfloat16;
__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x (fp32, accumulator layout) as the register operand of wgmma_rs over
// its 64 columns (4 depth steps of 16), split into bf16 hi and lo halves
// so the product keeps ~16 bits of x's mantissa
__device__ __forceinline__ void split(const float x[8][4], uint32_t hi[4][4],
                                      uint32_t lo[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      // f: 0 = rows g, 1 = rows g + 8 of column tile 2kk; 2, 3 of 2kk + 1
      const float* src = x[2 * kk + (f >> 1)] + 2 * (f & 1);
      const __nv_bfloat162 h = __floats2bfloat162_rn(src[0], src[1]);
      hi[kk][f] = pack(h);
      lo[kk][f] = pack(__floats2bfloat162_rn(src[0] - __low2float(h),
                                             src[1] - __high2float(h)));
    }
  }
}

// write rows rb + g and rb + g + 8 of a 16 x 64 accumulator (times
// scale_lo / scale_hi) to the row-major [n_rows, d] bf16 matrix o
__device__ __forceinline__ void store_rows(const float acc[8][4], int rb,
                                           int n_rows, int d,
                                           float scale_lo, float scale_hi,
                                           bf16* __restrict__ o) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rb + g + 8 * half;
    if (r >= n_rows) continue;
    const float sc = half ? scale_hi : scale_lo;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * t;  // d % 8 == 0: c < d implies c + 1 < d
      if (c < d) {
        *reinterpret_cast<__nv_bfloat162*>(
            o + static_cast<size_t>(r) * d + c) =
            __floats2bfloat162_rn(acc[nt][2 * half] * sc,
                                  acc[nt][2 * half + 1] * sc);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- wgmma fed by a cp.async ring of swizzled tiles

constexpr int kFwdRows = 64;             // q rows a block: a warpgroup
constexpr int kWgThreads = 128;
constexpr int kStages = 2;               // tiles in flight
constexpr int kRowBytes = kMaxD * 2;     // a staged row: 8 pieces of 16 B
constexpr int kTileBytes = kTile * kRowBytes;
constexpr float kLog2e = 1.4426950408889634f;
// + 1024: the tiles are 1024-byte aligned, as the 128-byte swizzle needs
constexpr int kFwdSmem =
    kFwdRows * kRowBytes + kStages * 2 * kTileBytes + 1024;
// B9: two resident tiles (Q and dO, or K and V) + the ring
constexpr int kBwdSmem = 2 * kTileBytes + kStages * 2 * kTileBytes + 1024;
// __launch_bounds__' least blocks an SM, the register cap: dq fits in 122
// registers (4 blocks resident), dk/dv in 168 (3); a cap for 4 (dk/dv) or
// 5 (dq) spills and measured slower on an H100
constexpr int kDqBlocks = 3;
constexpr int kDkvBlocks = 3;

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: sbo the
// bytes between 8-row groups, lbo between 64-element slices of an MN-major
// operand (ignored for a K-major one)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | static_cast<uint64_t>(1)
                                                     << 62;
}
// the 32 fp32 accumulators of a 64 x 64 warpgroup tile: d[nt][e] of
// thread lane 4g + t in warp w is row 16w + g (+ 8 for e >= 2), column
// 8nt + 2t (+ 1 for odd e): mma.sync's layout, tile by tile
#define FA_D8(i)                                                      \
  "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3]),         \
      "+f"(d[i + 1][0]), "+f"(d[i + 1][1]), "+f"(d[i + 1][2]),        \
      "+f"(d[i + 1][3])
#define FA_REGS                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"
// d (+)= A * B, m64n64k16: A (64 x 16) and B (16 x 64) K-major bf16 in
// shared memory; acc 0 zeroes d first
__device__ __forceinline__ void wgmma_ss(float d[8][4], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_D8(0), FA_D8(2), FA_D8(4), FA_D8(6)
      : "l"(a), "l"(b), "r"(acc));
}
// d += A * B: A (64 x 16) bf16 in registers (the mma.sync A fragment of
// each warp's 16 rows), B (16 x 64) MN-major bf16 in shared memory
__device__ __forceinline__ void wgmma_rs(float d[8][4], const uint32_t a[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D8(0), FA_D8(2), FA_D8(4), FA_D8(6)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef FA_D8
#undef FA_REGS
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// cp.async's writes (generic proxy) before wgmma reads them (async proxy)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// 2^x, MUFU.EX2 (relative error ~2^-22; 0 for x below -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// 16-byte piece p of row r of a staged tile: the piece index XORed with
// the row's low 3 bits, wgmma's 128-byte swizzle (and 8 rows of one piece
// hit 8 distinct bank groups)
__device__ __forceinline__ uint32_t swz(uint32_t base, int r, int p) {
  return base + r * kRowBytes + ((p ^ (r & 7)) << 4);
}

// Stage rows [r0, r0 + NR) of the row-major [n_rows, d] bf16 matrix g into
// the swizzled tile at s by cp.async, zeros past n_rows and past d
template <int NR>
__device__ __forceinline__ void stage_async(const bf16* __restrict__ g,
                                            int r0, int n_rows, int d,
                                            uint32_t s) {
#pragma unroll
  for (int i = threadIdx.x; i < NR * 8; i += kWgThreads) {
    const int r = i >> 3;
    const int p = i & 7;
    const bool ok = r0 + r < n_rows && p * 8 < d;
    cp16(swz(s, r, p), ok ? g + static_cast<size_t>(r0 + r) * d + p * 8 : g,
         ok);
  }
}

// B8: one warpgroup a block, per (batch*head, 64-row q tile), heaviest q
// tiles first under the causal mask; warp w owns rows 16w..16w+15, a
// thread rows g and g + 8. Per key tile the warpgroup runs S = Q K^T (4 wgmma, both operands from shared memory),
// the online softmax on S in registers, then O += P V (8 wgmma: P's bf16
// hi and lo halves as the register operand). Every exponential is one ex2
// of an FFMA: with kPos (a positive scale) the row max is taken on the
// raw scores s and p = 2^(s * scale log2 e - m * scale log2 e); otherwise
// on s * scale log2 e.
template <bool kPos>
__global__ void __launch_bounds__(kWgThreads, 5)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ out,
           float* __restrict__ lse, int Tq, int Tk, int d, int causal,
           float scale) {
  extern __shared__ __align__(128) unsigned char fsmem[];
  const uint32_t sQ = (smem_u32(fsmem) + 1023) & ~1023u;
  const uint32_t sKV = sQ + kFwdRows * kRowBytes;  // stage i: K, then V
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const bf16* kb = k + bh * Tk * d;
  const bf16* vb = v + bh * Tk * d;
  const int n_kt = Tk == 0 ? 0 : causal
      ? min((Tk + kTile - 1) / kTile, (q0 + kFwdRows - 1) / kTile + 1)
      : (Tk + kTile - 1) / kTile;
  const float sl2 = scale * kLog2e;
  const float mul = kPos ? 1.f : sl2;   // the max is taken on s * mul
  const float emul = kPos ? sl2 : 1.f;  // p = 2^((s * mul - m) * emul)

  // the ring's first tiles; q rides in the first group
  if (n_kt > 0) stage_async<kFwdRows>(q + bh * Tq * d, q0, Tq, d, sQ);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_kt) {
      const uint32_t st = sKV + i * 2 * kTileBytes;
      stage_async<kTile>(kb, i * kTile, Tk, d, st);
      stage_async<kTile>(vb, i * kTile, Tk, d, st + kTileBytes);
    }
    cp_commit();
  }

  float m[2] = {kNegInf, kNegInf};  // row max of s * mul
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float o[8][4] = {};
  const bool live = q0 < Tq;        // (Tq = 0 has no block)
  for (int kt = 0; kt < n_kt; ++kt) {
    const int nxt = kt + kStages - 1;
    if (nxt < n_kt) {
      const uint32_t st = sKV + (nxt % kStages) * 2 * kTileBytes;
      stage_async<kTile>(kb, nxt * kTile, Tk, d, st);
      stage_async<kTile>(vb, nxt * kTile, Tk, d, st + kTileBytes);
    }
    cp_commit();
    cp_wait<kStages - 1>();
    fence_async();
    __syncthreads();
    const int k0 = kt * kTile;
    // a block whose rows all precede the tile sees none of it
    if (live && !(causal && k0 > q0 + kFwdRows - 1)) {
      const uint32_t sK = sKV + (kt % kStages) * 2 * kTileBytes;
      const uint32_t sV = sK + kTileBytes;
      float s[8][4];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss(s, desc(sQ + 32 * kk, 16, 1024),
                 desc(sK + 32 * kk, 16, 1024), kk);
      }
      wg_commit();
      wg_wait();
      // only the diagonal tiles and the ragged tail need the mask
      const bool edge = k0 + kTile > Tk || (causal && k0 + kTile - 1 > q0);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = kPos ? s[nt][e] : s[nt][e] * mul;
          if (edge) {
            const int kp = k0 + nt * 8 + 2 * t + (e & 1);
            if (kp >= Tk || (causal && kp > rows[e >> 1])) x = kNegInf;
          }
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float m_new[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_new[h] = fmaxf(m[h], quad_max(mx[h]));
        const float alpha = ex2((m[h] - m_new[h]) * emul);
        l[h] *= alpha;
        m[h] = m_new[h];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          o[nt][2 * h] *= alpha;
          o[nt][2 * h + 1] *= alpha;
        }
      }
      // a masked score is -1e30 below a finite row max: ex2 gives 0 (a
      // row with no visible key yet is one past Tq, and is never stored)
      const float mo[2] = {-m_new[0] * emul, -m_new[1] * emul};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = ex2(fmaf(s[nt][e], emul, mo[e >> 1]));
          l[e >> 1] += s[nt][e];
        }
      }
      // o += P V, P split into bf16 hi + lo halves (the fp32 product)
      uint32_t hi[4][4], lo[4][4];
      split(s, hi, lo);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bv = desc(sV + 2048 * kk, kTileBytes, 1024);
        wgmma_rs(o, hi[kk], bv);
        wgmma_rs(o, lo[kk], bv);
      }
      wg_commit();
      wg_wait();
    }
    __syncthreads();  // the stage is refilled kStages - 1 tiles later
  }
  cp_wait<0>();

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    const float safe_l = l[h] == 0.f ? 1.f : l[h];
    inv[h] = 1.f / safe_l;
    if (t == 0 && rows[h] < Tq) {
      // back from log2 units: lse = (m * emul + log2 l) * ln 2
      lse[bh * Tq + rows[h]] =
          l[h] == 0.f ? kNegInf
                      : fmaf(m[h], emul, log2f(safe_l)) * 0.6931471805599453f;
    }
  }
  // out = acc / l as acc * (1 / l): within an ulp of the division, under
  // the bf16 rounding that follows
  store_rows(o, q0 + warp * 16, Tq, d, inv[0], inv[1], out + bh * Tq * d);
}

// B9, dq: one warpgroup a block, per (batch*head, 64-row q tile), the
// heaviest q tiles first; warp w owns rows 16w..16w+15, a thread rows g and
// g + 8. Q and dO ride in the ring's first group and stay; per key tile
// the warpgroup runs S = Q K^T and dP = dO V^T (8 wgmma from shared
// memory), p = 2^(s scale log2 e - lse log2 e) and ds = p (dp - delta)
// scale in registers, then dQ += dS K (8 wgmma: dS's hi and lo halves as
// the register operand, K read MN-major as it lies).
__global__ void __launch_bounds__(kWgThreads, kDqBlocks)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int Tq, int Tk, int d, int causal,
          float scale) {
  extern __shared__ __align__(128) unsigned char fsmem[];
  const uint32_t sQ = (smem_u32(fsmem) + 1023) & ~1023u;
  const uint32_t sdO = sQ + kTileBytes;
  const uint32_t sKV = sdO + kTileBytes;  // stage i: K, then V
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const bf16* kb = k + bh * Tk * d;
  const bf16* vb = v + bh * Tk * d;
  const int n_kt = key_tiles(q0, Tk, causal);
  const float sl2 = scale * kLog2e;

  if (n_kt > 0) {
    stage_async<kTile>(q + bh * Tq * d, q0, Tq, d, sQ);
    stage_async<kTile>(dout + bh * Tq * d, q0, Tq, d, sdO);
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_kt) {
      const uint32_t st = sKV + i * 2 * kTileBytes;
      stage_async<kTile>(kb, i * kTile, Tk, d, st);
      stage_async<kTile>(vb, i * kTile, Tk, d, st + kTileBytes);
    }
    cp_commit();
  }
  float lse2[2], dlt[2];  // lse * log2 e, delta of rows g, g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = rows[h] < Tq ? lse[bh * Tq + rows[h]] * kLog2e : 0.f;
    dlt[h] = rows[h] < Tq ? delta[bh * Tq + rows[h]] : 0.f;
  }
  float acc[8][4] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    const int nxt = kt + kStages - 1;
    if (nxt < n_kt) {
      const uint32_t st = sKV + (nxt % kStages) * 2 * kTileBytes;
      stage_async<kTile>(kb, nxt * kTile, Tk, d, st);
      stage_async<kTile>(vb, nxt * kTile, Tk, d, st + kTileBytes);
    }
    cp_commit();
    cp_wait<kStages - 1>();
    fence_async();
    __syncthreads();
    const int k0 = kt * kTile;
    const uint32_t sK = sKV + (kt % kStages) * 2 * kTileBytes;
    const uint32_t sV = sK + kTileBytes;
    float s[8][4], dp[8][4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss(s, desc(sQ + 32 * kk, 16, 1024), desc(sK + 32 * kk, 16, 1024),
               kk);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss(dp, desc(sdO + 32 * kk, 16, 1024),
               desc(sV + 32 * kk, 16, 1024), kk);
    }
    wg_commit();
    wg_wait();
    // only the diagonal tiles and the ragged tail need the mask
    const bool edge = k0 + kTile > Tk || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = ex2(fmaf(s[nt][e], sl2, -lse2[h]));
        if (edge) {
          const int kp = k0 + nt * 8 + 2 * t + (e & 1);
          if (kp >= Tk || (causal && kp > rows[h])) p = 0.f;
        }
        s[nt][e] = p * (dp[nt][e] - dlt[h]) * scale;  // ds
      }
    }
    uint32_t hi[4][4], lo[4][4];
    split(s, hi, lo);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bk = desc(sK + 2048 * kk, kTileBytes, 1024);
      wgmma_rs(acc, hi[kk], bk);
      wgmma_rs(acc, lo[kk], bk);
    }
    wg_commit();
    wg_wait();
    __syncthreads();  // the stage is refilled kStages - 1 tiles later
  }
  cp_wait<0>();
  store_rows(acc, q0 + warp * 16, Tq, d, 1.f, 1.f, dq + bh * Tq * d);
}

// B9, dk/dv: one warpgroup a block, per (batch*head, 64-key tile), key
// tile 0 (the one every q tile sees) first; warp w owns keys 16w..16w+15.
// K and V ride in the ring's first group and stay; per q tile, from the
// diagonal on, the ring brings Q, dO and the tile's lse and delta, and
// the warpgroup runs S^T = K Q^T and dP^T = V dO^T (8 wgmma from shared
// memory), so p^T and ds^T come out in accumulator layout, then dV +=
// P^T dO and dK += dS^T Q (16 wgmma, hi and lo halves in registers, dO
// and Q read MN-major).
__global__ void __launch_bounds__(kWgThreads, kDkvBlocks)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk,
           int d, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char fsmem[];
  // per stage: lse * log2 e (threads 0-63 stage it) and delta (64-127)
  __shared__ float sStat[kStages][2][kTile];
  const uint32_t sK = (smem_u32(fsmem) + 1023) & ~1023u;
  const uint32_t sV = sK + kTileBytes;
  const uint32_t sQO = sV + kTileBytes;  // stage i: Q, then dO
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const bf16* qb = q + bh * Tq * d;
  const bf16* dob = dout + bh * Tq * d;
  // q tiles that end before this key tile starts see none of it
  const int qt0 = causal ? static_cast<int>(blockIdx.y) : 0;
  const int n = (Tq + kTile - 1) / kTile - qt0;  // q tiles to walk
  const float sl2 = scale * kLog2e;
  const int sr = threadIdx.x & (kTile - 1);
  // this thread's statistic of the block's i-th q tile
  auto stat = [&](int i) {
    const int qp = (qt0 + i) * kTile + sr;
    if (qp >= Tq) return 0.f;
    return threadIdx.x < kTile ? lse[bh * Tq + qp] * kLog2e
                               : delta[bh * Tq + qp];
  };

  if (n > 0) {
    stage_async<kTile>(k + bh * Tk * d, k0, Tk, d, sK);
    stage_async<kTile>(v + bh * Tk * d, k0, Tk, d, sV);
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) {
      const uint32_t st = sQO + i * 2 * kTileBytes;
      stage_async<kTile>(qb, (qt0 + i) * kTile, Tq, d, st);
      stage_async<kTile>(dob, (qt0 + i) * kTile, Tq, d, st + kTileBytes);
      sStat[i][threadIdx.x / kTile][sr] = stat(i);
    }
    cp_commit();
  }
  float dk_acc[8][4] = {};
  float dv_acc[8][4] = {};
  for (int j = 0; j < n; ++j) {
    const int nxt = j + kStages - 1;
    float stat_nxt = 0.f;  // stored once this tile's products are done
    if (nxt < n) {
      const uint32_t st = sQO + (nxt % kStages) * 2 * kTileBytes;
      stage_async<kTile>(qb, (qt0 + nxt) * kTile, Tq, d, st);
      stage_async<kTile>(dob, (qt0 + nxt) * kTile, Tq, d, st + kTileBytes);
      stat_nxt = stat(nxt);
    }
    cp_commit();
    cp_wait<kStages - 1>();
    fence_async();
    __syncthreads();
    const int q0 = (qt0 + j) * kTile;
    const uint32_t sQ = sQO + (j % kStages) * 2 * kTileBytes;
    const uint32_t sdO = sQ + kTileBytes;
    const float* lse2 = sStat[j % kStages][0];
    const float* dlt = sStat[j % kStages][1];
    float s[8][4], dp[8][4];  // s^T, dp^T: [key][q row]
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss(s, desc(sK + 32 * kk, 16, 1024), desc(sQ + 32 * kk, 16, 1024),
               kk);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss(dp, desc(sV + 32 * kk, 16, 1024),
               desc(sdO + 32 * kk, 16, 1024), kk);
    }
    wg_commit();
    wg_wait();
    const bool edge = q0 + kTile > Tq || k0 + kTile > Tk ||
                      (causal && q0 < k0 + kTile - 1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);  // q row in the tile
        float p = ex2(fmaf(s[nt][e], sl2, -lse2[c]));
        if (edge) {
          const int qp = q0 + c;
          const int kp = keys[e >> 1];
          if (qp >= Tq || kp >= Tk || (causal && kp > qp)) p = 0.f;
        }
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - dlt[c]) * scale;  // ds^T
      }
    }
    uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
    split(s, phi, plo);
    split(dp, dhi, dlo);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bo = desc(sdO + 2048 * kk, kTileBytes, 1024);
      wgmma_rs(dv_acc, phi[kk], bo);
      wgmma_rs(dv_acc, plo[kk], bo);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bq = desc(sQ + 2048 * kk, kTileBytes, 1024);
      wgmma_rs(dk_acc, dhi[kk], bq);
      wgmma_rs(dk_acc, dlo[kk], bq);
    }
    wg_commit();
    wg_wait();
    if (nxt < n) sStat[nxt % kStages][threadIdx.x / kTile][sr] = stat_nxt;
    __syncthreads();  // the stage is refilled kStages - 1 tiles later
  }
  cp_wait<0>();
  store_rows(dk_acc, k0 + warp * 16, Tk, d, 1.f, 1.f, dk + bh * Tk * d);
  store_rows(dv_acc, k0 + warp * 16, Tk, d, 1.f, 1.f, dv + bh * Tk * d);
}

}  // namespace tc

// Above 48 KB a kernel takes dynamic shared memory only after opting in;
// the attribute belongs to the current device, so it is set at every launch.
template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// lane 0: float32, any d <= 64; lane 1: bfloat16, d a multiple of 8
bool bad_sizes(int lane, int BH, int Tq, int Tk, int d, int n_tiles) {
  return lane < 0 || lane > 1 || BH < 0 || Tq < 0 || Tk < 0 || d < 1 ||
         d > kMaxD || (lane == 1 && d % 8 != 0) || n_tiles > 65535;
}

// the float32 backward stages by cp.async when every input's rows are
// whole 16-byte pieces, else by scalar loads
int vec_rows(int d, const void* q, const void* k, const void* v,
             const void* dout) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(dout);
  return d % 4 == 0 && bits % 16 == 0;
}

}  // namespace

// q [BH, Tq, d], k/v [BH, Tk, d] (lane 0: float32, 1: bfloat16), out like
// q, lse [BH, Tq] fp32.
extern "C" int flash_attention_fwd(int lane, const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int BH, int Tq, int Tk, int d, int causal,
                                   float scale, void* stream) {
  const int n_qt = (Tq + kTile - 1) / kTile;
  if (bad_sizes(lane, BH, Tq, Tk, d, n_qt)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (BH == 0 || Tq == 0) return 0;  // nothing to do
  const dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>(n_qt));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lane == 0) {
    const cudaError_t err = opt_in(simt::fwd_kernel, simt::kFwdSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    simt::fwd_kernel<<<grid, simt::kThreads, simt::kFwdSmem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, Tq, Tk,
        d, causal, scale);
  } else {
    auto* kernel = scale > 0.f ? tc::fwd_kernel<true> : tc::fwd_kernel<false>;
    const cudaError_t err = opt_in(kernel, tc::kFwdSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_bt = (Tq + tc::kFwdRows - 1) / tc::kFwdRows;
    kernel<<<dim3(static_cast<unsigned>(BH), static_cast<unsigned>(n_bt)),
             tc::kWgThreads, tc::kFwdSmem, st>>>(
        static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
        static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(out), lse,
        Tq, Tk, d, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// + dout like q, lse/delta [BH, Tq] fp32; dq like q.
extern "C" int flash_attention_dq(int lane, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dq, int BH, int Tq, int Tk, int d,
                                  int causal, float scale, void* stream) {
  const int n_qt = (Tq + kTile - 1) / kTile;
  if (bad_sizes(lane, BH, Tq, Tk, d, n_qt)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (BH == 0 || Tq == 0) return 0;
  const dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>(n_qt));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lane == 0) {
    const cudaError_t err = opt_in(tf32::dq_kernel, tf32::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tf32::dq_kernel<<<grid, tf32::kBwdThreads, tf32::kSmem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), Tq, Tk, d, causal, scale,
        vec_rows(d, q, k, v, dout));
  } else {
    const cudaError_t err = opt_in(tc::dq_kernel, tc::kBwdSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::dq_kernel<<<grid, tc::kWgThreads, tc::kBwdSmem, st>>>(
        static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
        static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(dout),
        lse, delta, static_cast<tc::bf16*>(dq), Tq, Tk, d, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// + dk like k, dv like v.
extern "C" int flash_attention_dkv(int lane, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, int BH, int Tq, int Tk,
                                   int d, int causal, float scale,
                                   void* stream) {
  const int n_kt = (Tk + kTile - 1) / kTile;
  if (bad_sizes(lane, BH, Tq, Tk, d, n_kt)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (BH == 0 || Tk == 0) return 0;
  const dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>(n_kt));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lane == 0) {
    const cudaError_t err = opt_in(tf32::dkv_kernel, tf32::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tf32::dkv_kernel<<<grid, tf32::kBwdThreads, tf32::kSmem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), Tq, Tk, d,
        causal, scale, vec_rows(d, q, k, v, dout));
  } else {
    const cudaError_t err = opt_in(tc::dkv_kernel, tc::kBwdSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::dkv_kernel<<<grid, tc::kWgThreads, tc::kBwdSmem, st>>>(
        static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
        static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(dout),
        lse, delta, static_cast<tc::bf16*>(dk), static_cast<tc::bf16*>(dv),
        Tq, Tk, d, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
