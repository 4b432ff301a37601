// Flash attention for Hopper (sm_90a): the forward (B8) and the two
// backward kernels, dq and dk/dv (B9), with a float32 lane on the tensor
// cores as 3xTF32 (mma.sync) and a bfloat16 lane on the tensor cores
// (wgmma), each instantiated for a head_dim capacity of 64 or 128.
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
// 25 MB of q/k/v/out (bf16), about 250 FLOP per byte: near the ridge on
// the bf16 tensor cores; in fp32, three tf32 products for each product
// (19 GFLOP at 495 TFLOP/s) against 50 MB, operations-bound. What every
// kernel shares:
//   - A block owns one (batch*head, 64-row tile). The forward and dq walk
//     the 64-key tiles of K/V; dk/dv walks the 64-row tiles of q/dO for its
//     own key tile. Nothing carries between blocks (the TPU grid's
//     sequential innermost axis becomes the loop inside the block), so
//     there are no atomics and no scratch in device memory, the [T, T]
//     scores never leave the chip, and the sum order is fixed by the
//     shapes alone: two launches are bit-equal.
//   - Under the causal mask a block skips every tile strictly above the
//     diagonal (the Pallas kernels' pl.when), so the work is about half;
//     the blocks with the most tiles launch first. The masks run only on
//     the diagonal and tail tiles.
//   - Tiles are staged in shared memory, zero-filled past Tq/Tk and past
//     d, so the ragged tail is masked in the kernel and nothing is padded
//     in device memory (the TPU wrapper's _pad_seq).
//   - head_dim: every kernel is instantiated for a capacity kD of 64 or
//     128 (d <= kD, zero-filled past d); the entry picks the smaller that
//     holds d. At kD = 128, dk/dv's two accumulators would not fit in the
//     registers beside S and dP, so its grid gains a third axis: z = 0
//     blocks give dV, z = 1 blocks dK, each walking the q tiles itself.
//
// The float32 lane (namespace tf32): 3xTF32 on the tensor cores. Every
// fp32 operand is split into tf32 hi + lo halves and each product is a_lo
// b_hi + a_hi b_lo + a_hi b_hi (mma.sync m16n8k8), fp32 to ~2^-21; no
// plain TF32 (it breaks fp32 parity: 1.3e-3-4.4e-3 against the backward's
// 1e-4 gate, PERF.md). 128 threads, warp w owning rows 16w..16w+15; tiles
// staged by cp.async, double-buffered, as they lie in device memory
// ([row][kD + 4], conflict-free fragment loads); P and dS stay in the
// accumulators and are the A fragment of the next product as they lie
// (its k-steps take the two columns a lane holds), so nothing is
// transposed.
//   - Forward (B8): Q loaded once, K/V tiles double-buffered; S = Q K^T,
//     the online softmax on S in registers (a row's max and sum over the
//     quad of lanes that holds it; each exponential one ex2 of the score
//     in log2 units, scale * log2 e folded in), O = O * alpha + P V, every
//     fp32 op on a row's path an explicit round-to-nearest intrinsic.
//   - dq and dk/dv (B9): S and dP from the staged tiles, ds = p (dp -
//     delta) scale in registers, dQ += dS K; dV += P^T dO, dK += dS^T Q.
//
// The bfloat16 lane (namespace tc): one warpgroup (128 threads) a block,
// warp w owning rows 16w..16w+15 of the 64-row tile. Tiles of 64 rows flow
// through a 2-stage cp.async ring (zeros past Tq/Tk by the src-size
// operand) in the 128-byte swizzle that wgmma reads, so an operand is read
// K-major or MN-major as it lies and nothing is transposed in staging. A
// staged row of 128 dims is two 128-byte swizzle atoms, kept as two
// 64-column halves of the tile: a product over d steps through both
// halves, a product whose N is d runs once per half. Every product is
// wgmma m64n64k16 with fp32 accumulators: a product over d takes both
// operands from shared memory (S = Q K^T, dP = dO V^T, and in dk/dv S^T =
// K Q^T, dP^T = V dO^T, so P^T and dS^T come out in accumulator layout); a
// product over the tile takes the fp32 P or dS from registers. The Pallas
// kernels multiply P and dS in fp32; rounding them to bf16 would add a
// 2^-9 relative error to every term, so each is split into bf16 hi + lo
// halves and multiplied twice (error ~2^-17): 1.5x the tensor work of a
// bf16-P forward, 2x that of a bf16-dS backward, by design. Every
// exponential is one ex2 of an FFMA (scale * log2 e folded in).
//   - Forward (B8): K/V tiles through the ring; S, the online softmax on S
//     in registers, O += P V (8 wgmma a half, P's hi and lo halves).
//     Measured on an H100 (PERF.md): one warpgroup a block with 2 stages
//     beat two (128 rows) and 3-4 stages, and five blocks an SM (96
//     registers, no spills) beat four (123).
//   - dq: Q and dO loaded once; K/V tiles through the ring; S and dP (8
//     wgmma from shared memory a half of d), p = 2^(s scale log2 e - lse
//     log2 e), ds = p (dp - delta) scale in registers, dQ += dS K (8 wgmma
//     a half, K read MN-major).
//   - dk/dv: K and V loaded once; Q/dO tiles and their lse and delta
//     through the ring, from the diagonal on; S^T and dP^T (8 wgmma a
//     half), dV += P^T dO and dK += dS^T Q (16 wgmma a half, dO and Q
//     MN-major).
//
// Left for later work: overlapping a warpgroup's elementwise work with its
// next tile's products (every kernel waits on each wgmma group in turn);
// the fp32 lane on wgmma's tf32 mode, which reads fp32 operands K-major
// from shared memory only, so V (and K, dO, Q where they are B of a
// product over the tile) would have to be transposed in staging.
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; each C entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma_cp_async.cuh"

namespace {

constexpr int kTile = 64;            // q rows / keys per tile
constexpr int kMaxD = 128;           // head_dim capacity (zero-padded)
constexpr float kNegInf = -1e30f;    // finite stand-in for -inf
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// What a dk/dv block computes: both (kD 64), or one of them (kD 128,
// chosen by blockIdx.z): dK and dV together would hold 2 kD fp32 a thread
// beside S and dP
enum DkvOut { kBoth, kDvOnly, kDkOnly };

// 2^x, MUFU.EX2 (relative error ~2^-22; 0 for x below -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max / sum over the quad of lanes (4g .. 4g + 3) that holds a row of an
// mma accumulator
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------ float32: 3xTF32 on the tensor cores
namespace tf32 {

constexpr int kThreads = 128;           // 4 warps, 16 tile rows each

// The shapes of one head_dim capacity kD (64 or 128)
template <int kD>
struct Cfg {
  static constexpr int kLd = kD + 4;        // padded staged row, floats
  static constexpr int kTileF = kTile * kLd;  // floats of a staged tile
  static constexpr int kNT = kD / 8;        // 8-column tiles over d
  // bytes: the forward keeps Q and 2 stages of K and V; the backward two
  // resident tiles (Q and dO, or K and V) and 2 stages of the other two
  static constexpr int kFwdSmem = 5 * kTileF * 4;
  static constexpr int kBwdSmem = 6 * kTileF * 4;
  // blocks an SM that shared memory allows (kD 128: 169 / 203 KB of 227):
  // __launch_bounds__' least blocks, the register cap
  static constexpr int kBlocks = kD == 64 ? 2 : 1;
};

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
template <int kD>
__device__ __forceinline__ void stage(const float* __restrict__ g, int r0,
                                      int n_rows, int d, bool vec,
                                      float* __restrict__ s) {
  constexpr int kLd = Cfg<kD>::kLd;
  constexpr int kPieces = kD / 4;  // 16-byte pieces of a staged row
  constexpr int kLog2D = kD == 64 ? 6 : 7;
  if (vec) {
#pragma unroll
    for (int i = threadIdx.x; i < kTile * kPieces; i += kThreads) {
      const int r = i >> (kLog2D - 2);
      const int c4 = i & (kPieces - 1);
      const bool ok = r0 + r < n_rows && 4 * c4 < d;
      cp16(smem_u32(s + r * kLd + 4 * c4),
           ok ? g + static_cast<size_t>(r0 + r) * d + 4 * c4 : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
      const int r = i >> kLog2D;
      const int c = i & (kD - 1);
      s[r * kLd + c] = r0 + r < n_rows && c < d
                           ? g[static_cast<size_t>(r0 + r) * d + c] : 0.f;
    }
  }
}

// acc (16 x 64: 8 tiles of 8 columns) += A B^T over the kD columns of two
// staged tiles: rows rb..rb+15 of A against every row of B (a product over
// d, both operands read along their rows; the padding makes each fragment
// load conflict-free), its k-steps unrolled kUnroll at a time
template <int kD, int kUnroll = 2>
__device__ __forceinline__ void prod_rows(const float* __restrict__ A,
                                          const float* __restrict__ B,
                                          int rb, float acc[8][4]) {
  constexpr int kLd = Cfg<kD>::kLd;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const float* a = A + (rb + g) * kLd + t;
  const float* b = B + g * kLd + t;
#pragma unroll kUnroll
  for (int ks = 0; ks < kD / 8; ++ks) {
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

// acc (16 x kD over d) += X B over the 64 rows of the staged tile B, for
// an fp32 X (16 x 64) in accumulator layout: k-step ks takes columns
// 8ks + 2t (k index t) and 8ks + 2t + 1 (t + 4) of X, the two this lane
// holds, and the same rows of B, so X is the A fragment as it lies. Each
// 64 columns of d run as one round; a round's product over the tile is
// summed in a fresh accumulator and added to acc with fp32 adds that round
// to nearest: the tensor core's own adds truncate, and acc runs over every
// tile of a row.
template <int kD>
__device__ __forceinline__ void prod_cols(const float x[8][4],
                                          const float* __restrict__ B,
                                          float acc[][4]) {
  constexpr int kLd = Cfg<kD>::kLd;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int rd = 0; rd < kD / 64; ++rd) {
    const float* b = B + 2 * t * kLd + g + 64 * rd;
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
      for (int e = 0; e < 4; ++e) acc[8 * rd + nd][e] += part[nd][e];
    }
  }
}

// rows rb + g and rb + g + 8 (< n_rows) of a 16 x kD accumulator to the
// row-major [n_rows, d] matrix o
template <int kD>
__device__ __forceinline__ void store_rows(const float acc[][4], int rb,
                                           int n_rows, int d,
                                           float* __restrict__ o) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rb + g + 8 * h;
    if (r >= n_rows) continue;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * t + e;
        if (c < d) o[static_cast<size_t>(r) * d + c] = acc[nt][2 * h + e];
      }
    }
  }
}

// B8: one block per (batch*head, 64-row q tile), the heaviest first,
// walking the key tiles up to the diagonal; warp w owns rows 16w..16w+15,
// a lane rows g and g + 8. Per key tile: S = Q K^T from the staged tiles
// (its k-steps unrolled whole: faster on an H100 than two at a time,
// flash_probe's fwd_unroll2, PERF.md); x = s * scale * log2 e (-1e30 where masked), the rows'
// max over the quad, alpha = 2^(m_old - m_new), p = 2^(x - m_new); O = O
// * alpha + P V with P as it lies in the accumulators. A lane keeps its share of each
// row's sum, rescaled with O and summed over the quad at the end. Every
// row sees key 0 in the first tile (top-left causal), so m is finite from
// there on and a masked score gives p = 0 (a row past Tq is never stored).
template <int kD>
__global__ void __launch_bounds__(kThreads, Cfg<kD>::kBlocks)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out,
           float* __restrict__ lse, int Tq, int Tk, int d, int causal,
           float scale, int vec) {
  using C = Cfg<kD>;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sKV = smem + C::kTileF;  // stage i: K at sKV + 2 i kTileF, then V
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int rb = q0 + warp * 16;  // this warp's first row
  const int rows[2] = {rb + g, rb + g + 8};
  const float* kb = k + bh * Tk * d;
  const float* vb = v + bh * Tk * d;
  const int n_kt = key_tiles(q0, Tk, causal);
  if (n_kt > 0) {
    stage<kD>(q + bh * Tq * d, q0, Tq, d, vec, sQ);
    stage<kD>(kb, 0, Tk, d, vec, sKV);
    stage<kD>(vb, 0, Tk, d, vec, sKV + C::kTileF);
  }
  cp_commit();
  const float sl2 = __fmul_rn(scale, kLog2e);
  float m[2] = {kNegInf, kNegInf};  // row max of x
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums
  float o[C::kNT][4] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_wait<0>();
    __syncthreads();  // tile kt landed; every thread is done with kt - 1
    if (kt + 1 < n_kt) {
      float* nx = sKV + ((kt + 1) & 1) * 2 * C::kTileF;
      stage<kD>(kb, (kt + 1) * kTile, Tk, d, vec, nx);
      stage<kD>(vb, (kt + 1) * kTile, Tk, d, vec, nx + C::kTileF);
    }
    cp_commit();
    const float* sK = sKV + (kt & 1) * 2 * C::kTileF;
    const float* sV = sK + C::kTileF;
    const int k0 = kt * kTile;
    float s[8][4] = {};
    prod_rows<kD, kD / 8>(sQ, sK, warp * 16, s);
    // only the ragged tail and the diagonal (a key past a row of the warp)
    // need the mask
    const bool edge = k0 + kTile > Tk || (causal && k0 + kTile - 1 > rb);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[nt][e], sl2);
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
      const float alpha = ex2(__fsub_rn(m[h], m_new[h]));  // 0 at first
      m[h] = m_new[h];
      l[h] = __fmul_rn(l[h], alpha);
#pragma unroll
      for (int nd = 0; nd < C::kNT; ++nd) {
        o[nd][2 * h] = __fmul_rn(o[nd][2 * h], alpha);
        o[nd][2 * h + 1] = __fmul_rn(o[nd][2 * h + 1], alpha);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(__fsub_rn(s[nt][e], m_new[e >> 1]));
        s[nt][e] = p;
        l[e >> 1] = __fadd_rn(l[e >> 1], p);
      }
    }
    prod_cols<kD>(s, sV, o);
  }
  cp_wait<0>();

  float* ob = out + bh * Tq * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = __fadd_rn(l[h], __shfl_xor_sync(0xffffffffu, l[h], 1));
    l[h] = __fadd_rn(l[h], __shfl_xor_sync(0xffffffffu, l[h], 2));
    const int r = rows[h];
    if (r >= Tq) continue;
    // the l == 0 rule (no key: Tk = 0): out 0, lse -1e30
    const float inv = l[h] == 0.f ? 0.f : __frcp_rn(l[h]);
    if (t == 0) {
      // back from log2 units: lse = (m + log2 l) ln 2
      lse[bh * Tq + r] = l[h] == 0.f
          ? kNegInf : __fmul_rn(__fadd_rn(m[h], log2f(l[h])), kLn2);
    }
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * t + e;
        if (c < d) {
          ob[static_cast<size_t>(r) * d + c] = __fmul_rn(o[nt][2 * h + e],
                                                         inv);
        }
      }
    }
  }
}

// B9, dq: one block per (batch*head, 64-row q tile), the heaviest first,
// walking the key tiles up to the diagonal; warp w owns rows 16w..16w+15.
// S = Q K^T and dP = dO V^T from the staged tiles, ds = p (dp - delta)
// scale in registers, dQ += dS K with dS as it lies in the accumulators.
template <int kD>
__global__ void __launch_bounds__(kThreads, Cfg<kD>::kBlocks)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int Tq, int Tk, int d, int causal,
          float scale, int vec) {
  using C = Cfg<kD>;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = smem + C::kTileF;
  float* sKV = smem + 2 * C::kTileF;  // stage i: K at sKV + 2 i kTileF, V
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
    stage<kD>(q + bh * Tq * d, q0, Tq, d, vec, sQ);
    stage<kD>(dout + bh * Tq * d, q0, Tq, d, vec, sdO);
    stage<kD>(kb, 0, Tk, d, vec, sKV);
    stage<kD>(vb, 0, Tk, d, vec, sKV + C::kTileF);
  }
  cp_commit();
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_r[h] = rows[h] < Tq ? lse[bh * Tq + rows[h]] : 0.f;
    delta_r[h] = rows[h] < Tq ? delta[bh * Tq + rows[h]] : 0.f;
  }
  float acc[C::kNT][4] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_wait<0>();
    __syncthreads();  // tile kt landed; every thread is done with kt - 1
    if (kt + 1 < n_kt) {
      float* nx = sKV + ((kt + 1) & 1) * 2 * C::kTileF;
      stage<kD>(kb, (kt + 1) * kTile, Tk, d, vec, nx);
      stage<kD>(vb, (kt + 1) * kTile, Tk, d, vec, nx + C::kTileF);
    }
    cp_commit();
    const float* sK = sKV + (kt & 1) * 2 * C::kTileF;
    const float* sV = sK + C::kTileF;
    float s[8][4] = {};
    float dp[8][4] = {};
    prod_rows<kD>(sQ, sK, warp * 16, s);
    prod_rows<kD>(sdO, sV, warp * 16, dp);
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
    prod_cols<kD>(s, sK, acc);
  }
  cp_wait<0>();
  store_rows<kD>(acc, q0 + warp * 16, Tq, d, dq + bh * Tq * d);
}

// B9, dk/dv: one block per (batch*head, 64-key tile), key tile 0 first,
// walking the q tiles from the diagonal to the end; warp w owns keys
// 16w..16w+15. S^T = K Q^T and dP^T = V dO^T from the staged tiles, so P^T
// and dS^T come out in accumulator layout for dV += P^T dO and dK +=
// dS^T Q; each q tile's lse and delta ride with it in shared memory. A
// dV-only block needs neither V nor dP^T.
template <int kD, DkvOut kOut>
__device__ __forceinline__ void dkv_body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tk, int d,
    int causal, float scale, int vec, float* smem) {
  using C = Cfg<kD>;
  __shared__ float sStat[2][2][kTile];  // per stage: lse, delta
  constexpr bool kDv = kOut != kDkOnly;
  constexpr bool kDk = kOut != kDvOnly;
  float* sK = smem;
  float* sV = smem + C::kTileF;
  float* sQO = smem + 2 * C::kTileF;  // stage i: Q at sQO + 2 i kTileF, dO
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
    stage<kD>(k + bh * Tk * d, k0, Tk, d, vec, sK);
    if constexpr (kDk) stage<kD>(v + bh * Tk * d, k0, Tk, d, vec, sV);
    stage<kD>(qb, qt0 * kTile, Tq, d, vec, sQO);
    stage<kD>(dob, qt0 * kTile, Tq, d, vec, sQO + C::kTileF);
    sStat[0][threadIdx.x / kTile][sr] = stat(qt0);
  }
  cp_commit();
  float dk_acc[kDk ? C::kNT : 1][4] = {};
  float dv_acc[kDv ? C::kNT : 1][4] = {};
  for (int qt = qt0; qt < n_qt; ++qt) {
    cp_wait<0>();
    __syncthreads();  // tile qt landed; every thread is done with qt - 1
    const int slot = (qt - qt0) & 1;
    float stat_nxt = 0.f;  // stored once this tile's products are done
    if (qt + 1 < n_qt) {
      float* nx = sQO + (slot ^ 1) * 2 * C::kTileF;
      stage<kD>(qb, (qt + 1) * kTile, Tq, d, vec, nx);
      stage<kD>(dob, (qt + 1) * kTile, Tq, d, vec, nx + C::kTileF);
      stat_nxt = stat(qt + 1);
    }
    cp_commit();
    const float* sQ = sQO + slot * 2 * C::kTileF;
    const float* sdO = sQ + C::kTileF;
    const float* lse_c = sStat[slot][0];
    const float* delta_c = sStat[slot][1];
    const int q0 = qt * kTile;
    float st[8][4] = {};   // s^T: [key][q row]
    float dpt[8][4] = {};  // dp^T
    prod_rows<kD>(sK, sQ, warp * 16, st);
    if constexpr (kDk) prod_rows<kD>(sV, sdO, warp * 16, dpt);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);  // q row in the tile
        const float p = visible(q0 + c, keys[e >> 1], Tq, Tk, causal)
                            ? expf(st[nt][e] * scale - lse_c[c]) : 0.f;
        st[nt][e] = p;
        if constexpr (kDk) {
          dpt[nt][e] = p * (dpt[nt][e] - delta_c[c]) * scale;  // ds^T
        }
      }
    }
    if constexpr (kDv) prod_cols<kD>(st, sdO, dv_acc);
    if constexpr (kDk) prod_cols<kD>(dpt, sQ, dk_acc);
    if (qt + 1 < n_qt) sStat[slot ^ 1][threadIdx.x / kTile][sr] = stat_nxt;
  }
  cp_wait<0>();
  if constexpr (kDk) {
    store_rows<kD>(dk_acc, k0 + warp * 16, Tk, d, dk + bh * Tk * d);
  }
  if constexpr (kDv) {
    store_rows<kD>(dv_acc, k0 + warp * 16, Tk, d, dv + bh * Tk * d);
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, Cfg<kD>::kBlocks)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tk,
           int d, int causal, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (kD == 64) {
    dkv_body<kD, kBoth>(q, k, v, dout, lse, delta, dk, dv, Tq, Tk, d,
                        causal, scale, vec, smem);
  } else if (blockIdx.z == 0) {
    dkv_body<kD, kDvOnly>(q, k, v, dout, lse, delta, dk, dv, Tq, Tk, d,
                          causal, scale, vec, smem);
  } else {
    dkv_body<kD, kDkOnly>(q, k, v, dout, lse, delta, dk, dv, Tq, Tk, d,
                          causal, scale, vec, smem);
  }
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
// scale_lo / scale_hi) to columns c0 .. c0 + 63 of the row-major
// [n_rows, d] bf16 matrix o
__device__ __forceinline__ void store_rows(const float acc[8][4], int rb,
                                           int n_rows, int d, int c0,
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
      const int c = c0 + nt * 8 + 2 * t;  // d % 8 == 0: c < d gives c + 1 < d
      if (c < d) {
        *reinterpret_cast<__nv_bfloat162*>(
            o + static_cast<size_t>(r) * d + c) =
            __floats2bfloat162_rn(acc[nt][2 * half] * sc,
                                  acc[nt][2 * half + 1] * sc);
      }
    }
  }
}

// ---- wgmma fed by a cp.async ring of swizzled tiles

constexpr int kFwdRows = 64;             // q rows a block: a warpgroup
constexpr int kWgThreads = 128;
constexpr int kStages = 2;               // tiles in flight
// A staged tile is kD / 64 column halves; a half holds 64 dims of every
// row, 128 bytes (8 pieces of 16 B) a row, one 128-byte swizzle atom
constexpr int kRowBytes = 128;
constexpr int kHalf = kTile * kRowBytes;  // bytes of a tile's half

// The shapes of one head_dim capacity kD (64 or 128)
template <int kD>
struct Cfg {
  static constexpr int kHalves = kD / 64;
  static constexpr int kTileBytes = kHalves * kHalf;
  // + 1024: the tiles are 1024-byte aligned, as the 128-byte swizzle needs
  static constexpr int kFwdSmem =
      kFwdRows / kTile * kTileBytes + kStages * 2 * kTileBytes + 1024;
  // B9: two resident tiles (Q and dO, or K and V) + the ring
  static constexpr int kBwdSmem =
      2 * kTileBytes + kStages * 2 * kTileBytes + 1024;
  // __launch_bounds__' least blocks an SM, the register cap. kD 64: the
  // forward fits in 96 registers (5 blocks), dq in 122 (4 resident), dk/dv
  // in 168 (3); a cap for 4 (dk/dv) or 5 (dq) spills and measured slower
  // on an H100. kD 128: shared memory holds two blocks of each kernel
  static constexpr int kFwdBlocks = kD == 64 ? 5 : 2;
  static constexpr int kDqBlocks = kD == 64 ? 3 : 2;
  static constexpr int kDkvBlocks = kD == 64 ? 3 : 2;
};

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: sbo the
// bytes between 8-row groups, lbo between 64-element slices of an MN-major
// operand (ignored for a K-major one, and for the 64-wide N of every
// product here)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | static_cast<uint64_t>(1)
                                                     << 62;
}
// the K-major descriptor of depth step kk (16 dims) of a staged tile: half
// kk / 4, 32 bytes a step within it
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * kHalf + 32 * (kk & 3), 16, 1024);
}
// the MN-major descriptor of key step kk (16 rows) of half h of a staged
// tile, read with N = the half's 64 dims
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int h, int kk) {
  return desc(tile + h * kHalf + 2048 * kk, kHalf, 1024);
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
// 16-byte piece p of row r of a staged half: the piece index XORed with
// the row's low 3 bits, wgmma's 128-byte swizzle (and 8 rows of one piece
// hit 8 distinct bank groups)
__device__ __forceinline__ uint32_t swz(uint32_t base, int r, int p) {
  return base + r * kRowBytes + ((p ^ (r & 7)) << 4);
}

// Stage rows [r0, r0 + NR) of the row-major [n_rows, d] bf16 matrix g into
// the swizzled tile at s by cp.async (16-byte piece p of a row into half
// p / 8), zeros past n_rows and past d
template <int NR, int kD>
__device__ __forceinline__ void stage_async(const bf16* __restrict__ g,
                                            int r0, int n_rows, int d,
                                            uint32_t s) {
  constexpr int kPieces = kD / 8;
  constexpr int kShift = kD == 64 ? 3 : 4;  // log2 kPieces
#pragma unroll
  for (int i = threadIdx.x; i < NR * kPieces; i += kWgThreads) {
    const int r = i >> kShift;
    const int p = i & (kPieces - 1);
    const bool ok = r0 + r < n_rows && p * 8 < d;
    cp16(swz(s + (p >> 3) * NR * kRowBytes, r, p & 7),
         ok ? g + static_cast<size_t>(r0 + r) * d + p * 8 : g, ok);
  }
}

// B8: one warpgroup a block, per (batch*head, 64-row q tile), heaviest q
// tiles first under the causal mask; warp w owns rows 16w..16w+15, a
// thread rows g and g + 8. Per key tile the warpgroup runs S = Q K^T
// (kD / 16 wgmma, both operands from shared memory), the online softmax
// on S in registers, then O += P V (8 wgmma a half of d: P's bf16 hi and
// lo halves as the register operand). Every exponential is one ex2 of an
// FFMA: with kPos (a positive scale) the row max is taken on the raw
// scores s and p = 2^(s * scale log2 e - m * scale log2 e); otherwise on
// s * scale log2 e.
template <bool kPos, int kD>
__global__ void __launch_bounds__(kWgThreads, Cfg<kD>::kFwdBlocks)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ out,
           float* __restrict__ lse, int Tq, int Tk, int d, int causal,
           float scale) {
  using C = Cfg<kD>;
  constexpr int kH = C::kHalves;
  extern __shared__ __align__(128) unsigned char fsmem[];
  const uint32_t sQ = (smem_u32(fsmem) + 1023) & ~1023u;
  const uint32_t sKV = sQ + C::kTileBytes;  // stage i: K, then V
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
  if (n_kt > 0) stage_async<kFwdRows, kD>(q + bh * Tq * d, q0, Tq, d, sQ);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_kt) {
      const uint32_t st = sKV + i * 2 * C::kTileBytes;
      stage_async<kTile, kD>(kb, i * kTile, Tk, d, st);
      stage_async<kTile, kD>(vb, i * kTile, Tk, d, st + C::kTileBytes);
    }
    cp_commit();
  }

  float m[2] = {kNegInf, kNegInf};  // row max of s * mul
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float o[kH][8][4] = {};
  const bool live = q0 < Tq;        // (Tq = 0 has no block)
  for (int kt = 0; kt < n_kt; ++kt) {
    const int nxt = kt + kStages - 1;
    if (nxt < n_kt) {
      const uint32_t st = sKV + (nxt % kStages) * 2 * C::kTileBytes;
      stage_async<kTile, kD>(kb, nxt * kTile, Tk, d, st);
      stage_async<kTile, kD>(vb, nxt * kTile, Tk, d, st + C::kTileBytes);
    }
    cp_commit();
    cp_wait<kStages - 1>();
    fence_async();
    __syncthreads();
    const int k0 = kt * kTile;
    // a block whose rows all precede the tile sees none of it
    if (live && !(causal && k0 > q0 + kFwdRows - 1)) {
      const uint32_t sK = sKV + (kt % kStages) * 2 * C::kTileBytes;
      const uint32_t sV = sK + C::kTileBytes;
      float s[8][4];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss(s, desc_k(sQ, kk), desc_k(sK, kk), kk);
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
        for (int c = 0; c < kH; ++c) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            o[c][nt][2 * h] *= alpha;
            o[c][nt][2 * h + 1] *= alpha;
          }
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
      for (int c = 0; c < kH; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t bv = desc_mn(sV, c, kk);
          wgmma_rs(o[c], hi[kk], bv);
          wgmma_rs(o[c], lo[kk], bv);
        }
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
          l[h] == 0.f ? kNegInf : fmaf(m[h], emul, log2f(safe_l)) * kLn2;
    }
  }
  // out = acc / l as acc * (1 / l): within an ulp of the division, under
  // the bf16 rounding that follows
#pragma unroll
  for (int c = 0; c < kH; ++c) {
    store_rows(o[c], q0 + warp * 16, Tq, d, 64 * c, inv[0], inv[1],
               out + bh * Tq * d);
  }
}

// B9, dq: one warpgroup a block, per (batch*head, 64-row q tile), the
// heaviest q tiles first; warp w owns rows 16w..16w+15, a thread rows g and
// g + 8. Q and dO ride in the ring's first group and stay; per key tile
// the warpgroup runs S = Q K^T and dP = dO V^T (kD / 8 wgmma from shared
// memory), p = 2^(s scale log2 e - lse log2 e) and ds = p (dp - delta)
// scale in registers, then dQ += dS K (8 wgmma a half of d: dS's hi and lo
// halves as the register operand, K read MN-major as it lies).
template <int kD>
__global__ void __launch_bounds__(kWgThreads, Cfg<kD>::kDqBlocks)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int Tq, int Tk, int d, int causal,
          float scale) {
  using C = Cfg<kD>;
  constexpr int kH = C::kHalves;
  extern __shared__ __align__(128) unsigned char fsmem[];
  const uint32_t sQ = (smem_u32(fsmem) + 1023) & ~1023u;
  const uint32_t sdO = sQ + C::kTileBytes;
  const uint32_t sKV = sdO + C::kTileBytes;  // stage i: K, then V
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
    stage_async<kTile, kD>(q + bh * Tq * d, q0, Tq, d, sQ);
    stage_async<kTile, kD>(dout + bh * Tq * d, q0, Tq, d, sdO);
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_kt) {
      const uint32_t st = sKV + i * 2 * C::kTileBytes;
      stage_async<kTile, kD>(kb, i * kTile, Tk, d, st);
      stage_async<kTile, kD>(vb, i * kTile, Tk, d, st + C::kTileBytes);
    }
    cp_commit();
  }
  float lse2[2], dlt[2];  // lse * log2 e, delta of rows g, g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = rows[h] < Tq ? lse[bh * Tq + rows[h]] * kLog2e : 0.f;
    dlt[h] = rows[h] < Tq ? delta[bh * Tq + rows[h]] : 0.f;
  }
  float acc[kH][8][4] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    const int nxt = kt + kStages - 1;
    if (nxt < n_kt) {
      const uint32_t st = sKV + (nxt % kStages) * 2 * C::kTileBytes;
      stage_async<kTile, kD>(kb, nxt * kTile, Tk, d, st);
      stage_async<kTile, kD>(vb, nxt * kTile, Tk, d, st + C::kTileBytes);
    }
    cp_commit();
    cp_wait<kStages - 1>();
    fence_async();
    __syncthreads();
    const int k0 = kt * kTile;
    const uint32_t sK = sKV + (kt % kStages) * 2 * C::kTileBytes;
    const uint32_t sV = sK + C::kTileBytes;
    float s[8][4], dp[8][4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss(s, desc_k(sQ, kk), desc_k(sK, kk), kk);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss(dp, desc_k(sdO, kk), desc_k(sV, kk), kk);
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
    for (int c = 0; c < kH; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bk = desc_mn(sK, c, kk);
        wgmma_rs(acc[c], hi[kk], bk);
        wgmma_rs(acc[c], lo[kk], bk);
      }
    }
    wg_commit();
    wg_wait();
    __syncthreads();  // the stage is refilled kStages - 1 tiles later
  }
  cp_wait<0>();
#pragma unroll
  for (int c = 0; c < kH; ++c) {
    store_rows(acc[c], q0 + warp * 16, Tq, d, 64 * c, 1.f, 1.f,
               dq + bh * Tq * d);
  }
}

// B9, dk/dv: one warpgroup a block, per (batch*head, 64-key tile), key
// tile 0 (the one every q tile sees) first; warp w owns keys 16w..16w+15.
// K and V ride in the ring's first group and stay; per q tile, from the
// diagonal on, the ring brings Q, dO and the tile's lse and delta, and
// the warpgroup runs S^T = K
// Q^T and dP^T = V dO^T (kD / 8 wgmma from shared memory), so p^T and ds^T
// come out in accumulator layout, then dV += P^T dO and dK += dS^T Q (8
// wgmma each a half of d, hi and lo halves in registers, dO and Q read
// MN-major). A dV-only block needs neither V nor dP^T.
template <int kD, DkvOut kOut>
__device__ __forceinline__ void dkv_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk, int d,
    int causal, float scale, uint32_t sK) {
  using C = Cfg<kD>;
  // per stage: lse * log2 e (threads 0-63 stage it) and delta (64-127)
  __shared__ float sStat[kStages][2][kTile];
  constexpr int kH = C::kHalves;
  constexpr bool kDv = kOut != kDkOnly;
  constexpr bool kDk = kOut != kDvOnly;
  const uint32_t sV = sK + C::kTileBytes;
  const uint32_t sQO = sV + C::kTileBytes;  // stage i: Q, then dO
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
    stage_async<kTile, kD>(k + bh * Tk * d, k0, Tk, d, sK);
    if constexpr (kDk) stage_async<kTile, kD>(v + bh * Tk * d, k0, Tk, d, sV);
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) {
      const uint32_t st = sQO + i * 2 * C::kTileBytes;
      stage_async<kTile, kD>(qb, (qt0 + i) * kTile, Tq, d, st);
      stage_async<kTile, kD>(dob, (qt0 + i) * kTile, Tq, d,
                             st + C::kTileBytes);
      sStat[i][threadIdx.x / kTile][sr] = stat(i);
    }
    cp_commit();
  }
  float dk_acc[kDk ? kH : 1][8][4] = {};
  float dv_acc[kDv ? kH : 1][8][4] = {};
  for (int j = 0; j < n; ++j) {
    const int nxt = j + kStages - 1;
    float stat_nxt = 0.f;  // stored once this tile's products are done
    if (nxt < n) {
      const uint32_t st = sQO + (nxt % kStages) * 2 * C::kTileBytes;
      stage_async<kTile, kD>(qb, (qt0 + nxt) * kTile, Tq, d, st);
      stage_async<kTile, kD>(dob, (qt0 + nxt) * kTile, Tq, d,
                             st + C::kTileBytes);
      stat_nxt = stat(nxt);
    }
    cp_commit();
    cp_wait<kStages - 1>();
    fence_async();
    __syncthreads();
    const int q0 = (qt0 + j) * kTile;
    const uint32_t sQ = sQO + (j % kStages) * 2 * C::kTileBytes;
    const uint32_t sdO = sQ + C::kTileBytes;
    const float* lse2 = sStat[j % kStages][0];
    const float* dlt = sStat[j % kStages][1];
    float s[8][4], dp[8][4];  // s^T, dp^T: [key][q row]
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss(s, desc_k(sK, kk), desc_k(sQ, kk), kk);
    }
    if constexpr (kDk) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss(dp, desc_k(sV, kk), desc_k(sdO, kk), kk);
      }
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
        if constexpr (kDk) {
          dp[nt][e] = p * (dp[nt][e] - dlt[c]) * scale;  // ds^T
        }
      }
    }
    uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
    if constexpr (kDv) split(s, phi, plo);
    if constexpr (kDk) split(dp, dhi, dlo);
    wg_fence();
    if constexpr (kDv) {
#pragma unroll
      for (int c = 0; c < kH; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t bo = desc_mn(sdO, c, kk);
          wgmma_rs(dv_acc[c], phi[kk], bo);
          wgmma_rs(dv_acc[c], plo[kk], bo);
        }
      }
    }
    if constexpr (kDk) {
#pragma unroll
      for (int c = 0; c < kH; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t bq = desc_mn(sQ, c, kk);
          wgmma_rs(dk_acc[c], dhi[kk], bq);
          wgmma_rs(dk_acc[c], dlo[kk], bq);
        }
      }
    }
    wg_commit();
    wg_wait();
    if (nxt < n) sStat[nxt % kStages][threadIdx.x / kTile][sr] = stat_nxt;
    __syncthreads();  // the stage is refilled kStages - 1 tiles later
  }
  cp_wait<0>();
#pragma unroll
  for (int c = 0; c < kH; ++c) {
    if constexpr (kDk) {
      store_rows(dk_acc[c], k0 + warp * 16, Tk, d, 64 * c, 1.f, 1.f,
                 dk + bh * Tk * d);
    }
  }
#pragma unroll
  for (int c = 0; c < kH; ++c) {
    if constexpr (kDv) {
      store_rows(dv_acc[c], k0 + warp * 16, Tk, d, 64 * c, 1.f, 1.f,
                 dv + bh * Tk * d);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kWgThreads, Cfg<kD>::kDkvBlocks)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk,
           int d, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char fsmem[];
  const uint32_t sK = (smem_u32(fsmem) + 1023) & ~1023u;
  if constexpr (kD == 64) {
    dkv_body<kD, kBoth>(q, k, v, dout, lse, delta, dk, dv, Tq, Tk, d,
                        causal, scale, sK);
  } else if (blockIdx.z == 0) {
    dkv_body<kD, kDvOnly>(q, k, v, dout, lse, delta, dk, dv, Tq, Tk, d,
                          causal, scale, sK);
  } else {
    dkv_body<kD, kDkOnly>(q, k, v, dout, lse, delta, dk, dv, Tq, Tk, d,
                          causal, scale, sK);
  }
}

}  // namespace tc

// Above 48 KB a kernel takes dynamic shared memory only after opting in;
// the attribute belongs to the current device, so it is set at every launch.
template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// lane 0: float32, any d <= 128; lane 1: bfloat16, d a multiple of 8
bool bad_sizes(int lane, int BH, int Tq, int Tk, int d, int n_tiles) {
  return lane < 0 || lane > 1 || BH < 0 || Tq < 0 || Tk < 0 || d < 1 ||
         d > kMaxD || (lane == 1 && d % 8 != 0) || n_tiles > 65535;
}

// the float32 lane stages by cp.async when every input's rows are whole
// 16-byte pieces, else by scalar loads
int vec_rows(int d, const void* q, const void* k, const void* v,
             const void* dout) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(dout);
  return d % 4 == 0 && bits % 16 == 0;
}

// The launches of one head_dim capacity kD
template <int kD>
cudaError_t fwd_launch(int lane, const void* q, const void* k, const void* v,
                       void* out, float* lse, int BH, int Tq, int Tk, int d,
                       int causal, float scale, cudaStream_t st) {
  const int n_qt = (Tq + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>(n_qt));
  if (lane == 0) {
    auto* kernel = tf32::fwd_kernel<kD>;
    constexpr int smem = tf32::Cfg<kD>::kFwdSmem;
    const cudaError_t err = opt_in(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, tf32::kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, Tq, Tk,
        d, causal, scale, vec_rows(d, q, k, v, q));
  } else {
    auto* kernel = scale > 0.f ? tc::fwd_kernel<true, kD>
                               : tc::fwd_kernel<false, kD>;
    constexpr int smem = tc::Cfg<kD>::kFwdSmem;
    const cudaError_t err = opt_in(kernel, smem);
    if (err != cudaSuccess) return err;
    const int n_bt = (Tq + tc::kFwdRows - 1) / tc::kFwdRows;
    kernel<<<dim3(static_cast<unsigned>(BH), static_cast<unsigned>(n_bt)),
             tc::kWgThreads, smem, st>>>(
        static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
        static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(out), lse,
        Tq, Tk, d, causal, scale);
  }
  return cudaGetLastError();
}

template <int kD>
cudaError_t dq_launch(int lane, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int BH, int Tq, int Tk, int d, int causal,
                      float scale, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(BH),
                  static_cast<unsigned>((Tq + kTile - 1) / kTile));
  if (lane == 0) {
    auto* kernel = tf32::dq_kernel<kD>;
    constexpr int smem = tf32::Cfg<kD>::kBwdSmem;
    const cudaError_t err = opt_in(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, tf32::kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), Tq, Tk, d, causal, scale,
        vec_rows(d, q, k, v, dout));
  } else {
    auto* kernel = tc::dq_kernel<kD>;
    constexpr int smem = tc::Cfg<kD>::kBwdSmem;
    const cudaError_t err = opt_in(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, tc::kWgThreads, smem, st>>>(
        static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
        static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(dout),
        lse, delta, static_cast<tc::bf16*>(dq), Tq, Tk, d, causal, scale);
  }
  return cudaGetLastError();
}

template <int kD>
cudaError_t dkv_launch(int lane, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int BH,
                       int Tq, int Tk, int d, int causal, float scale,
                       cudaStream_t st) {
  // kD 128: z = 0 blocks give dV, z = 1 blocks dK
  const dim3 grid(static_cast<unsigned>(BH),
                  static_cast<unsigned>((Tk + kTile - 1) / kTile),
                  kD == 64 ? 1 : 2);
  if (lane == 0) {
    auto* kernel = tf32::dkv_kernel<kD>;
    constexpr int smem = tf32::Cfg<kD>::kBwdSmem;
    const cudaError_t err = opt_in(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, tf32::kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), Tq, Tk, d,
        causal, scale, vec_rows(d, q, k, v, dout));
  } else {
    auto* kernel = tc::dkv_kernel<kD>;
    constexpr int smem = tc::Cfg<kD>::kBwdSmem;
    const cudaError_t err = opt_in(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, tc::kWgThreads, smem, st>>>(
        static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
        static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(dout),
        lse, delta, static_cast<tc::bf16*>(dk), static_cast<tc::bf16*>(dv),
        Tq, Tk, d, causal, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q [BH, Tq, d], k/v [BH, Tk, d] (lane 0: float32, 1: bfloat16), out like
// q, lse [BH, Tq] fp32; d <= 128.
extern "C" int flash_attention_fwd(int lane, const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int BH, int Tq, int Tk, int d, int causal,
                                   float scale, void* stream) {
  if (bad_sizes(lane, BH, Tq, Tk, d, (Tq + kTile - 1) / kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (BH == 0 || Tq == 0) return 0;  // nothing to do
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      d <= 64 ? fwd_launch<64>(lane, q, k, v, out, lse, BH, Tq, Tk, d,
                               causal, scale, st)
              : fwd_launch<128>(lane, q, k, v, out, lse, BH, Tq, Tk, d,
                                causal, scale, st));
}

// + dout like q, lse/delta [BH, Tq] fp32; dq like q.
extern "C" int flash_attention_dq(int lane, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dq, int BH, int Tq, int Tk, int d,
                                  int causal, float scale, void* stream) {
  if (bad_sizes(lane, BH, Tq, Tk, d, (Tq + kTile - 1) / kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (BH == 0 || Tq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      d <= 64 ? dq_launch<64>(lane, q, k, v, dout, lse, delta, dq, BH, Tq,
                              Tk, d, causal, scale, st)
              : dq_launch<128>(lane, q, k, v, dout, lse, delta, dq, BH, Tq,
                               Tk, d, causal, scale, st));
}

// + dk like k, dv like v.
extern "C" int flash_attention_dkv(int lane, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, int BH, int Tq, int Tk,
                                   int d, int causal, float scale,
                                   void* stream) {
  if (bad_sizes(lane, BH, Tq, Tk, d, (Tk + kTile - 1) / kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (BH == 0 || Tk == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      d <= 64 ? dkv_launch<64>(lane, q, k, v, dout, lse, delta, dk, dv, BH,
                               Tq, Tk, d, causal, scale, st)
              : dkv_launch<128>(lane, q, k, v, dout, lse, delta, dk, dv, BH,
                                Tq, Tk, d, causal, scale, st));
}
