// Flash attention for Hopper (sm_90a): the forward (B8) and the two
// backward kernels, dq and dk/dv (B9), with a float32 lane on the CUDA
// cores and a bfloat16 lane on the tensor cores (mma.sync).
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
//     shapes alone.
//   - Under the causal mask a block skips every tile strictly above the
//     diagonal (the Pallas kernels' pl.when), so the work is about half.
//   - Tiles are staged in shared memory, zero-filled past Tq/Tk and past
//     d, so the ragged tail is masked in the kernel and nothing is padded
//     in device memory (the TPU wrapper's _pad_seq).
//
// The float32 lane (namespace simt): 256 threads (16 x 16), each a 4 x 4
// register tile; tiles staged as fp32 [depth][64 + 4], so the inner loop
// of every product reads one float4 of each operand per depth step for 16
// FMAs. The online softmax's row max and sum are half-warp shuffles; P (or
// dS) goes through shared memory, transposed, to the next product. No
// TF32: it would break fp32 parity.
//
// The bfloat16 lane (namespace tc): 128 threads, each warp 16 rows of the
// tile, every product a warp-level mma.sync.m16n8k16 (bf16 in, fp32
// accumulate). Tiles are staged as bf16 [64][64 + 8] (16-byte loads from
// device memory; the padding makes every fragment load conflict-free);
// an operand used as the mma's B with the key (or q) axis as its depth is
// staged transposed. Scores stay in the accumulator registers: the
// softmax's row statistics are quad shuffles, and the fp32 P (or dS) is
// re-packed in registers as the A operand of the next product. The Pallas
// kernels multiply P and dS in fp32; rounding them to bf16 would add a
// 2^-9 relative error to every term, so each is split into hi + lo bf16
// halves and multiplied twice (error ~2^-17, two mmas where one would do;
// the tensor cores are not the limit here).
//
// Left for later work: cp.async/TMA staging that overlaps the next tile's
// loads with this tile's math, ldmatrix for the fragments, wgmma.
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

// B9, dq: one block per (batch*head, 64-row q tile), walking the key tiles
// up to the diagonal: p = exp(s - lse), ds = p * (dp - delta) * scale,
// dq += ds @ k.
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int Tq, int Tk, int d, int causal,
          float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;              // [d][q row]
  float* sdOt = smem + kBuf;      // [d][q row]
  float* sKt = smem + 2 * kBuf;   // [d][key]
  float* sVt = smem + 3 * kBuf;   // [d][key]
  float* sK = smem + 4 * kBuf;    // [key][d]
  float* sdSt = smem + 5 * kBuf;  // [key][q row]
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const float* kb = k + bh * Tk * d;
  const float* vb = v + bh * Tk * d;
  stage<true>(q + bh * Tq * d, q0, Tq, d, sQt);
  stage<true>(dout + bh * Tq * d, q0, Tq, d, sdOt);
  float lse_r[4], delta_r[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    lse_r[i] = qp < Tq ? lse[bh * Tq + qp] : 0.f;
    delta_r[i] = qp < Tq ? delta[bh * Tq + qp] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const int n_kt = key_tiles(q0, Tk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    stage<true>(kb, k0, Tk, d, sKt);
    stage<false>(kb, k0, Tk, d, sK);
    stage<true>(vb, k0, Tk, d, sVt);
    __syncthreads();
    float s[4][4] = {};
    float dp[4][4] = {};
    tile_product(sQt, sKt, ty * 4, tx * 4, s);
    tile_product(sdOt, sVt, ty * 4, tx * 4, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(qp, k0 + tx * 4 + j, Tq, Tk, causal)
                            ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - delta_r[i]) * scale;  // ds
      }
    }
    put_transposed(sdSt, ty * 4, tx * 4, s);
    __syncthreads();
    tile_product(sdSt, sK, ty * 4, tx * 4, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Tq) continue;
    float* o = dq + (bh * Tq + qp) * d;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx * 4 + j;
      if (c < d) o[c] = acc[i][j];
    }
  }
}

// B9, dk/dv: one block per (batch*head, 64-key tile), walking the q tiles
// from the diagonal to the end: dv += p^T @ do, dk += ds^T @ q.
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tk,
           int d, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sKt = smem;              // [d][key]
  float* sVt = smem + kBuf;       // [d][key]
  float* sQt = smem + 2 * kBuf;   // [d][q row]
  float* sdOt = smem + 3 * kBuf;  // [d][q row]
  float* sQ = smem + 4 * kBuf;    // [q row][d]
  float* sdO = smem + 5 * kBuf;   // [q row][d]
  float* sP = smem + 6 * kBuf;    // [q row][key]: P, then dS
  const int tx = threadIdx.x & 15;  // q rows / dims tx*4 .. +3
  const int ty = threadIdx.x >> 4;  // keys ty*4 .. +3
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const float* qb = q + bh * Tq * d;
  const float* dob = dout + bh * Tq * d;
  stage<true>(k + bh * Tk * d, k0, Tk, d, sKt);
  stage<true>(v + bh * Tk * d, k0, Tk, d, sVt);
  float dk_acc[4][4] = {};
  float dv_acc[4][4] = {};
  const int n_qt = (Tq + kTile - 1) / kTile;
  // q tiles that end before this key tile starts see none of it
  for (int qt = causal ? static_cast<int>(blockIdx.y) : 0; qt < n_qt;
       ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    stage<true>(qb, q0, Tq, d, sQt);
    stage<true>(dob, q0, Tq, d, sdOt);
    stage<false>(qb, q0, Tq, d, sQ);
    stage<false>(dob, q0, Tq, d, sdO);
    __syncthreads();
    float lse_c[4], delta_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qp = q0 + tx * 4 + j;
      lse_c[j] = qp < Tq ? lse[bh * Tq + qp] : 0.f;
      delta_c[j] = qp < Tq ? delta[bh * Tq + qp] : 0.f;
    }
    float st[4][4] = {};   // s^T: [key][q row]
    float dpt[4][4] = {};  // dp^T
    tile_product(sKt, sQt, ty * 4, tx * 4, st);
    tile_product(sVt, sdOt, ty * 4, tx * 4, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(q0 + tx * 4 + j, kp, Tq, Tk, causal)
                            ? expf(st[i][j] * scale - lse_c[j]) : 0.f;
        st[i][j] = p;
        dpt[i][j] = p * (dpt[i][j] - delta_c[j]) * scale;  // ds^T
      }
    }
    put_transposed(sP, ty * 4, tx * 4, st);
    __syncthreads();
    tile_product(sP, sdO, ty * 4, tx * 4, dv_acc);
    __syncthreads();
    put_transposed(sP, ty * 4, tx * 4, dpt);
    __syncthreads();
    tile_product(sP, sQ, ty * 4, tx * 4, dk_acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= Tk) continue;
    float* ok = dk + (bh * Tk + kp) * d;
    float* ov = dv + (bh * Tk + kp) * d;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx * 4 + j;
      if (c < d) {
        ok[c] = dk_acc[i][j];
        ov[c] = dv_acc[i][j];
      }
    }
  }
}

constexpr int kFwdSmem = 4 * kBuf * 4;  // bytes
constexpr int kDqSmem = 6 * kBuf * 4;
constexpr int kDkvSmem = 7 * kBuf * 4;

}  // namespace simt

// --------------------------------------- bfloat16: tensor cores (mma.sync)
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;        // 4 warps, 16 tile rows each
constexpr int kLdh = kMaxD + 8;      // padded staged row, bf16 elements
constexpr int kLdw = kLdh / 2;       // the same in 32-bit words (36)
constexpr int kBuf = kTile * kLdh;   // bf16 elements per staged tile

// d[4] += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate.
// Fragments (lane = 4 * g + t): a0 = A[g][2t, 2t+1], a1 = A[g + 8][..],
// a2 = A[g][2t + 8, +9], a3 = A[g + 8][..]; b0 = B[2t, 2t+1][g],
// b1 = B[2t + 8, +9][g]; d0, d1 = D[g][2t, 2t+1], d2, d3 = D[g + 8][..].
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [r0, r0 + 64) of the row-major [n_rows, d] bf16 matrix g
// (d % 8 == 0, 16-byte aligned rows) into s[64][kLdh], zero past n_rows
// and past d; kTrans stores it transposed, s[c][r].
template <bool kTrans>
__device__ __forceinline__ void stage(const bf16* __restrict__ g, int r0,
                                      int n_rows, int d,
                                      bf16* __restrict__ s) {
  for (int idx = threadIdx.x; idx < kTile * kMaxD / 8; idx += kThreads) {
    // transposed: consecutive lanes on consecutive rows, so the 2-byte
    // stores of a warp land in distinct banks
    const int r = kTrans ? idx % kTile : idx / (kMaxD / 8);
    const int c = kTrans ? (idx / kTile) * 8 : (idx % (kMaxD / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows && c < d) {
      x = *reinterpret_cast<const uint4*>(
          g + static_cast<size_t>(r0 + r) * d + c);
    }
    if (kTrans) {
      const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) s[(c + i) * kLdh + r] = e[i];
    } else {
      *reinterpret_cast<uint4*>(s + r * kLdh + c) = x;
    }
  }
}

// the warp's A fragments of rows rb..rb+15 of a staged tile, over its 64
// columns (4 depth steps of 16)
__device__ __forceinline__ void load_a(const bf16* __restrict__ s, int rb,
                                       uint32_t a[4][4]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(s);
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = w[(rb + g) * kLdw + kk * 8 + t];
    a[kk][1] = w[(rb + g + 8) * kLdw + kk * 8 + t];
    a[kk][2] = w[(rb + g) * kLdw + kk * 8 + 4 + t];
    a[kk][3] = w[(rb + g + 8) * kLdw + kk * 8 + 4 + t];
  }
}

// acc (16 x 64: 8 tiles of 8 columns) += A (16 x 64) * B, where B's 64
// columns are the rows of the staged tile sB (B[k][n] = sB[n][k])
__device__ __forceinline__ void product(float acc[8][4],
                                        const uint32_t a[4][4],
                                        const bf16* __restrict__ sB) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(sB);
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t* row = w + (nt * 8 + g) * kLdw + kk * 8 + t;
      mma(acc[nt], a[kk], row[0], row[4]);
    }
  }
}

// acc += X * B for an fp32 X (16 x 64) held in accumulator layout: each
// depth step's A fragment is X split into bf16 hi + lo halves, both
// multiplied, so X keeps ~16 bits of mantissa
__device__ __forceinline__ void product_split(float acc[8][4],
                                              const float x[8][4],
                                              const bf16* __restrict__ sB) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(sB);
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      // f: 0 = rows g, 1 = rows g + 8 of column tile 2kk; 2, 3 of 2kk + 1
      const float* src = x[2 * kk + (f >> 1)] + 2 * (f & 1);
      const __nv_bfloat162 h = __floats2bfloat162_rn(src[0], src[1]);
      hi[f] = pack(h);
      lo[f] = pack(__floats2bfloat162_rn(src[0] - __low2float(h),
                                         src[1] - __high2float(h)));
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t* row = w + (nt * 8 + g) * kLdw + kk * 8 + t;
      mma(acc[nt], hi, row[0], row[4]);
      mma(acc[nt], lo, row[0], row[4]);
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

// B8: one block per (batch*head, 64-row q tile); warp w owns rows
// 16w..16w+15, a thread rows g and g + 8 of them.
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ out,
           float* __restrict__ lse, int Tq, int Tk, int d, int causal,
           float scale) {
  __shared__ __align__(16) bf16 sK[kBuf];   // [key][d]; first Q
  __shared__ __align__(16) bf16 sVt[kBuf];  // [d][key]
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const bf16* kb = k + bh * Tk * d;
  const bf16* vb = v + bh * Tk * d;
  uint32_t qf[4][4];
  stage<false>(q + bh * Tq * d, q0, Tq, d, sK);
  __syncthreads();
  load_a(sK, warp * 16, qf);

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float o[8][4] = {};
  const int n_kt = key_tiles(q0, Tk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    stage<false>(kb, k0, Tk, d, sK);
    stage<true>(vb, k0, Tk, d, sVt);
    __syncthreads();
    float s[8][4] = {};
    product(s, qf, sK);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = visible(rows[e >> 1], kp, Tq, Tk, causal)
                       ? s[nt][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float m_new[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m[h], quad_max(mx[h]));
      const float alpha = expf(m[h] - m_new[h]);
      l[h] *= alpha;
      m[h] = m_new[h];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        o[nt][2 * h] *= alpha;
        o[nt][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = visible(rows[e >> 1], kp, Tq, Tk, causal)
                       ? expf(s[nt][e] - m_new[e >> 1]) : 0.f;
        l[e >> 1] += s[nt][e];
      }
    }
    product_split(o, s, sVt);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    const float safe_l = l[h] == 0.f ? 1.f : l[h];
    inv[h] = 1.f / safe_l;
    if (t == 0 && rows[h] < Tq) {
      lse[bh * Tq + rows[h]] = l[h] == 0.f ? kNegInf : m[h] + logf(safe_l);
    }
  }
  // out = acc / l as acc * (1 / l): within an ulp of the division, under
  // the bf16 rounding that follows
  store_rows(o, q0 + warp * 16, Tq, d, inv[0], inv[1], out + bh * Tq * d);
}

// B9, dq: one block per (batch*head, 64-row q tile), walking the key tiles
// up to the diagonal: p = exp(s - lse), ds = p * (dp - delta) * scale,
// dq += ds @ k.
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int Tq, int Tk, int d, int causal,
          float scale) {
  __shared__ __align__(16) bf16 sK[kBuf];   // [key][d]; first Q
  __shared__ __align__(16) bf16 sKt[kBuf];  // [d][key]
  __shared__ __align__(16) bf16 sV[kBuf];   // [key][d]; first dO
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const bf16* kb = k + bh * Tk * d;
  const bf16* vb = v + bh * Tk * d;
  uint32_t qf[4][4], dof[4][4];
  stage<false>(q + bh * Tq * d, q0, Tq, d, sK);
  stage<false>(dout + bh * Tq * d, q0, Tq, d, sV);
  __syncthreads();
  load_a(sK, warp * 16, qf);
  load_a(sV, warp * 16, dof);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_r[h] = rows[h] < Tq ? lse[bh * Tq + rows[h]] : 0.f;
    delta_r[h] = rows[h] < Tq ? delta[bh * Tq + rows[h]] : 0.f;
  }
  float acc[8][4] = {};
  const int n_kt = key_tiles(q0, Tk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    stage<false>(kb, k0, Tk, d, sK);
    stage<true>(kb, k0, Tk, d, sKt);
    stage<false>(vb, k0, Tk, d, sV);
    __syncthreads();
    float s[8][4] = {};
    float dp[8][4] = {};
    product(s, qf, sK);
    product(dp, dof, sV);
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
    product_split(acc, s, sKt);
  }
  store_rows(acc, q0 + warp * 16, Tq, d, 1.f, 1.f, dq + bh * Tq * d);
}

// B9, dk/dv: one block per (batch*head, 64-key tile), walking the q tiles
// from the diagonal to the end: dv += p^T @ do, dk += ds^T @ q. Warp w
// owns keys 16w..16w+15; its products are the transposed ones (s^T = k
// q^T, dp^T = v do^T), so p^T and ds^T come out in accumulator layout.
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk,
           int d, int causal, float scale) {
  __shared__ __align__(16) bf16 sQ[kBuf];    // [q row][d]; first K
  __shared__ __align__(16) bf16 sQt[kBuf];   // [d][q row]
  __shared__ __align__(16) bf16 sdO[kBuf];   // [q row][d]; first V
  __shared__ __align__(16) bf16 sdOt[kBuf];  // [d][q row]
  __shared__ float sLse[kTile];
  __shared__ float sDelta[kTile];
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const bf16* qb = q + bh * Tq * d;
  const bf16* dob = dout + bh * Tq * d;
  uint32_t kf[4][4], vf[4][4];
  stage<false>(k + bh * Tk * d, k0, Tk, d, sQ);
  stage<false>(v + bh * Tk * d, k0, Tk, d, sdO);
  __syncthreads();
  load_a(sQ, warp * 16, kf);
  load_a(sdO, warp * 16, vf);
  float dk_acc[8][4] = {};
  float dv_acc[8][4] = {};
  const int n_qt = (Tq + kTile - 1) / kTile;
  // q tiles that end before this key tile starts see none of it
  for (int qt = causal ? static_cast<int>(blockIdx.y) : 0; qt < n_qt;
       ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    stage<false>(qb, q0, Tq, d, sQ);
    stage<true>(qb, q0, Tq, d, sQt);
    stage<false>(dob, q0, Tq, d, sdO);
    stage<true>(dob, q0, Tq, d, sdOt);
    if (threadIdx.x < kTile) {
      const int qp = q0 + threadIdx.x;
      sLse[threadIdx.x] = qp < Tq ? lse[bh * Tq + qp] : 0.f;
      sDelta[threadIdx.x] = qp < Tq ? delta[bh * Tq + qp] : 0.f;
    }
    __syncthreads();
    float st[8][4] = {};   // s^T: [key][q row]
    float dpt[8][4] = {};  // dp^T
    product(st, kf, sQ);
    product(dpt, vf, sdO);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);  // q row in the tile
        const float p = visible(q0 + c, keys[e >> 1], Tq, Tk, causal)
                            ? expf(st[nt][e] * scale - sLse[c]) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - sDelta[c]) * scale;  // ds^T
      }
    }
    product_split(dv_acc, st, sdOt);
    product_split(dk_acc, dpt, sQt);
  }
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
    tc::fwd_kernel<<<grid, tc::kThreads, 0, st>>>(
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
    const cudaError_t err = opt_in(simt::dq_kernel, simt::kDqSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    simt::dq_kernel<<<grid, simt::kThreads, simt::kDqSmem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), Tq, Tk, d, causal, scale);
  } else {
    tc::dq_kernel<<<grid, tc::kThreads, 0, st>>>(
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
    const cudaError_t err = opt_in(simt::dkv_kernel, simt::kDkvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    simt::dkv_kernel<<<grid, simt::kThreads, simt::kDkvSmem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), Tq, Tk, d,
        causal, scale);
  } else {
    tc::dkv_kernel<<<grid, tc::kThreads, 0, st>>>(
        static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
        static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(dout),
        lse, delta, static_cast<tc::bf16*>(dk), static_cast<tc::bf16*>(dv),
        Tq, Tk, d, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
