// Fused LSTM and GRU recurrences for Hopper (sm_90a), each with a
// float32 and a bfloat16 lane on the CUDA cores:
//   LSTM (gates i|f|c~|o, w [D, 4D]):
//     lstm_fwd       (B10) replaces paddle_tpu/kernels/fused_rnn.py:
//                    _lstm_fwd_kernel, launched by _lstm_fwd_call;
//     lstm_bwd +     (B11) the reverse recurrence and the dW reduction
//     lstm_dw        of _lstm_bwd_kernel (_lstm_bwd_call);
//     lstm_proj_fwd  (B14) _lstm_proj_fwd_kernel (_lstm_proj_fwd_call):
//                    B10 with xe_t @ Wx + b computed inside the step;
//     lstm_proj_bwd  (B15) _lstm_proj_bwd_kernel (_lstm_proj_bwd_call):
//     (+ lstm_dw     the recurrence with dxe = dgates_lp @ Wx^T and the
//      over [Wx; W]) fp32 db, then dWx and dW in one reduction;
//   GRU (gates u|r|c~, w [D, 3D]):
//     gru_fwd        (B12) _gru_fwd_kernel (_gru_fwd_call);
//     gru_bwd +      (B13) the reverse recurrence and the dW reduction
//     gru_dw         of _gru_bwd_kernel (_gru_bwd_call).
// Layouts are the JAX ones, time-major and row-major:
//   x, gates [T, B, G]    pre-projected input gates (+ bias) / the saved
//                         post-activation gates; G = 4D (LSTM), 3D (GRU)
//   xe       [T, B, E]    B14/B15: the raw layer input; wx [E, 4D], b [4D]
//   w        [D, G]       recurrent weights
//   lens     [B] fp32     valid lengths: step t of row b is live iff t < lens
//   h0, c0, dh0, dc0 [B, D]
//   hs, cs, dhs, dcs [T, B, D]
//   dx       [T, B, G]    pre-activation gate gradients
// Every tensor of a call shares one dtype (the lane), except lens and
// B15's fp32 db.
//
// The math follows the Pallas bodies operation for operation: the carries
// (h, c; dh, dc) stay fp32; every product rounds its operands to W's
// dtype first and sums in fp32 (bf16 x bf16 is exact in fp32, so the
// bf16 lane differs from the plain version only in the order of the fp32
// sums); a masked step keeps the state (m*new + (1-m)*old). hprev is
// [h0; hs[:-1]] and the LSTM's cprev [c0; cs[:-1]], both read in place in
// the stored dtype (in the bf16 lane the backward's c~ = f*c_prev + i*g
// uses the rounded cell, as the Pallas kernel does).
//
// What bounds them here, and the design (the GRU's; the LSTM kernels
// below follow it, their notes say where they differ). At the seq2seq
// training shape (T 30, B 512, D 512, bf16) one forward does 2*T*B*D*3D
// = 24 GFLOP over 112 MB: the card's bound is the bytes (0.033 ms); at
// the LSTM flagship's (T 100, B 128, D 512, bf16) B10 does 27 GFLOP over
// 134 MB (0.040 ms). But W (1.5 MiB in
// bf16, 3 MiB in fp32) is re-read by every step of the recurrence, and it
// does not fit one SM's 227 KB of shared memory, so the TPU kernel's
// design (W resident in VMEM for all T steps) does not carry over. This
// first version keeps it simple:
//   - gru_fwd / gru_bwd: one block of 256 threads per tile of BB batch
//     rows (BB in 1, 2, 4, 8, picked by the wrapper so the tiles fill the
//     card), walking all T steps inside the block (the Pallas grid's
//     "arbitrary" time axis). Batch rows never interact, so there is no
//     grid-wide barrier. The tile's carry and the per-step vectors live
//     in shared memory; W is read from global memory every step (L2
//     holds it), with 16-byte loads (fp32) / 8-byte loads (bf16) of four
//     neighbouring columns per thread. Every block reads all of W every
//     step, so the L2's read rate, not the SMs' arithmetic, sets a step.
//     Forward, per step: phase A, g_ur = x[:, :2D] + h_lp @ W[:, :2D]
//     (4 columns of 2D per thread), u and r, rh = r*h; phase B, c =
//     tanh(x_c + rh_lp @ W[:, 2D:]) (2 columns per thread), the blend,
//     hs[t] and gates[t].
//     Backward, per step in reverse: phase 0 (elementwise) du_pre, dc_pre;
//     phase 1, drh = dc_lp @ W_c^T, dr_pre; phase 2, dur_lp @ W_ur^T and
//     dh_prev. Both products read W transposed (a copy the wrapper makes
//     once per call) with the forward's pattern, 2 columns per thread.
//     Every product is one routine, cols_dot.
//   - gru_dw: dW cannot be a per-block accumulator here (3 MiB of fp32),
//     so it is a second kernel after the recurrence, a tiled reduction
//     over the T*B rows: dW[:, :2D] = sum hprev_lp^T dur_lp and dW[:, 2D:]
//     = sum rh_lp^T dc_lp, reading hprev, r (from gates) and dx (dur_pre |
//     dc_pre already in W's dtype, the operands the Pallas kernel
//     multiplies). 64 x 64 output tiles, 256 threads of 4 x 4, rows staged
//     16 at a time; the rows are split into `splits` fixed ranges whose
//     fp32 partials a second pass sums in order (as JAX sums its per-tile
//     partials) and casts to W's dtype. No atomics: the sums are the same
//     run to run.
// The LSTM's W is 2 MiB in bf16 (B14/B15 add Wx, 0.5 or 2 MiB), so its
// steps are set by the same L2 reads: 128 blocks x 2.5-4 MiB a step.
// Left for later work: tensor cores (mma.sync / wgmma on the bf16 lane),
// W split across the SMs and kept resident with a per-step grid barrier,
// cp.async prefetch of the next step's x.
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; each C entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kDwTile = 64;   // dW output tile (rows of W x columns)
constexpr int kDwChunk = 16;  // T*B rows staged per step of the reduction
constexpr int kFwdArrays = 4;   // [BB][D] fp32 arrays in the forward's smem
constexpr int kBwdArrays = 10;  // ... and in the backward's

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as .astype
}

// v rounded to T's precision, kept as fp32 (the Pallas `.astype(w.dtype)`
// before a product)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float2 bf2_to_f2(unsigned bits) {
  __nv_bfloat162 h;
  *reinterpret_cast<unsigned*>(&h) = bits;
  return __bfloat1622float2(h);
}

__device__ __forceinline__ unsigned f2_to_bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// four / two neighbouring elements as fp32 (16- / 8-byte aligned for fp32,
// 8- / 4-byte for bf16)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = bf2_to_f2(q.x), b = bf2_to_f2(q.y);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load2(const float* p, float* v) {
  const float2 q = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void load2(const bf16* p, float* v) {
  const float2 a = bf2_to_f2(__ldg(reinterpret_cast<const unsigned*>(p)));
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(f2_to_bf2(v[0], v[1]), f2_to_bf2(v[2], v[3]));
}
__device__ __forceinline__ void store2(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store2(bf16* p, const float* v) {
  *reinterpret_cast<unsigned*>(p) = f2_to_bf2(v[0], v[1]);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// acc[b][c] = sum_{j < n} vec[b * ld_v + j] * m[j * ld_m + c], c < V: V
// neighbouring columns of a row-major matrix (m points at row 0 of this
// thread's first column) against each batch row's vector in shared memory.
// The rows of m are read from global memory four at a time (they stay in
// L2), the vectors as float4 broadcasts; the fp32 sum runs over j in order.
template <typename T, int BB, int V>
__device__ __forceinline__ void cols_dot(const T* __restrict__ m, int ld_m,
                                         const float* vec, int ld_v, int n,
                                         float (&acc)[BB][V]) {
#pragma unroll
  for (int b = 0; b < BB; ++b)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[b][c] = 0.f;
#pragma unroll 2
  for (int j = 0; j < n; j += 4) {
    float wv[4][V];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const T* row = m + static_cast<size_t>(j + jj) * ld_m;
      if constexpr (V == 4) {
        load4(row, wv[jj]);
      } else {
        load2(row, wv[jj]);
      }
    }
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const float4 v = *reinterpret_cast<const float4*>(vec + b * ld_v + j);
      const float vj[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < V; ++c)
          acc[b][c] = fmaf(vj[jj], wv[jj][c], acc[b][c]);
    }
  }
}

// ------------------------------------------------------------ forward (B12)

template <typename T, int BB>
__global__ void __launch_bounds__(kThreads)
    gru_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ lens, const T* __restrict__ h0,
                   T* __restrict__ hs, T* __restrict__ gates, int n_steps,
                   int B, int D) {
  extern __shared__ float smem[];
  float* h = smem;               // [BB][D] the fp32 carry
  float* h_lp = h + BB * D;      // [BB][D] h rounded to W's dtype
  float* u_s = h_lp + BB * D;    // [BB][D] update gate of this step
  float* rh_lp = u_s + BB * D;   // [BB][D] (r * h) rounded to W's dtype
  __shared__ float len_s[BB];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BB;
  const int G = 3 * D;
  for (int i = tid; i < BB * D; i += kThreads) {
    const int b = i / D;
    const float v =
        b0 + b < B ? to_f(h0[static_cast<size_t>(b0 + b) * D + i % D]) : 0.f;
    h[i] = v;
    h_lp[i] = round_to<T>(v);
  }
  if (tid < BB) len_s[tid] = b0 + tid < B ? lens[b0 + tid] : 0.f;
  __syncthreads();

  for (int t = 0; t < n_steps; ++t) {
    const size_t row0 = static_cast<size_t>(t) * B + b0;  // (t, b0)
    // phase A: g_ur = x[:, :2D] + h_lp @ W[:, :2D]; u, r; rh = r * h
    for (int j0 = 4 * tid; j0 < 2 * D; j0 += 4 * kThreads) {
      float acc[BB][4];
      cols_dot<T, BB, 4>(w + j0, G, h_lp, D, D, acc);
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        if (b0 + b >= B) continue;
        float xv[4], s[4];
        load4(x + (row0 + b) * G + j0, xv);
#pragma unroll
        for (int c = 0; c < 4; ++c) s[c] = sigmoid(xv[c] + acc[b][c]);
        store4(gates + (row0 + b) * G + j0, s);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + c;  // a 4-group lies inside u or inside r
          if (j < D) {
            u_s[b * D + j] = s[c];
          } else {
            rh_lp[b * D + j - D] = round_to<T>(s[c] * h[b * D + j - D]);
          }
        }
      }
    }
    __syncthreads();
    // phase B: c = tanh(x_c + rh_lp @ W[:, 2D:]); h_t; the masked blend
    for (int j0 = 2 * tid; j0 < D; j0 += 2 * kThreads) {
      float acc[BB][2];
      cols_dot<T, BB, 2>(w + 2 * D + j0, G, rh_lp, D, D, acc);
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        if (b0 + b >= B) continue;
        const float m = static_cast<float>(t) < len_s[b] ? 1.f : 0.f;
        float xv[2], cv[2], hn[2];
        load2(x + (row0 + b) * G + 2 * D + j0, xv);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = b * D + j0 + c;
          cv[c] = tanhf(xv[c] + acc[b][c]);
          const float hp = h[i], u = u_s[i];
          const float ht = u * hp + (1.f - u) * cv[c];
          hn[c] = m * ht + (1.f - m) * hp;
          h[i] = hn[c];
          h_lp[i] = round_to<T>(hn[c]);
        }
        store2(hs + (row0 + b) * D + j0, hn);
        store2(gates + (row0 + b) * G + 2 * D + j0, cv);
      }
    }
    __syncthreads();
  }
}

// --------------------------------------------- backward recurrence (B13)

// wt is W transposed, [3D, D] (made once per call by the wrapper), so the
// two products of a step read it with the forward's column pattern:
// drh = dc_lp @ W_c^T takes rows 2D.. of wt, dur_lp @ W_ur^T rows ..2D.
template <typename T, int BB>
__global__ void __launch_bounds__(kThreads)
    gru_bwd_kernel(const T* __restrict__ gates, const T* __restrict__ hs,
                   const T* __restrict__ wt, const float* __restrict__ lens,
                   const T* __restrict__ h0, const T* __restrict__ dhs,
                   T* __restrict__ dx, T* __restrict__ dh0, int n_steps,
                   int B, int D) {
  extern __shared__ float smem[];
  const int N = BB * D;
  float* dh = smem;              // [BB][D] the fp32 carry dh
  float* u_s = dh + N;           // [BB][D] u of this step
  float* r_s = u_s + N;          // [BB][D] r
  float* hp_s = r_s + N;         // [BB][D] h_prev
  float* dht_s = hp_s + N;       // [BB][D] dh_t = m * dH
  float* keep_s = dht_s + N;     // [BB][D] (1 - m) * dH
  float* drhr_s = keep_s + N;    // [BB][D] drh * r
  float* dc_lp = drhr_s + N;     // [BB][D] dc_pre rounded to W's dtype
  float* dur_lp = dc_lp + N;     // [BB][2D] du_pre | dr_pre, rounded
  __shared__ float len_s[BB];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BB;
  const int G = 3 * D;
  for (int i = tid; i < N; i += kThreads) dh[i] = 0.f;
  if (tid < BB) len_s[tid] = b0 + tid < B ? lens[b0 + tid] : 0.f;
  __syncthreads();

  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t row0 = static_cast<size_t>(t) * B + b0;
    // phase 0: the elementwise gate gradients
    for (int i = tid; i < N; i += kThreads) {
      const int b = i / D, k = i % D;
      if (b0 + b >= B) {  // a padding row of the tile: contributes nothing
        u_s[i] = r_s[i] = hp_s[i] = dht_s[i] = keep_s[i] = dc_lp[i] = 0.f;
        dur_lp[b * 2 * D + k] = dur_lp[b * 2 * D + D + k] = 0.f;
        continue;
      }
      const size_t n = row0 + b;
      const float u = to_f(gates[n * G + k]);
      const float r = to_f(gates[n * G + D + k]);
      const float c = to_f(gates[n * G + 2 * D + k]);
      const float hp = to_f(t > 0 ? hs[(n - B) * D + k]
                                  : h0[static_cast<size_t>(b0 + b) * D + k]);
      const float m = static_cast<float>(t) < len_s[b] ? 1.f : 0.f;
      const float dH = to_f(dhs[n * D + k]) + dh[i];
      const float dht = m * dH;
      const float du = dht * (hp - c);
      const float du_pre = du * u * (1.f - u);
      const float dc = dht * (1.f - u);
      const float dc_pre = dc * (1.f - c * c);
      u_s[i] = u;
      r_s[i] = r;
      hp_s[i] = hp;
      dht_s[i] = dht;
      keep_s[i] = (1.f - m) * dH;
      dc_lp[i] = round_to<T>(dc_pre);
      dur_lp[b * 2 * D + k] = round_to<T>(du_pre);
      dx[n * G + k] = from_f<T>(du_pre);
      dx[n * G + 2 * D + k] = from_f<T>(dc_pre);
    }
    __syncthreads();
    // phase 1: drh = dc_lp @ W_c^T (2 columns of D per thread); dr_pre
    for (int k0 = 2 * tid; k0 < D; k0 += 2 * kThreads) {
      float acc[BB][2];
      cols_dot<T, BB, 2>(wt + static_cast<size_t>(2 * D) * D + k0, D, dc_lp,
                         D, D, acc);
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        if (b0 + b >= B) continue;
        float dr_pre[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = b * D + k0 + c;
          const float r = r_s[i];
          dr_pre[c] = acc[b][c] * hp_s[i] * r * (1.f - r);
          dur_lp[b * 2 * D + D + k0 + c] = round_to<T>(dr_pre[c]);
          drhr_s[i] = acc[b][c] * r;
        }
        store2(dx + (row0 + b) * G + D + k0, dr_pre);
      }
    }
    __syncthreads();
    // phase 2: dh_prev = dh_t*u + drh*r + dur_lp @ W_ur^T + (1-m)*dH
    for (int k0 = 2 * tid; k0 < D; k0 += 2 * kThreads) {
      float acc[BB][2];
      cols_dot<T, BB, 2>(wt + k0, D, dur_lp, 2 * D, 2 * D, acc);
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        if (b0 + b >= B) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = b * D + k0 + c;
          dh[i] = dht_s[i] * u_s[i] + drhr_s[i] + acc[b][c] + keep_s[i];
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < N; i += kThreads) {
    const int b = i / D;
    if (b0 + b < B) dh0[static_cast<size_t>(b0 + b) * D + i % D] =
        from_f<T>(dh[i]);
  }
}

// ------------------------------------------- dW reductions (B13, B11, B15)

// The tiled reduction every dW shares: acc[i][j] += sum over the rows
// [n_begin, n_end) of the T*B rows of A[n][ka + ty*4 + i] * dx[n][j0 +
// tx*4 + j], one 64 x 64 output tile per block, 256 threads of 4 x 4,
// rows staged kDwChunk at a time. load_a(n, v) fills v with the four A
// values of row n that this thread stages (columns ka + (tid % 16)*4..).
template <typename T, typename LoadA>
__device__ __forceinline__ void dw_tile(LoadA load_a, const T* __restrict__ dx,
                                        int G, int j0, int n_begin,
                                        int n_end, float (&acc)[4][4]) {
  __shared__ __align__(16) float a_s[kDwChunk][kDwTile];  // [row][k]
  __shared__ __align__(16) float b_s[kDwChunk][kDwTile];  // [row][j]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int sr = threadIdx.x / 16, sc = (threadIdx.x % 16) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c0 = n_begin; c0 < n_end; c0 += kDwChunk) {
    const int n = c0 + sr;
    float a[4] = {0.f, 0.f, 0.f, 0.f}, bv[4] = {0.f, 0.f, 0.f, 0.f};
    if (n < n_end) {
      load_a(n, a);
      load4(dx + static_cast<size_t>(n) * G + j0 + sc, bv);
    }
    __syncthreads();  // the previous chunk's products are done
    *reinterpret_cast<float4*>(&a_s[sr][sc]) = make_float4(a[0], a[1], a[2],
                                                           a[3]);
    *reinterpret_cast<float4*>(&b_s[sr][sc]) = make_float4(bv[0], bv[1],
                                                           bv[2], bv[3]);
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kDwChunk; ++rr) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[rr][ty * 4]);
      const float4 bw = *reinterpret_cast<const float4*>(&b_s[rr][tx * 4]);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bw.x, bw.y, bw.z, bw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
  }
}

// this block's tile (output rows k0.., columns j0..) of an [n_out, G]
// result: written in W's dtype when splits == 1, else as fp32 partials
// [splits][n_out][G] (split blockIdx.z)
template <typename T>
__device__ __forceinline__ void dw_store(const float (&acc)[4][4],
                                         float* __restrict__ part,
                                         T* __restrict__ out, int n_out,
                                         int G, int k0, int j0, int splits) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t o = static_cast<size_t>(k0 + ty * 4 + i) * G + j0 + tx * 4;
    if (splits == 1) {
      store4(out + o, acc[i]);
    } else {
      store4(part + static_cast<size_t>(blockIdx.z) * n_out * G + o, acc[i]);
    }
  }
}

// hprev row n of the T*B rows: hs[n - B], or h0[n] for t = 0
template <typename T>
__device__ __forceinline__ const T* hprev_row(const T* hs, const T* h0,
                                             int n, int B, int D) {
  return n >= B ? hs + static_cast<size_t>(n - B) * D
                : h0 + static_cast<size_t>(n) * D;
}

// GRU: one 64 x 64 tile of dW (rows k0.., columns j0..) over the rows
// [n_begin, n_end) of the T*B rows; splits == 1 writes dW, else fp32
// partials [splits][D][3D]
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gru_dw_kernel(const T* __restrict__ gates, const T* __restrict__ hs,
                  const T* __restrict__ h0, const T* __restrict__ dx,
                  float* __restrict__ part, T* __restrict__ dw, int n_steps,
                  int B, int D, int rows_per_split, int splits) {
  const int G = 3 * D;
  const int j0 = blockIdx.x * kDwTile, k0 = blockIdx.y * kDwTile;
  const bool cand = j0 >= 2 * D;  // c~ columns: A = r * hprev, else hprev
  const int n_rows = n_steps * B;
  const int n_begin = blockIdx.z * rows_per_split;
  const int n_end = min(n_rows, n_begin + rows_per_split);
  const int kk = k0 + (threadIdx.x % 16) * 4;
  auto load_a = [&](int n, float* a) {
    load4(hprev_row(hs, h0, n, B, D) + kk, a);
    if (cand) {
      float r[4];
      load4(gates + static_cast<size_t>(n) * G + D + kk, r);
#pragma unroll
      for (int c = 0; c < 4; ++c) a[c] = round_to<T>(r[c] * a[c]);
    }
  };
  float acc[4][4];
  dw_tile<T>(load_a, dx, G, j0, n_begin, n_end, acc);
  dw_store<T>(acc, part, dw, D, G, k0, j0, splits);
}

// LSTM: one 64 x 64 tile of [dWx; dW] ([E + D, 4D]: rows < E are dWx =
// sum xe^T dx, the rest dW = sum hprev^T dx; E = 0 for B11) over the rows
// [n_begin, n_end) of the T*B rows. dx holds dgates already rounded to
// W's dtype, the operand the Pallas kernel multiplies.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_dw_kernel(const T* __restrict__ xe, const T* __restrict__ hs,
                   const T* __restrict__ h0, const T* __restrict__ dx,
                   float* __restrict__ part, T* __restrict__ dw, int n_steps,
                   int B, int D, int E, int rows_per_split, int splits) {
  const int G = 4 * D;
  const int j0 = blockIdx.x * kDwTile, k0 = blockIdx.y * kDwTile;
  const int n_rows = n_steps * B;
  const int n_begin = blockIdx.z * rows_per_split;
  const int n_end = min(n_rows, n_begin + rows_per_split);
  const int kk = k0 + (threadIdx.x % 16) * 4;
  auto load_a = [&](int n, float* a) {
    if (k0 < E) {
      load4(xe + static_cast<size_t>(n) * E + kk, a);
    } else {
      load4(hprev_row(hs, h0, n, B, D) + kk - E, a);
    }
  };
  float acc[4][4];
  dw_tile<T>(load_a, dx, G, j0, n_begin, n_end, acc);
  dw_store<T>(acc, part, dw, E + D, G, k0, j0, splits);
}

// out = the fp32 partials [splits][n] summed in split order, cast to T
template <typename T>
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                  T* __restrict__ dw, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += part[static_cast<size_t>(p) * n + i];
  dw[i] = from_f<T>(s);
}

// ---------------------------------------------- LSTM forward (B10, B14)

// One block of 256 threads per tile of BB batch rows walks all T steps.
// Thread tid owns the hidden units k0 = 2*tid (+ 2*256 ...) and k0 + 1 of
// every row of the tile: it computes their four gate columns q*D + k
// (q = i, f, c~, o), so the whole cell update of a unit is in one thread
// and a step needs one barrier. The fp32 carries h and c are read and
// written only by their owner; h rounded to W's dtype (the operand of the
// next step's product) is double-buffered, as is (B14) the step's xe
// rows, which the block stages one step ahead.
//   B10: gates = x_t + h_lp @ W
//   B14: gates = (xe_t @ Wx + b) + h_lp @ W   (the Pallas sum order)
template <typename T, int BB, bool PROJ>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wx,
                    const T* __restrict__ bias, const T* __restrict__ w,
                    const float* __restrict__ lens, const T* __restrict__ h0,
                    const T* __restrict__ c0, T* __restrict__ hs,
                    T* __restrict__ cs, T* __restrict__ gates, int n_steps,
                    int B, int D, int E) {
  extern __shared__ float smem[];
  const int N = BB * D;
  float* h = smem;               // [BB][D] the fp32 carry h
  float* c = h + N;              // [BB][D] the fp32 carry c
  float* h_lp = c + N;           // [2][BB][D] h rounded to W's dtype
  float* xe_s = h_lp + 2 * N;    // B14: [2][BB][E] the step's xe rows
  __shared__ float len_s[BB];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BB;
  const int G = 4 * D;
  for (int i = tid; i < N; i += kThreads) {
    const int b = i / D;
    const size_t o = static_cast<size_t>(b0 + b) * D + i % D;
    const float hv = b0 + b < B ? to_f(h0[o]) : 0.f;
    h[i] = hv;
    c[i] = b0 + b < B ? to_f(c0[o]) : 0.f;
    h_lp[i] = round_to<T>(hv);
    h_lp[N + i] = 0.f;
  }
  if constexpr (PROJ) {
    for (int i = tid; i < 2 * BB * E; i += kThreads) {
      const int b = (i / E) % BB;
      xe_s[i] = i < BB * E && b0 + b < B && n_steps > 0
                    ? to_f(x[static_cast<size_t>(b0 + b) * E + i % E])
                    : 0.f;
    }
  }
  if (tid < BB) len_s[tid] = b0 + tid < B ? lens[b0 + tid] : 0.f;
  __syncthreads();

  for (int t = 0; t < n_steps; ++t) {
    const int cur = t & 1;
    const float* hl = h_lp + cur * N;
    float* hl_next = h_lp + (cur ^ 1) * N;
    const size_t row0 = static_cast<size_t>(t) * B + b0;  // (t, b0)
    if constexpr (PROJ) {
      if (t + 1 < n_steps) {  // stage xe[t + 1] in the other buffer
        float* nxt = xe_s + (cur ^ 1) * BB * E;
        for (int i = tid; i < BB * E; i += kThreads) {
          const int b = i / E;
          if (b0 + b < B) nxt[i] = to_f(x[(row0 + B + b) * E + i % E]);
        }
      }
    }
    for (int k0 = 2 * tid; k0 < D; k0 += 2 * kThreads) {
      float pre[4][BB][2];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        cols_dot<T, BB, 2>(w + q * D + k0, G, hl, D, D, pre[q]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (PROJ) {
          float ax[BB][2], bq[2];
          cols_dot<T, BB, 2>(wx + q * D + k0, G, xe_s + cur * BB * E, E, E,
                             ax);
          load2(bias + q * D + k0, bq);
#pragma unroll
          for (int b = 0; b < BB; ++b)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc)
              pre[q][b][cc] = (ax[b][cc] + bq[cc]) + pre[q][b][cc];
        } else {
#pragma unroll
          for (int b = 0; b < BB; ++b) {
            if (b0 + b >= B) continue;
            float xv[2];
            load2(x + (row0 + b) * G + q * D + k0, xv);
#pragma unroll
            for (int cc = 0; cc < 2; ++cc)
              pre[q][b][cc] = xv[cc] + pre[q][b][cc];
          }
        }
      }
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        if (b0 + b >= B) continue;
        const float m = static_cast<float>(t) < len_s[b] ? 1.f : 0.f;
        float gv[4][2], hn[2], cn[2];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int i = b * D + k0 + cc;
          const float ig = sigmoid(pre[0][b][cc]);
          const float fg = sigmoid(pre[1][b][cc]);
          const float gg = tanhf(pre[2][b][cc]);
          const float og = sigmoid(pre[3][b][cc]);
          const float hp = h[i], cp = c[i];
          const float ct = fg * cp + ig * gg;
          const float ht = og * tanhf(ct);
          hn[cc] = m * ht + (1.f - m) * hp;
          cn[cc] = m * ct + (1.f - m) * cp;
          h[i] = hn[cc];
          c[i] = cn[cc];
          hl_next[i] = round_to<T>(hn[cc]);
          gv[0][cc] = ig;
          gv[1][cc] = fg;
          gv[2][cc] = gg;
          gv[3][cc] = og;
        }
        store2(hs + (row0 + b) * D + k0, hn);
        store2(cs + (row0 + b) * D + k0, cn);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          store2(gates + (row0 + b) * G + q * D + k0, gv[q]);
      }
    }
    __syncthreads();
  }
}

// --------------------------------------------- LSTM backward (B11, B15)

// The reverse recurrence, one block per tile of BB rows, reverse time.
// Phase 0 (elementwise): thread tid owns units k = tid (+ 256 ...) of
// every row: it recomputes c~ = f*c_prev + i*g from the saved gates and
// c_prev = [c0; cs[:-1]] as stored (in cs's dtype: the bf16 lane's c_prev
// is the rounded one, as in the Pallas kernel), forms the four
// pre-activation gate gradients, writes them (dx) and keeps them rounded
// to W's dtype in shared memory, updates dc and sets dh = (1-m)*dH; B15
// also sums the unrounded fp32 dgates of its units into db (the Pallas
// db sums fp32 dgates; dWx and dW sum the rounded ones).
// Phase 1: dh += dgates_lp @ W^T (D columns), and B15's dxe_t =
// dgates_lp @ Wx^T (E columns), both from transposed copies the wrapper
// makes once per call, 2 columns per thread.
template <typename T, int BB, bool PROJ>
__global__ void __launch_bounds__(kThreads)
    lstm_bwd_kernel(const T* __restrict__ gates, const T* __restrict__ cs,
                    const T* __restrict__ wt, const T* __restrict__ wxt,
                    const float* __restrict__ lens, const T* __restrict__ c0,
                    const T* __restrict__ dhs, const T* __restrict__ dcs,
                    T* __restrict__ dx, T* __restrict__ dxe,
                    float* __restrict__ db_part, T* __restrict__ dh0,
                    T* __restrict__ dc0, int n_steps, int B, int D, int E) {
  extern __shared__ float smem[];
  const int N = BB * D;
  const int G = 4 * D;
  float* dh = smem;              // [BB][D] the fp32 carry dh
  float* dc = dh + N;            // [BB][D] the fp32 carry dc
  float* dg = dc + N;            // [BB][4D] dgates rounded to W's dtype
  float* db_s = dg + BB * G;     // B15: [4D] this tile's fp32 sum of dgates
  __shared__ float len_s[BB];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BB;
  for (int i = tid; i < N; i += kThreads) dh[i] = dc[i] = 0.f;
  for (int i = tid; i < BB * G; i += kThreads) dg[i] = 0.f;
  if constexpr (PROJ) {
    for (int i = tid; i < G; i += kThreads) db_s[i] = 0.f;
  }
  if (tid < BB) len_s[tid] = b0 + tid < B ? lens[b0 + tid] : 0.f;
  __syncthreads();

  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t row0 = static_cast<size_t>(t) * B + b0;
    // phase 0
    for (int k = tid; k < D; k += kThreads) {
      float dbk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        if (b0 + b >= B) continue;  // a padding row: dg stays 0
        const size_t n = row0 + b;
        const int i = b * D + k;
        const float ig = to_f(gates[n * G + k]);
        const float fg = to_f(gates[n * G + D + k]);
        const float gg = to_f(gates[n * G + 2 * D + k]);
        const float og = to_f(gates[n * G + 3 * D + k]);
        const float cp = to_f(t > 0 ? cs[(n - B) * D + k]
                                    : c0[static_cast<size_t>(b0 + b) * D + k]);
        const float ct = fg * cp + ig * gg;  // the pre-mask cell
        const float tc = tanhf(ct);
        const float m = static_cast<float>(t) < len_s[b] ? 1.f : 0.f;
        const float dH = to_f(dhs[n * D + k]) + dh[i];
        const float dC = to_f(dcs[n * D + k]) + dc[i];
        const float dht = m * dH;
        const float dct = m * dC + dht * og * (1.f - tc * tc);
        const float d[4] = {dct * gg * ig * (1.f - ig),
                            dct * cp * fg * (1.f - fg),
                            dct * ig * (1.f - gg * gg),
                            dht * tc * og * (1.f - og)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dx[n * G + q * D + k] = from_f<T>(d[q]);
          dg[b * G + q * D + k] = round_to<T>(d[q]);
          dbk[q] += d[q];
        }
        dc[i] = (1.f - m) * dC + dct * fg;
        dh[i] = (1.f - m) * dH;
      }
      if constexpr (PROJ) {
#pragma unroll
        for (int q = 0; q < 4; ++q) db_s[q * D + k] += dbk[q];
      }
    }
    __syncthreads();
    // phase 1: dh += dg @ W^T (wt [4D, D]); B15: dxe = dg @ Wx^T (wxt
    // [4D, E])
    const int n_cols = D + (PROJ ? E : 0);
    for (int k0 = 2 * tid; k0 < n_cols; k0 += 2 * kThreads) {
      float acc[BB][2];
      if (k0 < D) {
        cols_dot<T, BB, 2>(wt + k0, D, dg, G, G, acc);
#pragma unroll
        for (int b = 0; b < BB; ++b) {
          if (b0 + b >= B) continue;
          dh[b * D + k0] += acc[b][0];
          dh[b * D + k0 + 1] += acc[b][1];
        }
      } else {
        const int ke = k0 - D;
        cols_dot<T, BB, 2>(wxt + ke, E, dg, G, G, acc);
#pragma unroll
        for (int b = 0; b < BB; ++b) {
          if (b0 + b >= B) continue;
          store2(dxe + (row0 + b) * E + ke, acc[b]);
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < N; i += kThreads) {
    const int b = i / D;
    if (b0 + b >= B) continue;
    const size_t o = static_cast<size_t>(b0 + b) * D + i % D;
    dh0[o] = from_f<T>(dh[i]);
    dc0[o] = from_f<T>(dc[i]);
  }
  if constexpr (PROJ) {
    for (int i = tid; i < G; i += kThreads)
      db_part[static_cast<size_t>(blockIdx.x) * G + i] = db_s[i];
  }
}

// ------------------------------------------------------------- launchers

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// lane 0: float32, 1: bfloat16; D a multiple of 64; BB in {1, 2, 4, 8}
bool bad_sizes(int lane, int n_steps, int B, int D, int bb) {
  return lane < 0 || lane > 1 || n_steps < 0 || B < 1 || D < 64 ||
         D % 64 != 0 || !(bb == 1 || bb == 2 || bb == 4 || bb == 8);
}

template <typename T, int BB>
cudaError_t launch_fwd(const void* x, const void* w, const float* lens,
                       const void* h0, void* hs, void* gates, int n_steps,
                       int B, int D, cudaStream_t st) {
  const int smem = kFwdArrays * BB * D * static_cast<int>(sizeof(float));
  const cudaError_t err = opt_in(gru_fwd_kernel<T, BB>, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((B + BB - 1) / BB);
  gru_fwd_kernel<T, BB><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), lens,
      static_cast<const T*>(h0), static_cast<T*>(hs), static_cast<T*>(gates),
      n_steps, B, D);
  return cudaGetLastError();
}

template <typename T, int BB>
cudaError_t launch_bwd(const void* gates, const void* hs, const void* wt,
                       const float* lens, const void* h0, const void* dhs,
                       void* dx, void* dh0, int n_steps, int B, int D,
                       cudaStream_t st) {
  const int smem = kBwdArrays * BB * D * static_cast<int>(sizeof(float));
  const cudaError_t err = opt_in(gru_bwd_kernel<T, BB>, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((B + BB - 1) / BB);
  gru_bwd_kernel<T, BB><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(gates), static_cast<const T*>(hs),
      static_cast<const T*>(wt), lens, static_cast<const T*>(h0),
      static_cast<const T*>(dhs), static_cast<T*>(dx), static_cast<T*>(dh0),
      n_steps, B, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* gates, const void* hs, const void* h0,
                      const void* dx, float* part, void* dw, int n_steps,
                      int B, int D, int splits, cudaStream_t st) {
  const int n_rows = n_steps * B;
  const int per = (n_rows + splits - 1) / splits;
  const dim3 grid(static_cast<unsigned>(3 * D / kDwTile),
                  static_cast<unsigned>(D / kDwTile),
                  static_cast<unsigned>(splits));
  gru_dw_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(gates), static_cast<const T*>(hs),
      static_cast<const T*>(h0), static_cast<const T*>(dx), part,
      static_cast<T*>(dw), n_steps, B, D, per, splits);
  if (splits > 1) {
    const int n = D * 3 * D;
    sum_partials_kernel<T><<<(n + 255) / 256, 256, 0, st>>>(
        part, static_cast<T*>(dw), n, splits);
  }
  return cudaGetLastError();
}

// shared memory of the LSTM recurrence kernels (the wrapper's
// _lstm_smem_bytes computes the same)
int lstm_fwd_smem(int bb, int D, int E) {
  return (4 * bb * D + 2 * bb * E) * static_cast<int>(sizeof(float));
}
int lstm_bwd_smem(int bb, int D, bool proj) {
  return (6 * bb * D + (proj ? 4 * D : 0)) * static_cast<int>(sizeof(float));
}

template <typename T, int BB, bool PROJ>
cudaError_t launch_lstm_fwd(const void* x, const void* wx, const void* bias,
                            const void* w, const float* lens, const void* h0,
                            const void* c0, void* hs, void* cs, void* gates,
                            int n_steps, int B, int D, int E,
                            cudaStream_t st) {
  const int smem = lstm_fwd_smem(BB, D, PROJ ? E : 0);
  const cudaError_t err = opt_in(lstm_fwd_kernel<T, BB, PROJ>, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((B + BB - 1) / BB);
  lstm_fwd_kernel<T, BB, PROJ><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wx),
      static_cast<const T*>(bias), static_cast<const T*>(w), lens,
      static_cast<const T*>(h0), static_cast<const T*>(c0),
      static_cast<T*>(hs), static_cast<T*>(cs), static_cast<T*>(gates),
      n_steps, B, D, E);
  return cudaGetLastError();
}

template <typename T, int BB, bool PROJ>
cudaError_t launch_lstm_bwd(const void* gates, const void* cs, const void* wt,
                            const void* wxt, const float* lens, const void* c0,
                            const void* dhs, const void* dcs, void* dx,
                            void* dxe, float* db_part, float* db, void* dh0,
                            void* dc0, int n_steps, int B, int D, int E,
                            cudaStream_t st) {
  const int smem = lstm_bwd_smem(BB, D, PROJ);
  const cudaError_t err = opt_in(lstm_bwd_kernel<T, BB, PROJ>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + BB - 1) / BB;
  lstm_bwd_kernel<T, BB, PROJ><<<static_cast<unsigned>(grid), kThreads,
                                 smem, st>>>(
      static_cast<const T*>(gates), static_cast<const T*>(cs),
      static_cast<const T*>(wt), static_cast<const T*>(wxt), lens,
      static_cast<const T*>(c0), static_cast<const T*>(dhs),
      static_cast<const T*>(dcs), static_cast<T*>(dx), static_cast<T*>(dxe),
      db_part, static_cast<T*>(dh0), static_cast<T*>(dc0), n_steps, B, D,
      E);
  if constexpr (PROJ) {  // db: the tiles' fp32 partials summed in order
    const int n = 4 * D;
    sum_partials_kernel<float><<<(n + 255) / 256, 256, 0, st>>>(
        db_part, db, n, grid);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_lstm_dw(const void* xe, const void* hs, const void* h0,
                           const void* dx, float* part, void* dw, int n_steps,
                           int B, int D, int E, int splits, cudaStream_t st) {
  const int n_rows = n_steps * B;
  const int per = (n_rows + splits - 1) / splits;
  const dim3 grid(static_cast<unsigned>(4 * D / kDwTile),
                  static_cast<unsigned>((E + D) / kDwTile),
                  static_cast<unsigned>(splits));
  lstm_dw_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(xe), static_cast<const T*>(hs),
      static_cast<const T*>(h0), static_cast<const T*>(dx), part,
      static_cast<T*>(dw), n_steps, B, D, E, per, splits);
  if (splits > 1) {
    const int n = (E + D) * 4 * D;
    sum_partials_kernel<T><<<(n + 255) / 256, 256, 0, st>>>(
        part, static_cast<T*>(dw), n, splits);
  }
  return cudaGetLastError();
}

// E (the B14/B15 input width): a multiple of 64 (the dWx tiles)
bool bad_e(int E) { return E < 64 || E % 64 != 0; }

}  // namespace

// x [T, B, 3D], w [D, 3D], lens [B] fp32, h0 [B, D] -> hs [T, B, D],
// gates [T, B, 3D]; one block per bb rows.
extern "C" int gru_fwd(int lane, const void* x, const void* w,
                       const float* lens, const void* h0, void* hs,
                       void* gates, int n_steps, int B, int D, int bb,
                       void* stream) {
  if (bad_sizes(lane, n_steps, B, D, bb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GRU_FWD(T, BB) \
  launch_fwd<T, BB>(x, w, lens, h0, hs, gates, n_steps, B, D, st)
  cudaError_t err;
  if (lane == 0) {
    err = bb == 1 ? GRU_FWD(float, 1) : bb == 2 ? GRU_FWD(float, 2)
        : bb == 4 ? GRU_FWD(float, 4) : GRU_FWD(float, 8);
  } else {
    err = bb == 1 ? GRU_FWD(bf16, 1) : bb == 2 ? GRU_FWD(bf16, 2)
        : bb == 4 ? GRU_FWD(bf16, 4) : GRU_FWD(bf16, 8);
  }
#undef GRU_FWD
  return static_cast<int>(err);
}

// gates [T, B, 3D], hs [T, B, D], wt = W^T [3D, D], lens, h0, dhs
// [T, B, D] -> dx [T, B, 3D], dh0 [B, D]; one block per bb rows, reverse
// time.
extern "C" int gru_bwd(int lane, const void* gates, const void* hs,
                       const void* wt, const float* lens, const void* h0,
                       const void* dhs, void* dx, void* dh0, int n_steps,
                       int B, int D, int bb, void* stream) {
  if (bad_sizes(lane, n_steps, B, D, bb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GRU_BWD(T, BB)                                                    \
  launch_bwd<T, BB>(gates, hs, wt, lens, h0, dhs, dx, dh0, n_steps, B, D, \
                    st)
  cudaError_t err;
  if (lane == 0) {
    err = bb == 1 ? GRU_BWD(float, 1) : bb == 2 ? GRU_BWD(float, 2)
        : bb == 4 ? GRU_BWD(float, 4) : GRU_BWD(float, 8);
  } else {
    err = bb == 1 ? GRU_BWD(bf16, 1) : bb == 2 ? GRU_BWD(bf16, 2)
        : bb == 4 ? GRU_BWD(bf16, 4) : GRU_BWD(bf16, 8);
  }
#undef GRU_BWD
  return static_cast<int>(err);
}

// gates, hs, h0, dx (as above) -> dw [D, 3D]; `part` holds splits * D * 3D
// fp32 partials when splits > 1 (unused, may be null, when 1).
extern "C" int gru_dw(int lane, const void* gates, const void* hs,
                      const void* h0, const void* dx, float* part, void* dw,
                      int n_steps, int B, int D, int splits, void* stream) {
  if (bad_sizes(lane, n_steps, B, D, 1) || splits < 1 || splits > 65535 ||
      (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      lane == 0 ? launch_dw<float>(gates, hs, h0, dx, part, dw, n_steps, B,
                                   D, splits, st)
                : launch_dw<bf16>(gates, hs, h0, dx, part, dw, n_steps, B,
                                  D, splits, st);
  return static_cast<int>(err);
}

// ----------------------------------------------------------- LSTM entries

#define LSTM_BB_DISPATCH(CALL)                                        \
  (lane == 0 ? (bb == 1 ? CALL(float, 1) : bb == 2 ? CALL(float, 2)   \
                : bb == 4 ? CALL(float, 4) : CALL(float, 8))          \
             : (bb == 1 ? CALL(bf16, 1) : bb == 2 ? CALL(bf16, 2)     \
                : bb == 4 ? CALL(bf16, 4) : CALL(bf16, 8)))

// B10. x [T, B, 4D] (bias added), w [D, 4D], lens [B] fp32, h0, c0 [B, D]
// -> hs, cs [T, B, D], gates [T, B, 4D] (post-activation i|f|c~|o); one
// block per bb rows.
extern "C" int lstm_fwd(int lane, const void* x, const void* w,
                        const float* lens, const void* h0, const void* c0,
                        void* hs, void* cs, void* gates, int n_steps, int B,
                        int D, int bb, void* stream) {
  if (bad_sizes(lane, n_steps, B, D, bb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, BB)                                                        \
  launch_lstm_fwd<T, BB, false>(x, nullptr, nullptr, w, lens, h0, c0, hs, \
                                cs, gates, n_steps, B, D, 0, st)
  const cudaError_t err = LSTM_BB_DISPATCH(CALL);
#undef CALL
  return static_cast<int>(err);
}

// B14. xe [T, B, E], wx [E, 4D], b [4D], w [D, 4D], lens, h0, c0 -> hs,
// cs, gates as B10.
extern "C" int lstm_proj_fwd(int lane, const void* xe, const void* wx,
                             const void* b, const void* w, const float* lens,
                             const void* h0, const void* c0, void* hs,
                             void* cs, void* gates, int n_steps, int B, int D,
                             int E, int bb, void* stream) {
  if (bad_sizes(lane, n_steps, B, D, bb) || bad_e(E)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, BB)                                                         \
  launch_lstm_fwd<T, BB, true>(xe, wx, b, w, lens, h0, c0, hs, cs, gates, \
                               n_steps, B, D, E, st)
  const cudaError_t err = LSTM_BB_DISPATCH(CALL);
#undef CALL
  return static_cast<int>(err);
}

// B11's recurrence. gates [T, B, 4D], cs [T, B, D], wt = W^T [4D, D],
// lens, c0, dhs, dcs [T, B, D] -> dx [T, B, 4D] (dgates), dh0, dc0 [B, D].
extern "C" int lstm_bwd(int lane, const void* gates, const void* cs,
                        const void* wt, const float* lens, const void* c0,
                        const void* dhs, const void* dcs, void* dx, void* dh0,
                        void* dc0, int n_steps, int B, int D, int bb,
                        void* stream) {
  if (bad_sizes(lane, n_steps, B, D, bb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, BB)                                                        \
  launch_lstm_bwd<T, BB, false>(gates, cs, wt, nullptr, lens, c0, dhs,    \
                                dcs, dx, nullptr, nullptr, nullptr, dh0,  \
                                dc0, n_steps, B, D, 0, st)
  const cudaError_t err = LSTM_BB_DISPATCH(CALL);
#undef CALL
  return static_cast<int>(err);
}

// B15's recurrence. As lstm_bwd, plus wxt = Wx^T [4D, E] -> dxe [T, B, E],
// and db [4D] fp32 (the sum of the unrounded dgates) through db_part
// [ceil(B / bb)][4D] fp32 scratch.
extern "C" int lstm_proj_bwd(int lane, const void* gates, const void* cs,
                             const void* wt, const void* wxt,
                             const float* lens, const void* c0,
                             const void* dhs, const void* dcs, void* dx,
                             void* dxe, float* db_part, float* db, void* dh0,
                             void* dc0, int n_steps, int B, int D, int E,
                             int bb, void* stream) {
  if (bad_sizes(lane, n_steps, B, D, bb) || bad_e(E)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, BB)                                                          \
  launch_lstm_bwd<T, BB, true>(gates, cs, wt, wxt, lens, c0, dhs, dcs, dx, \
                               dxe, db_part, db, dh0, dc0, n_steps, B, D,  \
                               E, st)
  const cudaError_t err = LSTM_BB_DISPATCH(CALL);
#undef CALL
  return static_cast<int>(err);
}

// The dW reductions of B11 (E = 0, xe null) and B15: xe [T, B, E], hs,
// h0, dx (the dgates in W's dtype) -> dw = [dWx; dW] [E + D, 4D]; `part`
// holds splits * (E + D) * 4D fp32 partials when splits > 1 (unused, may
// be null, when 1).
extern "C" int lstm_dw(int lane, const void* xe, const void* hs,
                       const void* h0, const void* dx, float* part, void* dw,
                       int n_steps, int B, int D, int E, int splits,
                       void* stream) {
  if (bad_sizes(lane, n_steps, B, D, 1) || (E != 0 && bad_e(E)) ||
      (E != 0 && xe == nullptr) || splits < 1 || splits > 65535 ||
      (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      lane == 0 ? launch_lstm_dw<float>(xe, hs, h0, dx, part, dw, n_steps, B,
                                        D, E, splits, st)
                : launch_lstm_dw<bf16>(xe, hs, h0, dx, part, dw, n_steps, B,
                                       D, E, splits, st);
  return static_cast<int>(err);
}
